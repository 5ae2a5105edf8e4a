"""Matmul Möller-Trumbore vs direct brute force: hit-for-hit
agreement (the coefficient fit is exact up to float rounding)."""

import numpy as np
import jax.numpy as jnp

from pathtrace_tpu.models import procedural
from pathtrace_tpu.ops.intersect import raycast_brute
from pathtrace_tpu.ops.mt_matmul import raycast_matmul


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-25.0, 45.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def test_matmul_matches_brute():
    scene = procedural.cornell_box_scene(include_spheres=True).with_mt()
    org, d = _random_rays(1024, 0)
    a = raycast_brute(scene, org, d)
    b = raycast_matmul(scene, org, d)
    agree = np.asarray(a.hit) == np.asarray(b.hit)
    # borderline rays (grazing edges) may flip under reassociated float
    # arithmetic; require near-total agreement and exact match elsewhere
    assert agree.mean() > 0.995, agree.mean()
    both = np.asarray(a.hit) & np.asarray(b.hit) & agree
    np.testing.assert_allclose(np.asarray(a.t)[both], np.asarray(b.t)[both],
                               rtol=1e-3, atol=1e-3)
    same_prim = (np.asarray(a.prim_id)[both] == np.asarray(b.prim_id)[both])
    assert same_prim.mean() > 0.995


def test_matmul_render_matches_brute_render():
    from pathtrace_tpu import render
    from pathtrace_tpu.utils import rng as prng

    scene = procedural.cornell_box_scene()
    scene_mt = scene.with_mt()
    cam = procedural.default_camera(16, 16)
    a = np.asarray(render(scene, cam, 2, prng.make_key(0)))
    b = np.asarray(render(scene_mt, cam, 2, prng.make_key(0)))
    # images agree except possibly isolated boundary pixels
    close = np.isclose(a, b, rtol=1e-3, atol=1e-3)
    assert close.mean() > 0.99


def test_matmul_dense_mesh():
    scene = procedural.sphere_mesh_scene(subdivisions=3).with_mt()
    org, d = _random_rays(512, 1)
    a = raycast_brute(scene, org, d)
    b = raycast_matmul(scene, org, d)
    agree = np.asarray(a.hit) == np.asarray(b.hit)
    assert agree.mean() > 0.99, agree.mean()
