"""KD spatial cells (accel/kdgrid.py) vs the brute-force oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from pathtrace_tpu.accel import binned
from pathtrace_tpu.models import procedural
from pathtrace_tpu.ops.intersect import raycast_brute


def _rays(n, seed, lo=-25.0, hi=45.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


@pytest.fixture(scope="module")
def scene():
    return procedural.sphere_mesh_scene(subdivisions=4).with_kd_binned(
        max_tris=128).to_device()


def test_kd_cells_partition_space(scene):
    cl = scene.clusters
    bmin = np.asarray(cl.bmin)
    bmax = np.asarray(cl.bmax)
    m = cl.num_clusters
    # non-overlapping: pairwise interior intersection is empty (sampled)
    g = np.random.default_rng(0)
    pts = g.uniform(bmin.min(0), bmax.max(0), (2048, 3)).astype(np.float32)
    inside = ((pts[:, None, :] > bmin[None]) &
              (pts[:, None, :] < bmax[None])).all(-1)
    counts = inside.sum(1)
    # cells never overlap (shrunk boxes may leave gaps, so <= 1, not == 1)
    assert (counts <= 1).all()
    # membership covers every triangle at least once
    dup = np.asarray(cl.dup_map)
    assert set(dup.tolist()) == set(range(scene.num_tris))


def test_kd_matches_brute(scene):
    org, d = _rays(512, 0)
    a = raycast_brute(scene, org, d)
    r = org.shape[0]
    hit, t, gid, overflow = binned.search_pairs_v3(
        scene, org, d, jnp.zeros((r,), jnp.float32),
        jnp.full((r,), 999999.0, jnp.float32))
    assert np.asarray(overflow).mean() == 0.0
    agree = np.asarray(a.hit) == np.asarray(hit)
    assert agree.mean() > 0.995, agree.mean()
    both = np.asarray(a.hit) & np.asarray(hit) & agree
    # t here is the reduce key's quantized t (~1e-3 relative)
    np.testing.assert_allclose(np.asarray(a.t)[both], np.asarray(t)[both],
                               rtol=2e-3, atol=1e-3)
    same = np.asarray(a.prim_id)[both] == np.asarray(gid)[both]
    assert same.mean() > 0.995
    h = binned.raycast_binned_v3(scene, org, d)
    np.testing.assert_allclose(np.asarray(a.t)[both], np.asarray(h.t)[both],
                               rtol=1e-4, atol=1e-3)


def test_kd_hitrecord_and_surface_rays(scene):
    """Rays STARTING on the surface (the bounce/shadow regime that blew
    up the BVH-subtree clusters' membership) stay exact and low-fanout."""
    g = np.random.default_rng(3)
    v0 = np.asarray(scene.tris.v0)
    idx = g.integers(0, v0.shape[0], 256)
    org = jnp.asarray(v0[idx] + g.normal(scale=1e-3, size=(256, 3)))
    d = g.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)

    from pathtrace_tpu.accel.kdgrid import crossing_stats
    stats = crossing_stats(scene.clusters, np.asarray(org), np.asarray(d))
    assert stats["max"] <= 20, stats

    a = raycast_brute(scene, org, d)
    h = binned.raycast_binned_v3(scene, org, d)
    agree = np.asarray(a.hit) == np.asarray(h.hit)
    assert agree.mean() > 0.99, agree.mean()
