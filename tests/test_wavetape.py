"""Wavefront-taped record/replay gradients (diff/wavetape) vs the
per-sample replay reference and across device meshes.

The wavetape path must realize the IDENTICAL estimator: records keyed by
(ray_id, path-local iter) are scheduler-independent, so its image and
material gradients match diff/replay's to float-sum reassociation, and
the sharded step is N-chip == 1-chip path-for-path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtrace_tpu.diff.replay import material_grads_replay
from pathtrace_tpu.diff.wavetape import (material_grads_wavetape,
                                         record_paths_wavefront)
from pathtrace_tpu.integrator.config import IntegratorConfig
from pathtrace_tpu.models import procedural
from pathtrace_tpu.parallel.mesh import (make_ray_mesh,
                                         train_step_wavetape_sharded)
from pathtrace_tpu.utils import rng

FIELDS = ("emittance", "albedo", "specular", "opacity", "roughness",
          "metallic")


@pytest.fixture(scope="module")
def setup():
    scene = procedural.cornell_box_scene(include_spheres=True).with_mt()
    cam = procedural.default_camera(16, 16)
    return scene, cam


def test_wavetape_matches_replay(setup):
    scene, cam = setup
    cfg = IntegratorConfig()
    key = rng.make_key(3)
    g1t, g1s, i1 = material_grads_replay(scene, cam, 4, key, cfg)
    g2t, g2s, i2 = material_grads_wavetape(scene, cam, 4, key, cfg,
                                           lanes=256, chunk=256)
    np.testing.assert_allclose(np.asarray(i1), np.asarray(i2),
                               rtol=1e-3, atol=1e-3)
    for f in FIELDS:
        a, b = np.asarray(getattr(g1t, f)), np.asarray(getattr(g2t, f))
        scale = max(np.abs(a).max(), 1e-6)
        assert np.abs(a - b).max() / scale < 1e-3, f
        a, b = np.asarray(getattr(g1s, f)), np.asarray(getattr(g2s, f))
        scale = max(np.abs(a).max(), 1e-6)
        assert np.abs(a - b).max() / scale < 1e-3, f


def test_record_film_matches_replay_image(setup):
    """The recorded primal film (used as the L2 cotangent source in the
    sharded step) equals the replay primal."""
    scene, cam = setup
    cfg = IntegratorConfig()
    key = rng.make_key(3)
    _, _, img = material_grads_wavetape(scene, cam, 4, key, cfg,
                                        lanes=256, chunk=256)
    _, film = jax.jit(lambda s, c, k: record_paths_wavefront(
        s, c, 4, k, cfg, 256))(scene, cam, key)
    np.testing.assert_allclose(np.asarray(film.reshape(16, 16, 3)),
                               np.asarray(img), rtol=1e-3, atol=1e-3)


def test_wavetape_sharded_invariance():
    """8-device step == 1-device step (loss, image, grads) up to float
    reassociation; lanes/chunk are pure scheduling and may differ."""
    cfg = IntegratorConfig()

    def run(ndev, lanes, chunk):
        scene = procedural.cornell_box_scene(
            include_spheres=True).with_mt()
        cam = procedural.default_camera(16, 16)
        key = rng.make_key(3)
        tgt = jnp.zeros((16, 16, 3))
        out = train_step_wavetape_sharded(
            scene, cam, tgt, 4, key, make_ray_mesh(ndev), cfg, lanes,
            chunk)
        return jax.tree.map(np.asarray, out)

    l1, g1, i1 = run(1, 256, 256)
    l8, g8, i8 = run(8, 32, 128)
    np.testing.assert_allclose(l1, l8, rtol=1e-5)
    np.testing.assert_allclose(i1, i8, rtol=1e-4, atol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g8)):
        scale = max(np.abs(a).max(), 1e-6)
        assert np.abs(a - b).max() / scale < 1e-4


def test_wavetape_step_matches_replay_step_spp4():
    """The sharded wavetape training step and the replay training step
    differentiate the same L2 loss: loss and grads agree at spp > 1 (the
    wavetape cotangent carries the 1/spp per-sample share)."""
    from pathtrace_tpu.parallel.mesh import train_step_replay_sharded

    cfg = IntegratorConfig()
    scene = procedural.cornell_box_scene(include_spheres=True).with_mt()
    cam = procedural.default_camera(16, 16)
    key = rng.make_key(4)
    tgt = jnp.full((16, 16, 3), 0.2)
    mesh = make_ray_mesh(2)
    lw, gw, iw = train_step_wavetape_sharded(scene, cam, tgt, 4, key, mesh,
                                             cfg, 256, 256)
    lr_, gr, ir = train_step_replay_sharded(scene, cam, tgt, 4, key, mesh,
                                            cfg)
    np.testing.assert_allclose(float(lw), float(lr_), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(iw), np.asarray(ir), rtol=1e-3,
                               atol=1e-3)
    for a, b in zip(jax.tree_util.tree_leaves(gr),
                    jax.tree_util.tree_leaves(gw)):
        scale = max(np.abs(np.asarray(a)).max(), 1e-6)
        assert np.abs(np.asarray(a) - np.asarray(b)).max() / scale < 1e-3
