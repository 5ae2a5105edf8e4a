"""v3 pair-block traversal (accel/binned.py + ops/pallas/pair_kernel.py)
against the brute-force oracle and the v1 XLA binned path.

On the CPU the v3 path runs the plain jnp pair search; the Triton kernel
is compared with it in interpret mode in test_pair_search.py.
"""

import dataclasses

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


def _bounds(r):
    return (jnp.zeros((r,), jnp.float32),
            jnp.full((r,), 999999.0, jnp.float32))


@pytest.fixture(scope="module")
def scene():
    return procedural.sphere_mesh_scene(subdivisions=4).with_kd_binned(
        max_tris=128).to_device()


def _assert_matches_brute(a, hit, t, prim, hit_agree=0.995):
    agree = np.asarray(a.hit) == np.asarray(hit)
    assert agree.mean() > hit_agree, agree.mean()
    both = np.asarray(a.hit) & np.asarray(hit) & agree
    if t is not None:
        np.testing.assert_allclose(np.asarray(a.t)[both],
                                   np.asarray(t)[both], rtol=1e-4, atol=1e-3)
    same = np.asarray(a.prim_id)[both] == np.asarray(prim)[both]
    assert same.mean() > 0.995


def test_pair_kernel_matches_brute(scene):
    org, d = _rays(512, 0)
    a = raycast_brute(scene, org, d)
    hit, t, gid, overflow = binned.search_pairs_v3(scene, org, d,
                                                   *_bounds(512))
    assert np.asarray(overflow).mean() == 0.0
    # the search's t is the reduce key's quantized t (~1e-3 relative);
    # the raycast recomputes the winner's exact t
    _assert_matches_brute(a, hit, None, gid)
    np.testing.assert_allclose(np.asarray(t)[np.asarray(hit)],
                               np.asarray(a.t)[np.asarray(hit)], rtol=2e-3)
    h = binned.raycast_binned_v3(scene, org, d)
    _assert_matches_brute(a, h.hit, h.t, h.prim_id)


def test_pair_kernel_matches_xla_binned(scene):
    """v3 over KD cells and v1 over BVH-subtree clusters find the same
    hits (their triangle orders differ, so compare hit points)."""
    org, d = _rays(256, 3)
    v1_scene = procedural.sphere_mesh_scene(subdivisions=4).with_binned(
        max_tris=128)
    a = binned.raycast_binned(v1_scene, org, d)
    h = binned.raycast_binned_v3(scene, org, d)
    agree = np.asarray(a.hit) == np.asarray(h.hit)
    assert agree.mean() > 0.995
    both = np.asarray(a.hit) & np.asarray(h.hit) & agree
    np.testing.assert_allclose(np.asarray(a.t)[both], np.asarray(h.t)[both],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(a.p)[both], np.asarray(h.p)[both],
                               atol=1e-3)


def test_raycast_binned_v2_hitrecord(scene):
    """Full HitRecord through v3 and the generic finalize tail (no packed
    geometry row), as scenes with spheres take it."""
    org, d = _rays(256, 4)
    a = raycast_brute(scene, org, d)
    h = binned.raycast_binned_v3(dataclasses.replace(scene, geom_pack=None),
                                 org, d)
    _assert_matches_brute(a, h.hit, h.t, h.prim_id)
    both = np.asarray(a.hit) & np.asarray(h.hit)
    n = np.asarray(h.normal)[both]
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-3)


def test_shadow_mode_winner_identity(scene):
    """The shadow backend returns the closest-hit backend's winner."""
    org, d = _rays(256, 5)
    tn, tx = _bounds(256)
    h = binned.raycast_binned_v3(scene, org, d, tn, tx)
    s_hit, s_gid, s_sph = binned.shadow_binned_v3(scene, org, d, tn, tx)
    assert not np.asarray(s_sph).any()
    np.testing.assert_array_equal(np.asarray(s_hit), np.asarray(h.hit))
    both = np.asarray(h.hit)
    np.testing.assert_array_equal(np.asarray(s_gid)[both],
                                  np.asarray(h.prim_id)[both])


def test_pair_dispatch_structure(scene):
    """Every (ray, cell) crossing lands exactly once in a block of its
    own cell; block tables agree with the cell table."""
    org, d = _rays(128, 6)
    from pathtrace_tpu.accel.traverse import safe_inv_dir
    cl = scene.clusters
    hit_m, _ = binned._slab_all(org, safe_inv_dir(d), cl.bmin, cl.bmax,
                                *_bounds(128))
    b = binned.BLOCK_PAIRS
    disp = binned.build_pair_dispatch_v3(cl, hit_m, b)
    slot_ray = np.asarray(disp["slot_ray"])
    live = np.asarray(disp["live"])
    bc = np.asarray(disp["block_cluster"])
    bps = np.asarray(disp["block_prim_start"])
    cnt = np.asarray(disp["block_count"])
    hm = np.asarray(hit_m)
    assert not np.asarray(disp["overflow"]).any()
    blk = np.nonzero(live)[0] // b
    assert (bps[blk] == np.asarray(cl.prim_start)[bc[blk]]).all()
    assert (cnt[blk] == np.asarray(cl.prim_count)[bc[blk]]).all()
    assert hm[slot_ray[live], bc[blk]].all()
    pairs = set(zip(slot_ray[live].tolist(), bc[blk].tolist()))
    assert len(pairs) == live.sum() == hm.sum()
    pad = bps < 0
    assert (cnt[pad] == 0).all() and not live.reshape(-1, b)[pad].any()


def test_raycast_binned_v3_hitrecord_packed_tail():
    """v3 over KD cells + the one-gather packed shading tail
    (finalize_hit_packed): every HitRecord field matches the brute
    raycast's generic finalize on a tri-only KD scene."""
    scene = procedural.sphere_mesh_scene(subdivisions=4).with_kd_binned(
        max_tris=128)
    assert scene.geom_pack is not None and scene.num_spheres == 0
    org, d = _rays(256, 6)
    a = raycast_brute(scene, org, d)
    h = binned.raycast_binned_v3(scene, org, d)
    agree = np.asarray(a.hit) == np.asarray(h.hit)
    assert agree.mean() > 0.995
    both = np.asarray(a.hit) & np.asarray(h.hit) & agree
    for field, tol in (("t", 1e-3), ("p", 1e-3), ("normal", 1e-4),
                       ("tangent", 1e-4), ("bitangent", 1e-4),
                       ("uv", 1e-5)):
        np.testing.assert_allclose(
            np.asarray(getattr(a, field))[both],
            np.asarray(getattr(h, field))[both], rtol=1e-4, atol=tol,
            err_msg=field)
    assert np.array_equal(np.asarray(a.prim_id)[both],
                          np.asarray(h.prim_id)[both])
    for f in ("emittance", "albedo", "specular", "opacity", "roughness",
              "metallic"):
        np.testing.assert_allclose(
            np.asarray(getattr(a.mat, f))[both],
            np.asarray(getattr(h.mat, f))[both], err_msg=f)
