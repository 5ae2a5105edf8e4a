"""Pair-block search implementations (ops/pallas/pair_kernel.py).

The plain jnp search against the brute-force oracle; the Pallas-Triton
kernel, run by the Pallas interpreter, against the plain search; the
platform choice; padding, dead slots and the member-count bound. The
compiled kernel itself runs only on a GPU (the chip-marked test).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from unittest import mock

from pathtrace_tpu.accel import binned
from pathtrace_tpu.models import procedural
from pathtrace_tpu.ops.intersect import raycast_brute
from pathtrace_tpu.ops.pallas import pair_kernel as pk
from pathtrace_tpu.utils.math3 import EPS

B = binned.BLOCK_PAIRS


@pytest.fixture(scope="module")
def scene():
    return procedural.sphere_mesh_scene(subdivisions=4).with_kd_binned(
        max_tris=128).to_device()


def _camera_rays(n, seed):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-25.0, 45.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def _surface_rays(scene, n, seed):
    """Rays leaving points on the surface (the bounce/shadow regime)."""
    rng = np.random.default_rng(seed)
    v0 = np.asarray(scene.tris.v0)
    org = v0[rng.integers(0, v0.shape[0], n)] + rng.normal(
        scale=1e-3, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(org, jnp.float32), jnp.asarray(d, jnp.float32)


def _inputs(scene, org, d, tmin=None, tmax=None, b=B):
    r = org.shape[0]
    tmin = jnp.zeros((r,), jnp.float32) if tmin is None else tmin
    tmax = jnp.full((r,), 999999.0, jnp.float32) if tmax is None else tmax
    disp, f, tn, tx = binned.pair_inputs_v3(scene.clusters, org, d, tmin,
                                            tmax, b)
    args = (jnp.asarray(scene.clusters.coeffs), disp["block_cluster"],
            disp["block_count"], f, tn, tx)
    return disp, args


def _per_ray(scene, disp, t_slot, member, r, b=B):
    """Exact per-ray closest hit from per-slot results (no key
    quantization): (hit, t, original tri id)."""
    t_slot = np.where(np.asarray(disp["live"]), np.asarray(t_slot), np.inf)
    ray = np.asarray(disp["slot_ray"])
    best = np.full((r,), np.inf, np.float32)
    np.minimum.at(best, ray, t_slot)
    mem = (np.asarray(disp["block_prim_start"])[:, None]
           + np.asarray(member).reshape(-1, b)).reshape(-1)
    gid = np.asarray(scene.clusters.dup_map)[np.clip(mem, 0, None)]
    win = np.full((r,), -1)
    for s in np.nonzero(np.isfinite(t_slot) & (t_slot == best[ray]))[0]:
        if win[ray[s]] < 0:
            win[ray[s]] = gid[s]
    return np.isfinite(best), best, win


@pytest.mark.parametrize("mode", ["closest", "shadow"])
def test_plain_search_matches_brute(scene, mode):
    """closest: camera rays over [0, inf); shadow: surface rays with
    t_min = EPS and a finite t_max, as NEE casts them."""
    r = 384
    if mode == "closest":
        org, d = _camera_rays(r, 0)
        tmin = jnp.zeros((r,), jnp.float32)
        tmax = jnp.full((r,), 999999.0, jnp.float32)
    else:
        org, d = _surface_rays(scene, r, 1)
        tmin = jnp.full((r,), EPS, jnp.float32)
        tmax = jnp.asarray(np.random.default_rng(2).uniform(1.0, 30.0, r),
                           jnp.float32)
    disp, args = _inputs(scene, org, d, tmin, tmax)
    assert not np.asarray(disp["overflow"]).any()
    hit, t, gid = _per_ray(scene, disp, *pk.pair_search_plain(
        *args, block_pairs=B), r)
    a = raycast_brute(scene, org, d, tmin, tmax)
    agree = np.asarray(a.hit) == hit
    assert agree.mean() > 0.995, agree.mean()
    both = np.asarray(a.hit) & hit
    np.testing.assert_allclose(np.asarray(a.t)[both], t[both], rtol=1e-4,
                               atol=1e-3)
    assert (np.asarray(a.prim_id)[both] == gid[both]).mean() > 0.995


@pytest.mark.parametrize("rays,b", [("camera", B), ("surface", B),
                                    ("camera", 16)])
def test_kernel_interpret_matches_plain(scene, rays, b):
    org, d = (_camera_rays(256, 3) if rays == "camera"
              else _surface_rays(scene, 256, 4))
    _, args = _inputs(scene, org, d, b=b)
    tp, mp = (np.asarray(x) for x in pk.pair_search_plain(
        *args, block_pairs=b))
    tk, mk = (np.asarray(x) for x in pk.pair_search_kernel(
        *args, block_pairs=b, interpret=True))
    fin = np.isfinite(tp)
    assert fin.sum() > 0
    np.testing.assert_array_equal(np.isfinite(tk), fin)
    np.testing.assert_allclose(tk[fin], tp[fin], rtol=1e-4, atol=1e-3)
    assert (mk[fin] == mp[fin]).mean() > 0.999


def _fake_inputs():
    """Two cells x 32 members, 2 blocks of 16 pairs, all hitting."""
    rng = np.random.default_rng(5)
    coeffs = jnp.asarray(rng.normal(size=(2, 4, 16, 32)), jnp.float32)
    feats = jnp.asarray(rng.normal(size=(32, 16)), jnp.float32)
    return coeffs, feats


def test_choice_cpu_runs_plain():
    coeffs, feats = _fake_inputs()
    args = (coeffs, jnp.array([0, 1]), jnp.array([32, 32]), feats,
            jnp.zeros(32), jnp.full(32, 1e6))
    with mock.patch.dict(pk.IMPLEMENTATIONS,
                         {"gpu": mock.Mock(side_effect=AssertionError)}):
        got = pk.pair_search(*args, block_pairs=16)
    want = pk.pair_search_plain(*args, block_pairs=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_choice_gpu_runs_kernel():
    sentinel = mock.Mock(return_value="kernel-result")
    with mock.patch.object(jax, "default_backend", return_value="gpu"), \
            mock.patch.dict(pk.IMPLEMENTATIONS, {"gpu": sentinel}):
        assert pk.pair_search(1, 2, 3, 4, 5, 6,
                              block_pairs=16) == "kernel-result"
    sentinel.assert_called_once_with(1, 2, 3, 4, 5, 6, block_pairs=16)
    assert pk.IMPLEMENTATIONS["gpu"] is pk.pair_search_kernel
    assert pk.IMPLEMENTATIONS["cpu"] is pk.pair_search_plain


@pytest.mark.parametrize("platform", ["METAL", "neuron"])
def test_choice_unknown_platform_raises(platform):
    with mock.patch.object(jax, "default_backend", return_value=platform):
        with pytest.raises(NotImplementedError, match=platform):
            pk.pair_search(None, None, None, None, None, None,
                           block_pairs=16)


def test_padding_blocks_and_dead_slots_miss(scene):
    """Padding blocks (count 0) and dead slots (zero feature rows) never
    report a hit, in either implementation."""
    org, d = _camera_rays(256, 6)
    disp, args = _inputs(scene, org, d)
    live = np.asarray(disp["live"])
    pad = np.repeat(np.asarray(disp["block_prim_start"]) < 0, B)
    assert pad.any() and (~live & ~pad).any()
    for t, _ in (pk.pair_search_plain(*args, block_pairs=B),
                 pk.pair_search_kernel(*args, block_pairs=B,
                                       interpret=True)):
        t = np.asarray(t)
        assert np.isinf(t[pad]).all() and np.isinf(t[~live]).all()
        assert np.isfinite(t[live]).any()


def test_member_count_bounds_the_search():
    """Members at or past a block's count are never searched: the kernel
    stops its chunk walk there, the plain search masks them."""
    # make every member an easy hit with t = member index + 1
    det = jnp.zeros((16,)).at[0].set(1.0)
    tiles = jnp.stack([jnp.tile(det[:, None], (1, 32)),
                       jnp.zeros((16, 32)).at[0].set(
                           jnp.arange(32, 0, -1.0)),
                       jnp.zeros((16, 32)), jnp.zeros((16, 32))])
    coeffs = jnp.stack([tiles, tiles])
    feats = jnp.zeros((32, 16)).at[:, 0].set(1.0)
    args = (coeffs, jnp.array([0, 1]), jnp.array([32, 9]), feats,
            jnp.zeros(32), jnp.full(32, 1e6))
    for t, m in (pk.pair_search_plain(*args, block_pairs=16),
                 pk.pair_search_kernel(*args, block_pairs=16, chunk=16,
                                       interpret=True)):
        # t = 32 - member: the last searched member wins
        np.testing.assert_array_equal(np.asarray(m)[:16], 31)
        np.testing.assert_array_equal(np.asarray(m)[16:], 8)
        np.testing.assert_allclose(np.asarray(t)[16:], 24.0)


def test_block_pairs_must_be_power_of_two():
    coeffs, feats = _fake_inputs()
    with pytest.raises(AssertionError):
        pk.pair_search_kernel(coeffs, jnp.array([0, 1]),
                              jnp.array([32, 32]),
                              jnp.zeros((48, 16)), jnp.zeros(48),
                              jnp.ones(48), block_pairs=24, interpret=True)


@pytest.mark.chip
def test_compiled_kernel_matches_plain(gpu, scene):
    """The kernel as compiled for the card, against the plain search."""
    org, d = _surface_rays(scene, 2048, 7)
    _, args = _inputs(scene, org, d)
    tp, mp = (np.asarray(x) for x in pk.pair_search_plain(
        *args, block_pairs=B))
    tk, mk = (np.asarray(x) for x in pk.pair_search_kernel(
        *args, block_pairs=B))
    fin = np.isfinite(tp)
    assert (np.isfinite(tk) == fin).mean() > 0.999
    both = fin & np.isfinite(tk)
    np.testing.assert_allclose(tk[both], tp[both], rtol=1e-4, atol=1e-3)
    assert (mk[both] == mp[both]).mean() > 0.995
