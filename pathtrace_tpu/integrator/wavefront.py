"""Wavefront path tracing with path regeneration (the scaled primal path).

The lockstep megakernel (megakernel.py) advances a fixed ray batch through
all bounce iterations with dead lanes masked - after Russian roulette and
misses most lanes idle. This module restructures the loop the way the
north star prescribes (regenerate/intersect/shade): one persistent lane
array; every iteration each lane either continues its path or - if its
path terminated - commits its radiance to the film (scatter-add) and pulls
a fresh camera path from the pixel*sample pool. Occupancy stays ~100%
until the pool drains.

Per-path estimator semantics are IDENTICAL to the megakernel: the bounce
transition is the shared make_bounce_fn, and randomness is keyed by
(ray_id, path-local bounce counter), so each path sees the same stream in
either scheduler (test: test_wavefront.py). Film accumulation order
differs, so images agree to float-sum reordering.

Shading stays branchless over the four lobes (masked select) rather than
sorting lanes by lobe every bounce.

while_loop + scatter => primal-only; gradients use the scan megakernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pathtrace_tpu.core.camera import Camera
from pathtrace_tpu.integrator.config import IntegratorConfig
from pathtrace_tpu.integrator.megakernel import make_bounce_fn
from pathtrace_tpu.models.scene import Scene
from pathtrace_tpu.ops.intersect import raycast_brute
from pathtrace_tpu.utils import rng


def _regen_rays(camera: Camera, path_idx, base_key, num_pix):
    """Camera ray for global path index = sample*num_pix + pixel."""
    pixel = (path_idx % num_pix).astype(jnp.int32)
    px = (pixel % camera.width).astype(jnp.float32)
    py = (pixel // camera.width).astype(jnp.float32)
    ju = rng.pixel_jitter(base_key, path_idx)
    dirs = camera.ray_directions(px, py, ju[:, 0], ju[:, 1])
    org = jnp.broadcast_to(camera.pos, dirs.shape)
    return org, dirs, pixel


def _make_to_global(num_pix_local, num_pix_total, pix_offset):
    """Local path id -> GLOBAL path id for a contiguous pixel slice.

    A sharded render gives each chip pixels [pix_offset, pix_offset +
    num_pix_local) of the full image; the chip enumerates its own local
    pool (sample * num_pix_local + local_pixel) for lane scheduling, but
    RNG streams and camera rays must be keyed by the GLOBAL path id
    (sample * num_pix_total + pix_offset + local_pixel) so an N-chip
    render is path-for-path identical to the 1-chip render (SURVEY.md §4
    shard-invariance). Identity when the slice is the whole image.
    """
    if num_pix_total is None or (num_pix_local == num_pix_total):
        return lambda local: local

    def to_global(local):
        sample = local // num_pix_local
        lpix = local % num_pix_local
        return sample * num_pix_total + pix_offset + lpix

    return to_global


def _run_wavefront(scene: Scene, camera: Camera, spp, base_key,
                  cfg: IntegratorConfig, lanes: int, sample_offset=0,
                  pix_offset=0, num_pix_local=None, num_pix_total=None):
    """spp and sample_offset may be TRACED scalars: they only feed the
    dynamic while_loop bound and the path-id arithmetic, so one
    compilation serves every sample count and chunk (chunked launches
    share this program).

    Path ids span [sample_offset*num_pix, (sample_offset+spp)*num_pix).

    Path->lane assignment is STRIDED whenever the sizes allow it
    (lanes % num_pix == 0 or num_pix % lanes == 0): lane i handles path
    ids base + i, base + i + lanes, ... so its film pixel cycles through
    a fixed per-lane set of K = max(1, num_pix // lanes) pixels. The film
    is then a dense (K, lanes, 3) per-lane accumulator committed with a
    K-wide one-hot multiply-add - NO scatter. The generic pool assignment
    (shared next_path counter + cumsum + per-pixel scatter-add) remains
    as fallback for arbitrary sizes.
    """
    num_pix = (camera.width * camera.height if num_pix_local is None
               else num_pix_local)  # pixels THIS pool owns (a slice when
    # sharded; path/lane arithmetic below runs in local ids)
    to_global = _make_to_global(num_pix, num_pix_total, pix_offset)
    spp = jnp.asarray(spp, jnp.int32)
    base_path = jnp.asarray(sample_offset, jnp.int32) * num_pix
    total_paths = num_pix * spp

    from pathtrace_tpu.integrator.megakernel import default_raycast
    raycast_fn = partial(default_raycast(scene), scene)
    bounce = make_bounce_fn(scene, lambda o, d, tn, tx: raycast_fn(o, d, tn, tx),
                            cfg, base_key)

    static_assign = lanes % num_pix == 0 or num_pix % lanes == 0
    k_pix = max(1, num_pix // lanes)  # pixels owned per lane (static)

    if static_assign:
        film = jnp.zeros((k_pix, lanes, 3), jnp.float32)
    else:
        film = jnp.zeros((num_pix, 3), jnp.float32)

    npt = num_pix if num_pix_total is None else num_pix_total
    local0 = jnp.arange(lanes, dtype=jnp.int32)
    init_ids = base_path + local0
    org0, dir0, _ = _regen_rays(camera, to_global(init_ids), base_key, npt)
    pixel0 = init_ids % num_pix  # film-local pixel (pool fallback)
    alive0 = local0 < total_paths  # lanes may exceed tiny pools

    state = dict(
        film=film,
        org=org0, dirn=dir0,
        radiance=jnp.zeros((lanes, 3), jnp.float32),
        weight=jnp.ones((lanes, 3), jnp.float32),
        depth=jnp.zeros((lanes,), jnp.int32),
        refract_cnt=jnp.zeros((lanes,), jnp.int32),
        refracted=jnp.zeros((lanes,), bool),
        alive=alive0,
        ray_ids=init_ids,
        lane_iter=jnp.zeros((lanes,), jnp.int32),
        rays=jnp.zeros((), jnp.float32),
    )
    if not static_assign:
        state["pixel"] = pixel0
        state["next_path"] = jnp.asarray(lanes, jnp.int32)

    def cond(s):
        return jnp.any(s["alive"])

    def body(s):
        (org, dirn, radiance, weight, depth, refract_cnt, refracted,
         alive_next, traced) = bounce(
            s["org"], s["dirn"], s["radiance"], s["weight"], s["depth"],
            s["refract_cnt"], s["refracted"], s["alive"],
            to_global(s["ray_ids"]), s["lane_iter"])

        died = s["alive"] & ~alive_next
        contrib = jnp.where(died[:, None], radiance, 0.0)
        if static_assign:
            # lane i at its k-th path has pixel (i + (k%K)*lanes) % num_pix
            # with K = k_pix; commit is a dense K-wide one-hot madd.
            if k_pix == 1:
                film = s["film"] + contrib[None]
            else:
                kmod = ((s["ray_ids"] - base_path) // lanes) % k_pix
                onehot = (kmod[None, :]
                          == jnp.arange(k_pix, dtype=jnp.int32)[:, None])
                film = s["film"] + onehot[:, :, None] * contrib[None]
        else:
            film = s["film"].at[s["pixel"]].add(contrib)

        # --- regeneration
        if static_assign:
            # strided: lane i's next path id is simply ray_id + lanes
            new_idx = s["ray_ids"] + lanes
            regen = died & (new_idx - base_path < total_paths)
            new_idx_safe = jnp.where(regen, new_idx, 0)
        else:
            # pool: dead lanes pull consecutive fresh paths via a shared
            # counter (cumsum over death flags)
            slot = jnp.cumsum(died.astype(jnp.int32)) - 1
            new_local = s["next_path"] + slot
            regen = died & (new_local < total_paths)
            new_idx_safe = jnp.where(regen, base_path + new_local, 0)
        r_org, r_dir, _ = _regen_rays(camera, to_global(new_idx_safe),
                                      base_key, npt)
        r_pixel = new_idx_safe % num_pix

        sel = regen[:, None]
        out = dict(
            film=film,
            org=jnp.where(sel, r_org, org),
            dirn=jnp.where(sel, r_dir, dirn),
            radiance=jnp.where(sel, 0.0, radiance),
            weight=jnp.where(sel, 1.0, weight),
            depth=jnp.where(regen, 0, depth),
            refract_cnt=jnp.where(regen, 0, refract_cnt),
            refracted=jnp.where(regen, False, refracted),
            alive=alive_next | regen,
            ray_ids=jnp.where(regen, new_idx_safe, s["ray_ids"]),
            lane_iter=jnp.where(regen, 0, s["lane_iter"] + 1),
            rays=s["rays"] + traced,
        )
        if not static_assign:
            out["pixel"] = jnp.where(regen, r_pixel, s["pixel"])
            out["next_path"] = (s["next_path"]
                                + jnp.sum(died.astype(jnp.int32)))
        return out

    state = jax.lax.while_loop(cond, body, state)
    if static_assign:
        # film[k, i] belongs to pixel (i + k*lanes) % num_pix
        if num_pix >= lanes:
            film_pix = state["film"].reshape(num_pix, 3)
        else:
            film_pix = state["film"].reshape(lanes // num_pix,
                                             num_pix, 3).sum(axis=0)
    else:
        film_pix = state["film"]
    if num_pix_local is not None:
        # sharded slice: hand back the flat (num_pix_local, 3) film; the
        # shard_map caller assembles the full image from the slices
        return (film_pix.reshape(num_pix, 3) / spp.astype(jnp.float32),
                state["rays"])
    img = (film_pix.reshape(camera.height, camera.width, 3)
           / spp.astype(jnp.float32))
    return img, state["rays"]


@partial(jax.jit, static_argnames=("cfg", "lanes"))
def render_wavefront(scene: Scene, camera: Camera, spp, base_key,
                     cfg: IntegratorConfig = IntegratorConfig(),
                     lanes: int = 65536, sample_offset=0):
    """(H, W, 3) mean radiance. `lanes` = persistent wavefront width;
    spp/sample_offset may be traced (one compile serves all counts)."""
    return _run_wavefront(scene, camera, spp, base_key, cfg, lanes,
                          sample_offset)[0]


@partial(jax.jit, static_argnames=("cfg", "lanes"))
def render_wavefront_stats(scene: Scene, camera: Camera, spp, base_key,
                           cfg: IntegratorConfig = IntegratorConfig(),
                           lanes: int = 65536, sample_offset=0):
    """(image, total rays traced) - for the throughput benchmark."""
    return _run_wavefront(scene, camera, spp, base_key, cfg, lanes,
                          sample_offset)


@partial(jax.jit, static_argnames=("cfg", "lanes"))
def _chunk_accum(scene, camera, film, rays, spp_chunk, offset, base_key,
                 cfg, lanes):
    """One chunk launch that also folds accumulation into the program -
    no eager device ops between launches."""
    img, nrays = _run_wavefront(scene, camera, spp_chunk, base_key, cfg,
                                lanes, offset)
    film = film + img * jnp.asarray(spp_chunk, jnp.float32)
    return film, rays + nrays


def render_wavefront_chunked(scene: Scene, camera: Camera, spp: int,
                             base_key,
                             cfg: IntegratorConfig = IntegratorConfig(),
                             lanes: int = 65536,
                             chunk_spp: int = 64):
    """Multi-launch wavefront render: chunks of chunk_spp samples per
    device program launch, all sharing one compiled program (no single
    launch runs for minutes). Returns ((H, W, 3) image, total rays
    traced)."""
    import numpy as np

    film = jnp.zeros((camera.height, camera.width, 3), jnp.float32)
    rays = jnp.zeros((), jnp.float32)
    done = 0
    while done < spp:
        cur = min(chunk_spp, spp - done)
        film, rays = _chunk_accum(scene, camera, film, rays,
                                  np.int32(cur), np.int32(done), base_key,
                                  cfg, lanes)
        done += cur
    # single host fetch + host-side normalization
    return jnp.asarray(np.asarray(film) / spp), float(rays)
