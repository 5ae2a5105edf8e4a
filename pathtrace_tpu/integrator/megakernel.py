"""Batch "SIMT" path integrator: all rays advance through bounces in
lockstep, dead lanes masked.

This is the batched restructuring of the reference's per-thread
megakernel GetColor_iter (CudaUtil.cuh:193-382): instead of one CUDA thread
looping over its private path, a whole ray batch moves through one
`lax.scan` over bounce iterations, every step a dense array op. Estimator
semantics are preserved exactly, quirks included:

- additive NEE + emissive-hit every bounce, no MIS (CudaUtil.cuh:220-224 +
  272 -> direct light double-counted; fidelity-critical bias, kept)
- miss adds weight * (0.1, 0.1, 0.1) (CudaUtil.cuh:377)
- weight *= eval / max(pdf, 1e-2) (CudaUtil.cuh:291 et al.)
- zero sampled direction kills the path (CudaUtil.cuh:335-338)
- refraction does not consume depth: Depth-- plus RefractCnt cap with the
  pre-increment check `RefractCnt++ > 8` (CudaUtil.cuh:349-359)
- the refraction flag is STICKY: it is only (re)assigned on transparent
  hits (CudaUtil.cuh:307), so after a refraction every subsequent opaque
  bounce also skips depth/RR until the refract cap trips. Faithfully kept.
- Russian roulette from bounce 3: survive prob max(min(max(weight),1),0.5),
  1/p compensation (CudaUtil.cuh:361-373)
- next origin offset +-EPS along the shading normal by refraction flag
  (CudaUtil.cuh:349)

Differentiation: with cfg.detach_sampling, sampled directions, pdfs, RR
decisions and discrete picks are wrapped in stop_gradient ("detached
sampling" estimator), which leaves the primal unchanged and the material/
emission gradient unbiased w.r.t. the sampling distribution.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pathtrace_tpu.integrator.config import IntegratorConfig
from pathtrace_tpu.models.scene import Scene
from pathtrace_tpu.ops import bsdf
from pathtrace_tpu.ops.bsdf import ShadeFrame
from pathtrace_tpu.ops.intersect import HitRecord, raycast_brute
from pathtrace_tpu.utils import math3, rng
from pathtrace_tpu.utils.math3 import EPS, dot, normalize


def _maybe_detach(x, cfg: IntegratorConfig):
    return jax.lax.stop_gradient(x) if cfg.detach_sampling else x


def default_raycast(scene: Scene):
    """Pick the best available intersection backend for this scene:
    v3 pair-block search (KD cells) > v1 binned clusters > MT-matmul
    coefficients > BVH traversal > brute.

    The v3 route is gated on clusters.dup_map (KD cells): BVH-subtree
    clusters overlap heavily around dense surfaces, so routing them
    through the pair dispatch re-creates the overflow storms the KD
    partition exists to avoid - with_binned() scenes keep the calibrated
    k=48 v1 path."""
    if scene.clusters is not None and scene.clusters.dup_map is not None:
        from pathtrace_tpu.accel.binned import raycast_binned_v3
        return raycast_binned_v3
    if scene.clusters is not None and scene.clusters.dup_map is None:
        from pathtrace_tpu.accel.binned import raycast_binned
        return raycast_binned
    if scene.mt is not None:
        from pathtrace_tpu.ops.mt_matmul import raycast_matmul
        return raycast_matmul
    if scene.bvh is not None:
        from pathtrace_tpu.accel.traverse import raycast_bvh
        return raycast_bvh
    return raycast_brute


def default_shadow_raycast(scene: Scene):
    """Shadow-ray backend: (org, dir, t_min, t_max) ->
    (hit, prim_id, is_sphere).

    NEE only needs the winning primitive's identity (see
    nee_contribution); these lean paths skip the full attribute
    interpolation of the primary raycast."""
    from pathtrace_tpu.ops.intersect import shadow_brute

    if scene.clusters is not None and scene.clusters.dup_map is not None:
        from pathtrace_tpu.accel.binned import shadow_binned_v3
        return shadow_binned_v3
    if scene.mt is not None and scene.clusters is None:
        from pathtrace_tpu.ops.mt_matmul import shadow_matmul
        return shadow_matmul

    full = default_raycast(scene)

    def adapter(sc, o, d, tn, tx):
        hitrec = full(sc, o, d, tn, tx)
        return hitrec.hit, hitrec.prim_id, hitrec.is_sphere

    if scene.clusters is not None or scene.bvh is not None:
        return adapter
    return shadow_brute


def nee_light_pick(scene: Scene, draws: jnp.ndarray):
    """(light_slot, light_tri) for this bounce's NEE draw - a pure
    function of the counter-based draws, shared by nee_contribution, the
    wavefront tape recorder and the replay shadow reconstruction
    (diff/wavetape.py) so the pick logic lives in exactly one place."""
    light_slot = rng.randint_from_uniform(draws[:, rng.COL_LIGHT_PICK],
                                          scene.num_lights)
    return light_slot, math3.gather_rows(scene.lights, light_slot)


def nee_contribution(scene: Scene, hit: HitRecord, frame: ShadeFrame,
                     wo: jnp.ndarray, draws: jnp.ndarray,
                     shadow_fn, cfg: IntegratorConfig) -> jnp.ndarray:
    """Next-event estimation for one bounce of the whole batch.

    Mirrors CudaUtil.cuh:234-272: uniform light pick, area sampling
    (SamplePrimitive, CudaUtil.cuh:38-48), shadow ray via a second full
    raycast (GetLightColor, CudaUtil.cuh:150-166), and the contribution
    brdfcos * Llight * cosA / (dist^2 * pdfLight), pdfLight = (1/area)/Nl.
    """
    nl = scene.num_lights
    light_slot, light_tri = nee_light_pick(scene, draws)
    # Per-light geometry from the packed (L, 13) table (Scene.build): one
    # gather from a tiny (L,) table instead of five over the (T,)
    # triangle arrays.
    row = math3.gather_rows(jnp.asarray(scene.light_pack), light_slot)
    v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    area = row[:, 9]
    light_normal = row[:, 10:13]
    # SamplePrimitive: r1 = sqrt(u), point = (1-r1)V0 + r1(1-r2)V1 + r1 r2 V2
    r1 = math3.safe_sqrt(draws[:, rng.COL_NEE_R1])[:, None]
    r2 = draws[:, rng.COL_NEE_R2][:, None]
    point = (1.0 - r1) * v0 + r1 * (1.0 - r2) * v1 + r1 * r2 * v2

    # Geometry terms stay differentiable: hit.p depends (through the
    # reparameterized sampler) on upstream material params, and FD sees
    # that transport dependence. Only the *visibility* query below is
    # detached (discrete).
    to_light = point - hit.p
    dist2 = math3.squared_length(to_light)
    dist = jnp.sqrt(jnp.maximum(dist2, math3.TINY))
    sdir = normalize(to_light)

    # Shadow ray: origin ON the surface, t_min = 0, t_max = dist + 1
    # (GetLightColor) - backface culling prevents self-hit.
    #
    # Acceptance DEVIATES from the reference's |s_p - sample| < EPS ball
    # test (CudaUtil.cuh:159): the ray reaches the light iff the winning
    # primitive IS the sampled light triangle. The two agree except for
    # emissive geometry coincident within EPS of the sampled point (the
    # reference would shade with the occluder's emittance) - a
    # measure-zero family - while the identity test is robust to float
    # reassociation across differently-compiled programs (the EPS-ball
    # margin is ~1e-5 at scene scale, inside cross-program noise, which
    # made renders/gradients nondeterministic across engines).
    # t_min = EPS, not the reference's 0 (GetLightColor passes tMin=0):
    # with t_min 0 a shadow ray leaving a SPHERE re-hits its own surface
    # at t ~ +-1e-7 depending on rounding, and that borderline accept
    # flipped between differently-compiled programs (measured: the
    # grad-program primal differed from the plain render by 1.6% on the
    # sphere scene, and reverse-mode/forward-mode gradients disagreed by
    # the flipped lanes' contributions). Triangles are immune (backface
    # cull); real occluders within EPS of the surface are measure-zero.
    s_hit, s_prim, s_sph = shadow_fn(
        jax.lax.stop_gradient(hit.p), jax.lax.stop_gradient(sdir),
        jnp.full_like(dist, EPS), jax.lax.stop_gradient(dist) + 1.0)
    reached = s_hit & ~s_sph & (s_prim == light_tri)
    # The sampled light's own emittance (differentiable gather).
    l_emit = math3.gather_rows(scene.mat.emittance, light_tri)
    light_color = jnp.where(reached[:, None], l_emit, 0.0)

    cos_a = jnp.maximum(dot(light_normal, normalize(hit.p - point)), 0.0)
    pdf_light = math3.safe_div(jnp.ones_like(area), area) / nl

    brdfcos = bsdf.eval_bsdfcos(hit.mat, frame, wo, sdir)
    contrib = (brdfcos * light_color * cos_a[:, None]
               / jnp.maximum(dist2 * pdf_light, math3.TINY)[:, None])
    # Reference skips NaN contributions (CudaUtil.cuh:271 isnan check).
    finite = jnp.all(jnp.isfinite(contrib), axis=-1, keepdims=True)
    return jnp.where(finite, contrib, 0.0)


def make_bounce_fn(scene: Scene, raycast_fn, cfg: IntegratorConfig, base_key,
                   shadow_fn=None, sample_mat_fn=None):
    """Core one-bounce transition shared by the lockstep megakernel and the
    regenerating wavefront pipeline.

    Takes per-lane state + per-lane path-local iteration counters; the same
    (ray_id, lane_iter) always draws the same randomness, so both
    integrators realize the identical estimator per path.

    sample_mat_fn: optional HitRecord -> Material override used ONLY for
    the sampling-side decisions (sampled direction, pdf denominator,
    transparency lobe family). The FD oracle passes a gather of the
    UNPERTURBED materials here, freezing the path realization so central
    differences measure exactly the detached-sampling derivative that
    production autodiff (cfg.detach_sampling) computes - FD of the live
    sampler instead picks up O(1/h) jump terms at discrete sampling
    flips. None (production) = hit.mat, identical primal.
    """
    if shadow_fn is None:
        sf = default_shadow_raycast(scene)
        shadow_fn = lambda o, d, tn, tx: sf(scene, o, d, tn, tx)

    def bounce(org, dirn, radiance, weight, depth, refract_cnt, refracted,
               alive, ray_ids, lane_iter):
        draws = rng.uniforms(base_key, ray_ids, lane_iter)

        hit = raycast_fn(org, dirn, jnp.zeros(org.shape[0], jnp.float32),
                         jnp.full((org.shape[0],), 999999.0, jnp.float32))
        live_hit = alive & hit.hit
        live_miss = alive & ~hit.hit

        # --- miss: += weight * 0.1 gray, path ends (CudaUtil.cuh:375-379)
        miss_rgb = jnp.asarray(cfg.miss_radiance, jnp.float32)
        radiance = radiance + jnp.where(live_miss[:, None],
                                        weight * miss_rgb, 0.0)

        frame = ShadeFrame(normal=hit.normal, tangent=hit.tangent,
                           bitangent=hit.bitangent, front_face=hit.front_face)
        wo = -dirn

        # --- emissive hit accumulates every bounce (CudaUtil.cuh:220-224)
        emissive = math3.squared_length(hit.mat.emittance) > EPS
        radiance = radiance + jnp.where((live_hit & emissive)[:, None],
                                        weight * hit.mat.emittance, 0.0)

        # --- NEE (CudaUtil.cuh:234-272)
        shadow_rays = 0
        if cfg.nee and scene.num_lights > 0:
            contrib = nee_contribution(scene, hit, frame, wo, draws,
                                       shadow_fn, cfg)
            radiance = radiance + jnp.where(live_hit[:, None],
                                            weight * contrib, 0.0)
            shadow_rays = jnp.sum(live_hit.astype(jnp.int32))

        # rays traced this iteration: one closest-hit per alive lane plus
        # one shadow ray per live hit (the bench counts real traversals,
        # matching the reference's "HOT LOOP #1/#2" accounting, SURVEY §3.4).
        # float32 accumulator: big renders overflow int32 (no x64 here).
        rays_traced = (jnp.sum(alive.astype(jnp.int32))
                       + shadow_rays).astype(jnp.float32)

        # --- BSDF sampling (CudaUtil.cuh:276-338)
        u_lobe = draws[:, rng.COL_LOBE]
        u_phi = draws[:, rng.COL_PHI]
        u_ry = draws[:, rng.COL_RY]
        uni = cfg.hemisphere == "uniform"
        smat = hit.mat if sample_mat_fn is None else sample_mat_fn(hit)
        wi = bsdf.sample_bsdf(smat, frame, wo, u_lobe, u_phi, u_ry,
                              uniform_hemi=uni)
        wi = _maybe_detach(wi, cfg)
        w1 = bsdf.eval_bsdfcos(hit.mat, frame, wo, wi)
        w2 = jnp.maximum(bsdf.pdf_bsdf(smat, frame, wo, wi,
                                       uniform_hemi=uni), cfg.pdf_clamp)
        w2 = _maybe_detach(w2, cfg)
        current_weight = w1 / w2[:, None]

        dead_sample = math3.squared_length(wi) <= EPS
        cont = live_hit & ~dead_sample
        weight = jnp.where(cont[:, None], weight * current_weight, weight)

        # --- sticky refraction flag: reassigned only on transparent hits
        # (CudaUtil.cuh:307); opaque hits keep the previous value.
        # Sampling-side discrete decision -> smat (frozen under FD).
        transparent = smat.opacity < (1.0 - EPS)
        new_refracted = dot(frame.normal, wo) * dot(frame.normal, wi) <= 0.0
        refracted = jnp.where(cont & transparent, new_refracted, refracted)

        # --- next ray (CudaUtil.cuh:349-350); Ray ctor normalizes dir.
        org_next = hit.p + frame.normal * jnp.where(refracted[:, None],
                                                    -EPS, EPS)
        dir_next = normalize(wi)
        org = jnp.where(cont[:, None], org_next, org)
        dirn = jnp.where(cont[:, None], dir_next, dirn)

        # --- refraction depth exemption + cap (CudaUtil.cuh:351-359):
        # `if (RefractCnt++ > 8) break` - pre-increment check.
        refract_now = cont & refracted
        over_cap = refract_now & (refract_cnt > cfg.refract_cap)
        refract_cnt = refract_cnt + refract_now.astype(jnp.int32)

        # --- Russian roulette (CudaUtil.cuh:361-373), skipped by refracting
        # lanes (`continue`). Uses the loop-entry depth value.
        rr_lane = cont & ~refracted & (depth >= cfg.rr_bounce)
        rr_prob = jnp.clip(math3.max3(_maybe_detach(weight, cfg)),
                           cfg.rr_stop_prob, 1.0)
        rr_survive = draws[:, rng.COL_RR] < rr_prob
        weight = jnp.where((rr_lane & rr_survive)[:, None],
                           weight / rr_prob[:, None], weight)

        # --- liveness & depth bookkeeping (for-loop increment, Depth--)
        depth_next = depth + jnp.where(cont & ~refracted, 1, 0)
        alive = (cont
                 & ~over_cap
                 & ~(rr_lane & ~rr_survive)
                 & (depth_next < cfg.max_bounce))
        depth = depth_next

        return (org, dirn, radiance, weight, depth, refract_cnt, refracted,
                alive, rays_traced)

    return bounce


def make_bounce_step(scene: Scene, raycast_fn, cfg: IntegratorConfig,
                     base_key, ray_ids, sample_mat_fn=None):
    """Scan body for the lockstep megakernel: all lanes share the global
    iteration counter (every path starts at iteration 0 together)."""
    bounce = make_bounce_fn(scene, raycast_fn, cfg, base_key,
                            sample_mat_fn=sample_mat_fn)

    def step(state, it):
        (org, dirn, radiance, weight, depth, refract_cnt, refracted,
         alive, ray_count) = state
        (org, dirn, radiance, weight, depth, refract_cnt, refracted,
         alive, traced) = bounce(org, dirn, radiance, weight, depth,
                                 refract_cnt, refracted, alive, ray_ids, it)
        return (org, dirn, radiance, weight, depth, refract_cnt, refracted,
                alive, ray_count + traced), None

    return step


def trace_paths_stats(scene: Scene, org: jnp.ndarray, dirn: jnp.ndarray,
                      ray_ids: jnp.ndarray, base_key,
                      cfg: IntegratorConfig = IntegratorConfig(),
                      raycast_fn=None, sample_mat_fn=None):
    """Estimate radiance for a batch of camera rays.

    Returns (radiance (R, 3), rays_traced scalar int32). raycast_fn(scene,
    org, dir, t_min, t_max) -> HitRecord defaults to the BVH traversal when
    the scene has one, else brute force.
    """
    if raycast_fn is None:
        raycast_fn = partial(default_raycast(scene), scene)
    else:
        raycast_fn = partial(raycast_fn, scene)

    r = org.shape[0]
    state = (
        org, dirn,
        jnp.zeros((r, 3), jnp.float32),   # radiance
        jnp.ones((r, 3), jnp.float32),    # weight
        jnp.zeros((r,), jnp.int32),       # depth
        jnp.zeros((r,), jnp.int32),       # refract count
        jnp.zeros((r,), bool),            # sticky refraction flag
        jnp.ones((r,), bool),             # alive
        jnp.zeros((), jnp.float32),       # rays traced
    )
    step = make_bounce_step(scene, lambda o, d, tn, tx: raycast_fn(o, d, tn, tx),
                            cfg, base_key, ray_ids,
                            sample_mat_fn=sample_mat_fn)
    if cfg.remat:
        step = jax.checkpoint(step)
    state, _ = jax.lax.scan(step, state, jnp.arange(cfg.max_iters))
    return state[2], state[8]


def trace_paths(scene: Scene, org: jnp.ndarray, dirn: jnp.ndarray,
                ray_ids: jnp.ndarray, base_key,
                cfg: IntegratorConfig = IntegratorConfig(),
                raycast_fn=None, sample_mat_fn=None) -> jnp.ndarray:
    """Radiance only; see trace_paths_stats."""
    return trace_paths_stats(scene, org, dirn, ray_ids, base_key, cfg,
                             raycast_fn, sample_mat_fn)[0]
