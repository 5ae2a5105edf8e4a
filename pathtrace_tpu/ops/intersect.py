"""Vectorized ray-primitive intersection (dense, SoA in/out).

Replaces the reference's per-thread scalar hit functions:
- Triangle::hit — Möller-Trumbore with backface cull (CudaPrimitive.cuh:89-157)
- Sphere::hit   — analytic quadratic, nearest valid root (CudaPrimitive.cuh:255-303)
- RayCast       — closest-hit over tris then linear sphere scan (CudaUtil.cuh:93-148)

Semantics preserved exactly, including the quirks that shape the estimator:
- backface cull: det < EPS rejects (CudaPrimitive.cuh:99). This is what
  prevents self-intersection of secondary/shadow rays leaving a surface
  (no epsilon offsets needed for NEE in the reference).
- attribute interpolation uses (1-u-v)*A0 + v*A1 + u*A2 — note v weights
  vertex 1 and u weights vertex 2, swapped vs. textbook MT
  (CudaPrimitive.cuh:141-146). Replicated for parity.
- shading normal flipped toward the ray (SetNormal, CudaPrimitive.cuh:41-44).

This module is the brute-force O(R*T) path used for small scenes and as the
oracle for BVH traversal; accel/ provides the BVH'd version.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pathtrace_tpu.models.scene import Material, Scene
from pathtrace_tpu.utils import math3
from pathtrace_tpu.utils.math3 import EPS
from pathtrace_tpu.utils.pytree import pytree_dataclass

BIG_T = 999999.0  # reference RayCast default t_max (CudaUtil.cuh:93)

def closest_masked(t_masked: jnp.ndarray):
    """(best_t, idx, hit) over a (R, N) matrix with inf marking invalid.

    Dense reductions instead of argmin + take_along_axis.
    Ties break to the lowest index, matching argmin.
    """
    import jax
    n = t_masked.shape[1]
    best = jnp.min(t_masked, axis=1)
    hit = jnp.isfinite(best)
    lane = jax.lax.broadcasted_iota(jnp.int32, t_masked.shape, 1)
    finite = jnp.isfinite(t_masked)
    idx = jnp.min(jnp.where(finite & (t_masked <= best[:, None]), lane, n),
                  axis=1)
    return best, jnp.minimum(idx, n - 1).astype(jnp.int32), hit



@pytree_dataclass
class HitRecord:
    """SoA closest-hit result over a ray batch (reference HitResult,
    CudaPrimitive.cuh:25-45, minus the ray itself)."""

    hit: jnp.ndarray         # (R,) bool
    t: jnp.ndarray           # (R,)
    p: jnp.ndarray           # (R, 3)
    normal: jnp.ndarray      # (R, 3) shading normal, flipped toward ray
    tangent: jnp.ndarray     # (R, 3)
    bitangent: jnp.ndarray   # (R, 3)
    front_face: jnp.ndarray  # (R,) bool
    uv: jnp.ndarray          # (R, 2)
    prim_id: jnp.ndarray     # (R,) int32: triangle index, or sphere index
    is_sphere: jnp.ndarray   # (R,) bool
    mat: Material            # gathered per-ray material


def intersect_tris_all(tris, org: jnp.ndarray, dirn: jnp.ndarray,
                       t_min, t_max):
    """All-pairs Möller-Trumbore: returns (t (R,T), valid (R,T), u, v).

    u, v are the reference's *normalized* barycentrics (post invDet), with
    its swapped attribute convention applied later.
    """
    v0 = tris.v0  # (T,3)
    e1 = tris.e1
    e2 = tris.e2
    d = dirn[:, None, :]                      # (R,1,3)
    tvec = org[:, None, :] - v0[None, :, :]   # (R,T,3)
    p = math3.cross(d, e2[None, :, :])        # (R,T,3)
    q = math3.cross(tvec, e1[None, :, :])     # (R,T,3)
    det = math3.dot(p, e1[None, :, :])        # (R,T)
    inv_det = jnp.where(jnp.abs(det) > math3.TINY, 1.0 / det, 0.0)
    t = math3.dot(q, e2[None, :, :]) * inv_det
    u = math3.dot(p, tvec)
    v = math3.dot(q, d)
    valid = (det >= EPS)                      # backface cull (det < EPS reject)
    valid &= (t >= t_min[..., None]) & (t <= t_max[..., None])
    valid &= (u >= 0.0) & (u <= det)
    valid &= (v >= 0.0) & (u + v <= det)
    return t, valid, u * inv_det, v * inv_det


def intersect_spheres_all(spheres, org: jnp.ndarray, dirn: jnp.ndarray,
                          t_min, t_max):
    """All-pairs sphere intersection: (t (R,S), valid (R,S))."""
    oc = org[:, None, :] - spheres.center[None, :, :]   # (R,S,3)
    a = math3.squared_length(dirn)[:, None]             # (R,1); dirs unit => ~1
    half_b = math3.dot(oc, dirn[:, None, :])            # (R,S)
    c = math3.squared_length(oc) - (spheres.radius ** 2)[None, :]
    disc = half_b * half_b - a * c
    has = disc >= 0.0
    sqrtd = math3.safe_sqrt(disc)
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    in0 = (root0 >= t_min[..., None]) & (root0 <= t_max[..., None])
    in1 = (root1 >= t_min[..., None]) & (root1 <= t_max[..., None])
    t = jnp.where(in0, root0, root1)
    valid = has & (in0 | in1)
    return t, valid


def _gather_tri_hit(scene: Scene, org, dirn, t, u, v, idx):
    """Build hit attributes for triangle hits at normalized barycentrics.

    Uses the reference's swapped interpolation weights
    (CudaPrimitive.cuh:141-146): w0=1-u-v weights A0, v weights A1,
    u weights A2.
    """
    tr = scene.tris
    w0 = (1.0 - u - v)[:, None]
    wu = u[:, None]
    wv = v[:, None]
    g = math3.gather_rows

    def interp(a0, a1, a2):
        return w0 * g(a0, idx) + wv * g(a1, idx) + wu * g(a2, idx)

    outward_n = math3.normalize(interp(tr.n0, tr.n1, tr.n2))
    front = math3.dot(dirn, outward_n) < 0.0
    normal = jnp.where(front[:, None], outward_n, -outward_n)
    tangent = math3.normalize(interp(tr.t0, tr.t1, tr.t2))
    bitangent = math3.normalize(interp(tr.b0, tr.b1, tr.b2))
    uv = w0 * g(tr.uv0, idx) + wv * g(tr.uv1, idx) + wu * g(tr.uv2, idx)
    p = org + t[:, None] * dirn
    return p, normal, tangent, bitangent, front, uv


def _gather_sphere_hit(scene: Scene, org, dirn, t, idx):
    sp = scene.spheres
    g = math3.gather_rows
    p = org + t[:, None] * dirn
    outward = (p - g(sp.center, idx)) / jnp.maximum(g(sp.radius, idx)[:, None],
                                                    math3.TINY)
    front = math3.dot(dirn, outward) < 0.0
    normal = jnp.where(front[:, None], outward, -outward)
    # Tangent frame from +Y (reference Sphere::hit, CudaPrimitive.cuh:287-288,
    # "Compute sphere tangent" via cross(+Y, n)).
    up = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], jnp.float32), normal.shape)
    tangent = math3.normalize(math3.cross(up, normal))
    bitangent = math3.cross(normal, tangent)
    uv = jnp.zeros((t.shape[0], 2), jnp.float32)
    return p, normal, tangent, bitangent, front, uv


def mt_gather(tris, pid: jnp.ndarray, org: jnp.ndarray, dirn: jnp.ndarray,
              t_min, t_max):
    """Möller-Trumbore for one gathered triangle per lane.

    pid: (R,) triangle indices (must be in-range; mask invalid lanes
    upstream). Returns (t, u, v, valid) with the reference's backface cull
    and normalized barycentrics.
    """
    v0 = math3.gather_rows(tris.v0, pid)
    e1 = math3.gather_rows(tris.v1, pid) - v0
    e2 = math3.gather_rows(tris.v2, pid) - v0
    tvec = org - v0
    p = math3.cross(dirn, e2)
    q = math3.cross(tvec, e1)
    det = math3.dot(p, e1)
    inv_det = jnp.where(jnp.abs(det) > math3.TINY, 1.0 / det, 0.0)
    t = math3.dot(q, e2) * inv_det
    u = math3.dot(p, tvec)
    v = math3.dot(q, dirn)
    valid = (det >= EPS)
    valid &= (t >= t_min) & (t <= t_max)
    valid &= (u >= 0.0) & (u <= det)
    valid &= (v >= 0.0) & (u + v <= det)
    return t, u * inv_det, v * inv_det, valid


def build_geom_pack(tris) -> np.ndarray:
    """(T, 42) baked per-triangle row [v0 e1 e2 n0 n1 n2 t0 t1 t2 b0 b1 b2
    uv0 uv1 uv2] for the one-gather shading tail (finalize_hit_packed).

    Geometry carries no gradients by scope (material/emission grads only,
    SURVEY.md §7 M5), so baking is exact; materials are concatenated
    in-trace so autodiff reaches the learnable pytree."""
    v0 = np.asarray(tris.v0)
    cols = [v0, np.asarray(tris.v1) - v0, np.asarray(tris.v2) - v0]
    for f in ("n0", "n1", "n2", "t0", "t1", "t2", "b0", "b1", "b2",
              "uv0", "uv1", "uv2"):
        cols.append(np.asarray(getattr(tris, f)))
    return np.concatenate(cols, axis=1).astype(np.float32)


def finalize_hit_packed(scene: Scene, org, dirn, t_min, hit,
                        tri_idx) -> HitRecord:
    """finalize_hit for triangle-only scenes through ONE row gather.

    The generic tail issues ~21 separate (R,)-wide gathers (verts for the
    mt recompute, 12 attribute arrays, 6 material fields). Here the
    per-triangle row is [geom_pack (42) | materials
    (12)], concatenated in-trace (differentiable w.r.t. the material
    pytree: concat + gather VJP is a scatter-add) and gathered ONCE.
    Semantics mirror finalize_hit + mt_gather exactly: swapped u/v
    interpolation weights (CudaPrimitive.cuh:141-146), backface-cull
    recompute at the winner, front-face normal flip."""
    r = org.shape[0]
    mat = scene.mat
    table = jnp.concatenate([
        jnp.asarray(scene.geom_pack), mat.emittance, mat.albedo,
        mat.specular, mat.opacity[:, None], mat.roughness[:, None],
        mat.metallic[:, None]], axis=1)                      # (T, 54)
    safe = jnp.where(hit, tri_idx, 0)
    row = table[safe]                                        # (R, 54)

    v0 = row[:, 0:3]
    e1 = row[:, 3:6]
    e2 = row[:, 6:9]
    tvec = org - v0
    pv = math3.cross(dirn, e2)
    qv = math3.cross(tvec, e1)
    det = math3.dot(pv, e1)
    inv_det = jnp.where(jnp.abs(det) > math3.TINY, 1.0 / det, 0.0)
    t = math3.dot(qv, e2) * inv_det
    u = math3.dot(pv, tvec) * inv_det
    v = math3.dot(qv, dirn) * inv_det

    w0 = (1.0 - u - v)[:, None]
    wu = u[:, None]
    wv = v[:, None]

    def interp(base):
        return (w0 * row[:, base:base + 3] + wv * row[:, base + 3:base + 6]
                + wu * row[:, base + 6:base + 9])

    outward_n = math3.normalize(interp(9))
    front = math3.dot(dirn, outward_n) < 0.0
    normal = jnp.where(front[:, None], outward_n, -outward_n)
    tangent = math3.normalize(interp(18))
    bitangent = math3.normalize(interp(27))
    uv = (w0 * row[:, 36:38] + wv * row[:, 38:40] + wu * row[:, 40:42])
    p = org + t[:, None] * dirn
    matg = Material(emittance=row[:, 42:45], albedo=row[:, 45:48],
                    specular=row[:, 48:51], opacity=row[:, 51],
                    roughness=row[:, 52], metallic=row[:, 53])
    return HitRecord(
        hit=hit, t=jnp.where(hit, t, BIG_T), p=p, normal=normal,
        tangent=tangent, bitangent=bitangent, front_face=front, uv=uv,
        prim_id=tri_idx, is_sphere=jnp.zeros((r,), bool), mat=matg)


def finalize_hit(scene: Scene, org, dirn, t_min, t_max,
                 tri_hit, best_t, tri_idx, tri_u, tri_v) -> HitRecord:
    """Merge the triangle closest-hit with the sphere scan and gather
    shading attributes. Shared tail of the brute-force and BVH raycasts
    (mirrors the sphere loop at CudaUtil.cuh:137-145)."""
    r = org.shape[0]
    sph_hit = jnp.zeros((r,), bool)
    sph_idx = jnp.zeros((r,), jnp.int32)
    sph_t = jnp.full((r,), jnp.inf, jnp.float32)
    best_t = jnp.where(tri_hit, best_t, jnp.inf)
    if scene.num_spheres > 0:
        cur_max = jnp.where(tri_hit, best_t, t_max)
        st, svalid = intersect_spheres_all(scene.spheres, org, dirn, t_min,
                                           cur_max)
        st_masked = jnp.where(svalid, st, jnp.inf)
        sph_t, sph_idx, sph_hit = closest_masked(st_masked)

    use_sphere = sph_hit & (~tri_hit | (sph_t < best_t))
    hit = tri_hit | sph_hit
    t_final = jnp.where(use_sphere, sph_t, jnp.where(tri_hit, best_t, BIG_T))

    # Gather attributes for both primitive types, select per lane.
    if scene.num_tris > 0:
        safe_tri = jnp.where(tri_hit, tri_idx, 0)
        tp, tn, tt, tb, tf, tuv = _gather_tri_hit(
            scene, org, dirn, jnp.where(tri_hit, best_t, 0.0), tri_u, tri_v,
            safe_tri)
        tmat = scene.mat.gather(safe_tri)
    else:
        z3 = jnp.zeros((r, 3), jnp.float32)
        tp = tn = tt = tb = z3
        tf = jnp.zeros((r,), bool)
        tuv = jnp.zeros((r, 2), jnp.float32)
        tmat = Material.make(1).gather(jnp.zeros((r,), jnp.int32))

    if scene.num_spheres > 0:
        safe_sph = jnp.where(sph_hit, sph_idx, 0)
        sp, sn, stt, sb, sf, suv = _gather_sphere_hit(
            scene, org, dirn, jnp.where(sph_hit, sph_t, 0.0), safe_sph)
        smat = scene.spheres.mat.gather(safe_sph)
        sel = use_sphere[:, None]
        p = jnp.where(sel, sp, tp)
        normal = jnp.where(sel, sn, tn)
        tangent = jnp.where(sel, stt, tt)
        bitangent = jnp.where(sel, sb, tb)
        front = jnp.where(use_sphere, sf, tf)
        uv = jnp.where(sel, suv, tuv)
        mat = Material(
            emittance=jnp.where(sel, smat.emittance, tmat.emittance),
            albedo=jnp.where(sel, smat.albedo, tmat.albedo),
            specular=jnp.where(sel, smat.specular, tmat.specular),
            opacity=jnp.where(use_sphere, smat.opacity, tmat.opacity),
            roughness=jnp.where(use_sphere, smat.roughness, tmat.roughness),
            metallic=jnp.where(use_sphere, smat.metallic, tmat.metallic),
        )
        prim_id = jnp.where(use_sphere, sph_idx, tri_idx)
    else:
        p, normal, tangent, bitangent, front, uv = tp, tn, tt, tb, tf, tuv
        mat = tmat
        prim_id = tri_idx

    return HitRecord(
        hit=hit, t=t_final, p=p, normal=normal, tangent=tangent,
        bitangent=bitangent, front_face=front, uv=uv,
        prim_id=prim_id, is_sphere=use_sphere, mat=mat,
    )


def raycast_brute(scene: Scene, org: jnp.ndarray, dirn: jnp.ndarray,
                  t_min=None, t_max=None) -> HitRecord:
    """Closest-hit over the whole scene, brute force O(R*T).

    Mirrors RayCast (CudaUtil.cuh:93-148): closest triangle (here: dense
    argmin instead of the tree walk), then the sphere list scanned against
    the running closest t. Used for small scenes and as the traversal
    oracle in tests.
    """
    r = org.shape[0]
    if t_min is None:
        t_min = jnp.zeros((r,), jnp.float32)
    if t_max is None:
        t_max = jnp.full((r,), BIG_T, jnp.float32)

    best_t = jnp.full((r,), jnp.inf, jnp.float32)
    tri_idx = jnp.zeros((r,), jnp.int32)
    tri_u = jnp.zeros((r,), jnp.float32)
    tri_v = jnp.zeros((r,), jnp.float32)
    tri_hit = jnp.zeros((r,), bool)

    if scene.num_tris > 0:
        t, valid, u, v = intersect_tris_all(scene.tris, org, dirn, t_min,
                                            t_max)
        t_masked = jnp.where(valid, t, jnp.inf)
        best_t, tri_idx, tri_hit = closest_masked(t_masked)
        import jax as _jax
        lane = _jax.lax.broadcasted_iota(jnp.int32, t_masked.shape, 1)
        pick = lane == tri_idx[:, None]
        tri_u = jnp.sum(jnp.where(pick, u, 0.0), axis=1)
        tri_v = jnp.sum(jnp.where(pick, v, 0.0), axis=1)

    return finalize_hit(scene, org, dirn, t_min, t_max,
                        tri_hit, best_t, tri_idx, tri_u, tri_v)


def finalize_shadow(scene: Scene, org, dirn, t_min, t_max,
                    tri_hit, best_t, tri_idx):
    """Minimal closest-hit result for NEE shadow rays:
    (hit, prim_id, is_sphere).

    NEE's visibility test (GetLightColor, CudaUtil.cuh:150-166) only needs
    the IDENTITY of the winning primitive: the ray reaches the sampled
    light iff the winner is that light triangle (see nee_contribution),
    so shadow rays skip hit-point construction, attribute interpolation,
    and the emittance gather entirely.
    """
    r = org.shape[0]
    best_t = jnp.where(tri_hit, best_t, jnp.inf)
    use_sphere = jnp.zeros((r,), bool)
    sph_idx = jnp.zeros((r,), jnp.int32)
    if scene.num_spheres > 0:
        cur_max = jnp.where(tri_hit, best_t, t_max)
        st, svalid = intersect_spheres_all(scene.spheres, org, dirn, t_min,
                                           cur_max)
        st_masked = jnp.where(svalid, st, jnp.inf)
        sph_t, sph_idx, sph_hit = closest_masked(st_masked)
        use_sphere = sph_hit & (~tri_hit | (sph_t < best_t))

    hit = tri_hit | use_sphere
    prim_id = jnp.where(use_sphere, sph_idx, tri_idx)
    return hit, prim_id, use_sphere


def shadow_brute(scene: Scene, org: jnp.ndarray, dirn: jnp.ndarray,
                 t_min, t_max):
    """Brute-force shadow raycast -> (hit, prim_id, is_sphere)."""
    r = org.shape[0]
    best_t = jnp.full((r,), jnp.inf, jnp.float32)
    tri_idx = jnp.zeros((r,), jnp.int32)
    tri_hit = jnp.zeros((r,), bool)
    if scene.num_tris > 0:
        t, valid, _, _ = intersect_tris_all(scene.tris, org, dirn, t_min,
                                            t_max)
        t_masked = jnp.where(valid, t, jnp.inf)
        best_t, tri_idx, tri_hit = closest_masked(t_masked)
    return finalize_shadow(scene, org, dirn, t_min, t_max,
                           tri_hit, jnp.where(tri_hit, best_t, 0.0), tri_idx)
