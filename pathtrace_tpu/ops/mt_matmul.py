"""Möller-Trumbore intersection as matrix products.

The #1 hot op (ray-triangle intersection, the reference's Triangle::hit
inside RayCast, CudaPrimitive.cuh:89-157 + CudaUtil.cuh:93-148) is
reformulated as a matrix product, so all rays against all triangles is
one dense GEMM plus elementwise tests:

With ray origin O and direction D, the four MT quantities are each
*linear* in the 16-dim ray feature vector

    f(O, D) = [1, O, D, D (outer) O]          (1 + 3 + 3 + 9)

because (with N = E1 x E2):
    det                = -D . N                        (linear in D)
    t_num  = t * det   = (O - V0) . N                  (affine in O)
    u_num  = u * det   = (D x E2) . (O - V0)           (bilinear in D,O)
    v_num  = v * det   = ((O - V0) x E1) . D           (bilinear in D,O)

So intersection against ALL T triangles is   F (R,16) @ M (16,T)   per
quantity - four matmuls - followed by elementwise accept tests and a
masked min-reduction. The coefficient matrices are fitted numerically in
float64 on the host by probing the exact scalar formulas at 16 basis rays
(immune to sign/index-convention slips; validated against the direct
Möller-Trumbore in tests).

The backface cull (det < EPS reject) and all accept tests keep the
reference's exact semantics.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from pathtrace_tpu.utils.pytree import pytree_dataclass
from pathtrace_tpu.utils import math3
from pathtrace_tpu.utils.math3 import EPS

NUM_FEATURES = 16


def ray_features(org: jnp.ndarray, dirn: jnp.ndarray) -> jnp.ndarray:
    """(R, 16) feature vector [1, O, D, vec(D outer O)] (f32)."""
    r = org.shape[0]
    ones = jnp.ones((r, 1), org.dtype)
    douter = (dirn[:, :, None] * org[:, None, :]).reshape(r, 9)
    return jnp.concatenate([ones, org, dirn, douter], axis=1)


def _features_np(org: np.ndarray, dirn: np.ndarray) -> np.ndarray:
    r = org.shape[0]
    ones = np.ones((r, 1))
    douter = (dirn[:, :, None] * org[:, None, :]).reshape(r, 9)
    return np.concatenate([ones, org, dirn, douter], axis=1)


def _mt_exact_np(org, dirn, v0, e1, e2):
    """Exact MT numerators for probe fitting, float64.
    org/dirn: (P,3); v0/e1/e2: (T,3). Returns (P,T,4)."""
    d = dirn[:, None, :]
    tvec = org[:, None, :] - v0[None, :, :]
    p = np.cross(d, e2[None, :, :])
    q = np.cross(tvec, e1[None, :, :])
    det = np.einsum("ptk,tk->pt", p, e1)
    t_num = np.einsum("ptk,tk->pt", q, e2)
    u_num = np.einsum("ptk,ptk->pt", p, tvec)
    v_num = np.einsum("ptk,ptk->pt", q, d)
    return np.stack([det, t_num, u_num, v_num], axis=-1)


@pytree_dataclass(static=("num_tris",))
class MTCoeffs:
    """Fitted coefficient matrices, (16, T) each (f32, T padded to 128)."""

    det: jnp.ndarray
    t_num: jnp.ndarray
    u_num: jnp.ndarray
    v_num: jnp.ndarray
    num_tris: int  # unpadded


def build_mt_coeffs(positions: np.ndarray, pad_to: int = 128,
                    scale_hint: float | None = None) -> MTCoeffs:
    """Fit M numerically from (T,3,3) world-space triangle vertices.

    Probe rays are scaled to the scene's extent so the 16x16 solve is
    well-conditioned; the fit is exact (the map is linear) up to f64
    rounding.
    """
    positions = np.asarray(positions, np.float64)
    t = positions.shape[0]
    v0 = positions[:, 0]
    e1 = positions[:, 1] - v0
    e2 = positions[:, 2] - v0

    if scale_hint is None:
        lo = positions.reshape(-1, 3).min(axis=0)
        hi = positions.reshape(-1, 3).max(axis=0)
        scale_hint = float(np.max(hi - lo)) or 1.0

    rng_ = np.random.default_rng(0)
    while True:
        orgs = rng_.normal(size=(NUM_FEATURES, 3)) * scale_hint
        dirs = rng_.normal(size=(NUM_FEATURES, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        f = _features_np(orgs, dirs)  # (16, 16)
        if np.linalg.cond(f) < 1e8:
            break

    vals = _mt_exact_np(orgs, dirs, v0, e1, e2)  # (16, T, 4)
    m = np.linalg.solve(f, vals.reshape(NUM_FEATURES, t * 4))
    m = m.reshape(NUM_FEATURES, t, 4)

    t_pad = max(((t + pad_to - 1) // pad_to) * pad_to, pad_to)
    mp = np.zeros((NUM_FEATURES, t_pad, 4), np.float32)
    mp[:, :t] = m.astype(np.float32)
    # padding tris: det coeffs all zero -> det = 0 < EPS -> culled.
    return MTCoeffs(
        det=mp[..., 0], t_num=mp[..., 1], u_num=mp[..., 2],
        v_num=mp[..., 3], num_tris=t,
    )


def mt_matmul_closest(coeffs: MTCoeffs, org: jnp.ndarray, dirn: jnp.ndarray,
                      t_min: jnp.ndarray, t_max: jnp.ndarray):
    """Closest-hit over all triangles via four matmuls (XLA path).

    Returns (tri_hit (R,), best_t, tri_idx, u, v) with the reference's
    accept semantics: det >= EPS (backface cull), 0 <= u_num <= det,
    v_num >= 0, u_num + v_num <= det, t in [t_min, t_max].
    """
    f = ray_features(org, dirn)
    # Precision.HIGHEST is load-bearing: IEEE f32 products. The default
    # runs TF32 on the GPU (preferred_element_type only fixes the
    # accumulator), and ~1e-3-relative products cannot order the
    # reference scene's light 0.3%-of-t below the ceiling - NEE and
    # emissive hits silently die and renders come out ~4x dark.
    det = jnp.dot(f, coeffs.det, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    t_num = jnp.dot(f, coeffs.t_num, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    u_num = jnp.dot(f, coeffs.u_num, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    v_num = jnp.dot(f, coeffs.v_num, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)

    inv_det = jnp.where(jnp.abs(det) > math3.TINY, 1.0 / det, 0.0)
    t = t_num * inv_det
    valid = (det >= EPS)
    valid &= (t >= t_min[:, None]) & (t <= t_max[:, None])
    valid &= (u_num >= 0.0) & (u_num <= det)
    valid &= (v_num >= 0.0) & (u_num + v_num <= det)

    # payload-carrying min as dense masked reductions (no argmin /
    # take_along_axis), which XLA fuses with the accept tests.
    t_masked = jnp.where(valid, t, jnp.inf)
    best_t = jnp.min(t_masked, axis=1)
    hit = jnp.isfinite(best_t)
    lane = jax.lax.broadcasted_iota(jnp.int32, t_masked.shape, 1)
    is_min = valid & (t_masked <= best_t[:, None])
    idx = jnp.min(jnp.where(is_min, lane, t_masked.shape[1]), axis=1)
    pick = lane == idx[:, None]

    def at_min(x):
        return jnp.sum(jnp.where(pick, x, 0.0), axis=1)

    u = at_min(u_num * inv_det)
    v = at_min(v_num * inv_det)
    idx = jnp.minimum(idx, coeffs.num_tris - 1).astype(jnp.int32)
    return hit, jnp.where(hit, best_t, 0.0), idx, u, v


def raycast_matmul(scene, org: jnp.ndarray, dirn: jnp.ndarray,
                   t_min=None, t_max=None):
    """Drop-in raycast using the matmul intersection (scene.mt)."""
    from pathtrace_tpu.ops.intersect import BIG_T, finalize_hit
    import jax

    assert scene.mt is not None, "scene has no MT coeffs; call Scene.with_mt()"
    # The SELECTION (which prim, hit/miss) is discrete and detached; the
    # hit attributes are then recomputed differentiably at the chosen prim
    # so transport gradients (hit point moving with the sampled direction)
    # flow - matching the reparameterized estimator the FD oracle sees.
    org_d = jax.lax.stop_gradient(org)
    dirn_d = jax.lax.stop_gradient(dirn)
    r = org.shape[0]
    if t_min is None:
        t_min = jnp.zeros((r,), jnp.float32)
    if t_max is None:
        t_max = jnp.full((r,), BIG_T, jnp.float32)
    hit, best_t, idx, u, v = mt_closest_auto(
        scene.mt, org_d, dirn_d, jax.lax.stop_gradient(t_min),
        jax.lax.stop_gradient(t_max))
    from pathtrace_tpu.ops.intersect import mt_gather
    t2, u2, v2, _ = mt_gather(scene.tris, idx, org, dirn, t_min,
                              jnp.full_like(t_max, BIG_T))
    best_t = jnp.where(hit, t2, best_t)
    u = jnp.where(hit, u2, u)
    v = jnp.where(hit, v2, v)
    return finalize_hit(scene, org, dirn, t_min, t_max, hit, best_t, idx, u, v)


def shadow_matmul(scene, org: jnp.ndarray, dirn: jnp.ndarray, t_min, t_max):
    """Matmul shadow raycast -> (hit, prim_id, is_sphere).

    NEE's acceptance only consumes the winner's identity (see
    nee_contribution), so no exact-t recompute is needed - the search t
    is used only to order the winner against the sphere scan.
    """
    from pathtrace_tpu.ops.intersect import finalize_shadow
    import jax

    org_d = jax.lax.stop_gradient(org)
    dirn_d = jax.lax.stop_gradient(dirn)
    hit, best_t, idx, _, _ = mt_closest_auto(
        scene.mt, org_d, dirn_d, jax.lax.stop_gradient(t_min),
        jax.lax.stop_gradient(t_max))
    return finalize_shadow(scene, org_d, dirn_d, t_min, t_max, hit, best_t,
                           idx)


CHUNKED_THRESHOLD = 8192  # full (R, T_pad) products above this are too big


def mt_matmul_closest_chunked(coeffs: MTCoeffs, org: jnp.ndarray,
                              dirn: jnp.ndarray, t_min: jnp.ndarray,
                              t_max: jnp.ndarray, block: int = 4096):
    """Closest-hit via matmuls scanned over triangle-column blocks.

    Same semantics as mt_matmul_closest but peak memory O(R * block)
    instead of O(R * T): a 65k-ray x 82k-tri product is 21.5 GB in f32
    (more than device memory holds); this scans (R, block) products with a running
    payload-carrying min.
    """
    t_pad = coeffs.det.shape[1]
    if t_pad % block != 0:
        pad = ((t_pad + block - 1) // block) * block - t_pad
        pad_m = lambda m: jnp.pad(jnp.asarray(m), ((0, 0), (0, pad)))
        stacked = [pad_m(coeffs.det), pad_m(coeffs.t_num),
                   pad_m(coeffs.u_num), pad_m(coeffs.v_num)]
        t_pad += pad
    else:
        stacked = [jnp.asarray(coeffs.det), jnp.asarray(coeffs.t_num),
                   jnp.asarray(coeffs.u_num), jnp.asarray(coeffs.v_num)]
    nb = t_pad // block
    # (nb, 16, block) scan inputs
    xs = [m.reshape(16, nb, block).transpose(1, 0, 2) for m in stacked]

    f = ray_features(org, dirn)
    r = org.shape[0]

    def body(carry, x):
        best_t, best_idx, best_u, best_v, base = carry
        det_m, tn_m, un_m, vn_m = x
        det = jnp.dot(f, det_m, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
        t_num = jnp.dot(f, tn_m, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
        u_num = jnp.dot(f, un_m, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
        v_num = jnp.dot(f, vn_m, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
        inv_det = jnp.where(jnp.abs(det) > math3.TINY, 1.0 / det, 0.0)
        t = t_num * inv_det
        valid = (det >= EPS)
        valid &= (t >= t_min[:, None]) & (t <= t_max[:, None])
        valid &= (u_num >= 0.0) & (u_num <= det)
        valid &= (v_num >= 0.0) & (u_num + v_num <= det)
        t_masked = jnp.where(valid, t, jnp.inf)
        blk_t = jnp.min(t_masked, axis=1)
        lane = jax.lax.broadcasted_iota(jnp.int32, t_masked.shape, 1)
        is_min = valid & (t_masked <= blk_t[:, None])
        blk_arg = jnp.min(jnp.where(is_min, lane, block), axis=1)
        pick = lane == blk_arg[:, None]
        blk_u = jnp.sum(jnp.where(pick, u_num * inv_det, 0.0), axis=1)
        blk_v = jnp.sum(jnp.where(pick, v_num * inv_det, 0.0), axis=1)
        better = blk_t < best_t
        best_t = jnp.where(better, blk_t, best_t)
        best_idx = jnp.where(better, base + jnp.minimum(blk_arg, block - 1),
                             best_idx)
        best_u = jnp.where(better, blk_u, best_u)
        best_v = jnp.where(better, blk_v, best_v)
        return (best_t, best_idx, best_u, best_v, base + block), None

    carry = (jnp.full((r,), jnp.inf, jnp.float32),
             jnp.zeros((r,), jnp.int32),
             jnp.zeros((r,), jnp.float32),
             jnp.zeros((r,), jnp.float32),
             jnp.zeros((), jnp.int32))
    (best_t, idx, u, v, _), _ = jax.lax.scan(body, carry, tuple(xs))
    hit = jnp.isfinite(best_t)
    idx = jnp.minimum(idx, coeffs.num_tris - 1)
    return hit, jnp.where(hit, best_t, 0.0), idx, u, v


def mt_closest_auto(coeffs: MTCoeffs, org, dirn, t_min, t_max):
    """Full-matrix product for small T, column-block scan for large T."""
    if coeffs.det.shape[1] > CHUNKED_THRESHOLD:
        return mt_matmul_closest_chunked(coeffs, org, dirn, t_min, t_max)
    return mt_matmul_closest(coeffs, org, dirn, t_min, t_max)
