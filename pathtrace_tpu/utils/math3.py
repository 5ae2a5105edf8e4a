"""SoA 3-vector math on (..., 3) jnp arrays.

Batched replacement for the reference's scalar device vec3 class
(reference: CudaVector.cuh). Everything operates on batched arrays; no
classes, no scalar loops.

All ops are autodiff-safe on masked/degenerate lanes (zero vectors,
grazing angles): divisions and sqrts are clamped away from 0 so neither
the primal nor the cotangent produces NaN on lanes that a `where` later
discards.
"""

from __future__ import annotations

import jax.numpy as jnp

# Matches the reference's EPS (CudaPrimitive.cuh:11); used for the same
# geometric tolerances so estimator semantics line up.
EPS = 1e-4

# Tiny guard for safe division/normalization (not a semantic tolerance).
TINY = 1e-20


def dot(a: jnp.ndarray, b: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def squared_length(v: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    return jnp.sum(v * v, axis=-1, keepdims=keepdims)


def length(v: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(squared_length(v, keepdims=keepdims), TINY))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Safe normalize: returns 0 for (near-)zero vectors instead of NaN.

    The zero vector doubles as the reference's "dead sample" sentinel
    (CudaUtil.cuh:335-338), so 0 -> 0 is load-bearing.
    """
    sq = squared_length(v, keepdims=True)
    return v * jnp.where(sq > TINY, jnp.reciprocal(jnp.sqrt(jnp.maximum(sq, TINY))), 0.0)


def reflect(w: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror of w about n, both pointing away from the surface.

    Same convention as the reference (CudaVector.cuh reflect):
    reflect(w, n) = -w + 2 (n.w) n.
    """
    return -w + 2.0 * dot(n, w, keepdims=True) * n


def refract(w: jnp.ndarray, n: jnp.ndarray, inv_eta: jnp.ndarray) -> jnp.ndarray:
    """Refraction of w (pointing away from surface) through normal n.

    inv_eta is eta_incident/eta_transmitted, broadcastable to (..., 1) or
    scalar per lane (...,). Total internal reflection returns the zero
    vector, matching the reference (CudaVector.cuh refract).
    """
    if inv_eta.ndim == w.ndim - 1:
        inv_eta = inv_eta[..., None]
    cosine = dot(n, w, keepdims=True)
    k = 1.0 + inv_eta * inv_eta * (cosine * cosine - 1.0)
    # double-where keeps the TIR branch's gradient NaN-free (sqrt'(0)=inf
    # would otherwise poison the backward pass through masked lanes)
    k_pos = k > 0.0
    k_safe = jnp.where(k_pos, k, 1.0)
    out = -w * inv_eta + (inv_eta * cosine - jnp.sqrt(k_safe)) * n
    return jnp.where(k_pos, out, 0.0)


def lerp(x: jnp.ndarray, y: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """x*(1-alpha) + y*alpha  (reference: Bxdf.cuh:13-16)."""
    return x * (1.0 - alpha) + y * alpha


def mean3(v: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    """Channel mean with the reference's 0.333333 constant (Bxdf.cuh:18-21)."""
    return jnp.sum(v, axis=-1, keepdims=keepdims) * 0.333333


def max3(v: jnp.ndarray) -> jnp.ndarray:
    """Max RGB component (reference MaxFrom, used by Russian roulette)."""
    return jnp.max(v, axis=-1)


def saturate(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(v, 0.0, 1.0)


def safe_div(a: jnp.ndarray, b: jnp.ndarray, eps: float = TINY) -> jnp.ndarray:
    """a/b with the sign of b preserved and |b| clamped away from 0."""
    return a / jnp.where(jnp.abs(b) > eps, b, jnp.where(b >= 0, eps, -eps))


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt clamped at 0 with a NaN-free gradient.

    Double-where: plain sqrt(max(x,0)) has d/dx = inf at x=0 and its
    backward produces NaN on clamped (x<0) lanes - which poisons whole-batch
    gradients even when the primal is masked later (TIR boundaries in
    fresnel_dielectric, shadowing terms, etc.)."""
    positive = x > 1e-12
    safe = jnp.where(positive, x, 1.0)
    return jnp.where(positive, jnp.sqrt(safe), 0.0)


def safe_rsqrt(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.reciprocal(jnp.sqrt(jnp.maximum(x, TINY)))


def gather_rows(table: jnp.ndarray, idx: jnp.ndarray,
                onehot_threshold: int = 512) -> jnp.ndarray:
    """table[idx] for (N, ...) tables and (R,) int indices.

    For small tables this uses an exact one-hot matmul (0/1 weights); the
    one-hot is CSE'd across multiple gathers sharing the same indices.
    Larger tables use a plain take. Integer tables round-trip through f32 (exact for
    values < 2^24).
    """
    import jax
    n = table.shape[0]
    if n == 0 or n > onehot_threshold:
        return table[idx]
    flat = jnp.asarray(table).reshape(n, -1)
    integer = jnp.issubdtype(flat.dtype, jnp.integer)
    work = flat.astype(jnp.float32) if integer else flat
    onehot = jax.nn.one_hot(idx, n, dtype=jnp.float32)
    # Precision.HIGHEST: IEEE f32 products. The default would run TF32 on
    # the GPU and QUANTIZE the gathered values (material params, light
    # vertices, int indices round-tripped through f32).
    out = jnp.dot(onehot, work, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    if integer:
        out = jnp.round(out).astype(flat.dtype)
    return out.reshape(idx.shape + table.shape[1:])
