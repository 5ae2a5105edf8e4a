"""Pair-block search: the inner loop of the KD-cell mesh traversal.

The v3 dispatch (accel/binned.py) groups (ray, cell) pairs into blocks of
`block_pairs` pairs that all belong to one cell. For every pair, the
search finds the closest triangle of that cell the ray hits, using the
Möller-Trumbore coefficient form of ops/mt_matmul.py: the four MT
quantities (det, t*det, u*det, v*det) are the ray's 16 features times
the cell's (16, C) coefficient tile, one tile per quantity.

Two implementations share one contract and one accept test (_accept):

- pair_search_plain: jnp. It gathers each block's tiles and forms every
  product with one einsum, so XLA writes (nb, 4, B, C) f32 products to
  device memory and reads them back for the accept tests.
- pair_search_kernel: Pallas through Triton. One program per block loads
  its cell id, walks the cell's members in chunks of CHUNK triangles and
  keeps the products, the accept tests and the running per-pair winner
  in registers. The walk stops at the cell's member count.

pair_search picks the implementation by platform in one place.

Precision: every product runs in IEEE f32 (Precision.HIGHEST, which
Triton lowers to FMA and XLA to an f32 GEMM). Never the default: Pallas
through Triton and cuBLAS would use TF32, whose ~1e-3 relative products
cannot order geometry 0.3% apart in t and turn renders several times too
dark.

Reference parity: the accept semantics are RayCast's closest-hit contract
(CudaUtil.cuh:93-148) with backface cull det >= EPS
(CudaPrimitive.cuh:99), the same tests as ops/mt_matmul.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pathtrace_tpu.utils.math3 import EPS, TINY

NUM_FEATURES = 16
NUM_QUANTITIES = 4          # det, t_num, u_num, v_num
PRECISION = jax.lax.Precision.HIGHEST
# tuned on an H100 over block pairs 32/64/128 x chunk 16/32/64 x 4/8
# warps (PERF.md): 64 pairs (accel/binned.BLOCK_PAIRS), 32-triangle
# chunks, 8 warps
CHUNK = 32                  # triangles per inner step of the kernel
NUM_WARPS = 8


def _accept(det, t_num, u_num, v_num, tmin, tmax):
    """t where the pair's ray hits the triangle, +inf elsewhere."""
    inv_det = jnp.where(jnp.abs(det) > TINY, 1.0 / det, 0.0)
    t = t_num * inv_det
    valid = det >= EPS
    valid &= (t >= tmin) & (t <= tmax)
    valid &= (u_num >= 0.0) & (u_num <= det)
    valid &= (v_num >= 0.0) & (u_num + v_num <= det)
    return jnp.where(valid, t, jnp.inf)


def pair_search_plain(coeffs, block_cell, block_count, feats, tmin, tmax,
                      *, block_pairs: int):
    """Closest hit per pair slot, in jnp.

    coeffs: (M, 4, 16, C) cell tiles (ClusterArrays.coeffs).
    block_cell: (nb,) i32 cell of each block.
    block_count: (nb,) i32 members to search per block (the cell's member
    count; 0 for the padding blocks at the end of the slot budget).
    feats: (cap, 16) per-slot ray features; tmin/tmax: (cap,).
    Returns (t (cap,) f32, +inf where nothing is hit; member (cap,) i32,
    the winner's slot within its cell, lowest on ties, 0 on a miss).
    """
    nb = block_cell.shape[0]
    b = block_pairs
    c = coeffs.shape[-1]
    f = feats.reshape(nb, b, NUM_FEATURES)
    prods = jnp.einsum("nbf,nqfc->qnbc", f, coeffs[block_cell],
                       precision=PRECISION,
                       preferred_element_type=jnp.float32)
    tm = _accept(prods[0], prods[1], prods[2], prods[3],
                 tmin.reshape(nb, b, 1), tmax.reshape(nb, b, 1))
    lane = jax.lax.broadcasted_iota(jnp.int32, tm.shape, 2)
    tm = jnp.where(lane < block_count[:, None, None], tm, jnp.inf)
    best = jnp.min(tm, axis=2)
    arg = jnp.min(jnp.where(tm <= best[..., None], lane, c), axis=2)
    return best.reshape(-1), arg.reshape(-1)


def _pair_kernel(cell_ref, count_ref, f_ref, tmin_ref, tmax_ref, coef_ref,
                 t_ref, arg_ref, *, chunk):
    """One block: B pairs against the members of one cell."""
    cell = cell_ref[0]
    count = count_ref[0]
    f = f_ref[...]                                     # (B, 16)
    tmin = tmin_ref[...][:, None]
    tmax = tmax_ref[...][:, None]
    rows0 = cell * (NUM_QUANTITIES * NUM_FEATURES)

    def body(j, carry):
        best, arg = carry
        cols = pl.ds(pl.multiple_of(j * chunk, chunk), chunk)

        def product(q):
            rows = pl.ds(rows0 + q * NUM_FEATURES, NUM_FEATURES)
            return pl.dot(f, coef_ref[rows, cols], precision=PRECISION)

        tm = _accept(product(0), product(1), product(2), product(3),
                     tmin, tmax)                       # (B, chunk)
        lane = j * chunk + jax.lax.broadcasted_iota(jnp.int32, tm.shape, 1)
        tm = jnp.where(lane < count, tm, jnp.inf)
        m = jnp.min(tm, axis=1)
        a = jnp.min(jnp.where(tm <= m[:, None], lane,
                              jnp.iinfo(jnp.int32).max), axis=1)
        better = m < best
        return jnp.where(better, m, best), jnp.where(better, a, arg)

    b = f.shape[0]
    init = (jnp.full((b,), jnp.inf, jnp.float32), jnp.zeros((b,), jnp.int32))
    best, arg = jax.lax.fori_loop(0, pl.cdiv(count, chunk), body, init)
    t_ref[...] = best
    arg_ref[...] = arg


@functools.partial(jax.jit, static_argnames=("block_pairs", "chunk",
                                             "interpret"))
def pair_search_kernel(coeffs, block_cell, block_count, feats, tmin, tmax,
                       *, block_pairs: int, chunk: int = CHUNK,
                       interpret: bool = False):
    """pair_search_plain's contract as one Pallas-Triton program per
    block, walking ceil(block_count / chunk) chunks of the cell."""
    m, _, _, c = coeffs.shape
    nb = block_cell.shape[0]
    b = block_pairs
    chunk = min(chunk, c)
    assert c % chunk == 0, (c, chunk)
    assert b >= 16 and b & (b - 1) == 0, b
    cap = nb * b
    per_block = pl.BlockSpec((1,), lambda i: (i,))
    per_pair = pl.BlockSpec((b,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(_pair_kernel, chunk=chunk),
        grid=(nb,),
        in_specs=[per_block, per_block,
                  pl.BlockSpec((b, NUM_FEATURES), lambda i: (i, 0)),
                  per_pair, per_pair, pl.no_block_spec],
        out_specs=[per_pair, per_pair],
        out_shape=[jax.ShapeDtypeStruct((cap,), jnp.float32),
                   jax.ShapeDtypeStruct((cap,), jnp.int32)],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        backend="triton",
        interpret=interpret,
        name="pair_block_search",
    )(block_cell, block_count, feats, tmin, tmax,
      coeffs.reshape(m * NUM_QUANTITIES * NUM_FEATURES, c))


# the one place an implementation is chosen, by platform
IMPLEMENTATIONS = {"gpu": pair_search_kernel, "cpu": pair_search_plain}


def pair_search(coeffs, block_cell, block_count, feats, tmin, tmax, *,
                block_pairs: int):
    """The platform's implementation: the kernel on the GPU, the plain
    search on the CPU. Any other platform is an error."""
    platform = jax.default_backend()
    if platform not in IMPLEMENTATIONS:
        raise NotImplementedError(
            f"no pair-block search for platform {platform!r}")
    return IMPLEMENTATIONS[platform](coeffs, block_cell, block_count, feats,
                                     tmin, tmax, block_pairs=block_pairs)
