"""Deterministic counter-based RNG for path tracing.

Replaces the reference's curand XORWOW seeded with wall-clock
(pathtracer.cu:70-71, `curand_init(offset + SampleIDX*W*H, clock64(), 0, &s)`),
which is irreproducible by design. Here every random draw is a pure function
of (base seed, logical ray id, bounce iteration, column), using JAX's
counter-based threefry. This gives:

- bit-reproducible renders
- shard-invariance: an N-device render equals a 1-device render because
  streams are keyed by *logical* ray id, not array position
- replayability: the backward pass can regenerate the identical sample
  stream per bounce from counters alone (no stored randomness)

Column layout per (ray, iteration) — one row of `uniforms(...)`:
  0: NEE light pick              (reference: CudaUtil.cuh:235)
  1: NEE area-sample r1          (CudaUtil.cuh:42)
  2: NEE area-sample r2          (CudaUtil.cuh:43)
  3: lobe/fresnel selector       (Bxdf.cuh:182/278/343)
  4: microfacet/hemisphere phi   (Bxdf.cuh:142/26)
  5: microfacet ry / hemi cos    (Bxdf.cuh:143/28)
  6: russian roulette            (CudaUtil.cuh:363)
  7: reserved
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

NUM_COLS = 8

# ---------------------------------------------------------------------------
# Philox4x32-10: counter-based, fully vectorized (dense uint32 ops, no
# per-lane key derivation). Counter = (ray_id, iteration, draw_block, const);
# key = (seed_lo, seed_hi). ~10 rounds of 32x32->64 mul/xor per 4 outputs.
# This replaces jax.random's per-lane threefry fold_in chain (two vmapped
# hashes per lane); philox here fuses into the surrounding kernel.
# ---------------------------------------------------------------------------

_PHILOX_M0 = np.uint32(0xD2511F53)
_PHILOX_M1 = np.uint32(0xCD9E8D57)
_PHILOX_W0 = np.uint32(0x9E3779B9)
_PHILOX_W1 = np.uint32(0xBB67AE85)


def _mulhilo(a, b):
    """32x32 -> (hi, lo) without uint64 (x64 mode stays off): 16-bit limbs."""
    mask = np.uint32(0xFFFF)
    a0, a1 = a & mask, a >> 16
    b0, b1 = b & mask, b >> 16
    lo_lo = a0 * b0
    mid1 = a1 * b0
    mid2 = a0 * b1
    hi_hi = a1 * b1
    carry = ((lo_lo >> 16) + (mid1 & mask) + (mid2 & mask)) >> 16
    hi = hi_hi + (mid1 >> 16) + (mid2 >> 16) + carry
    lo = a * b
    return hi, lo


def _philox_round(c0, c1, c2, c3, k0, k1):
    hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
    hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
    return (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32 keyed hash; all args uint32 arrays (broadcastable)."""
    c0, c1, c2, c3 = (jnp.asarray(x, jnp.uint32) for x in (c0, c1, c2, c3))
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    for _ in range(rounds):
        c0, c1, c2, c3 = _philox_round(c0, c1, c2, c3, k0, k1)
        k0 = k0 + _PHILOX_W0
        k1 = k1 + _PHILOX_W1
    return c0, c1, c2, c3


def _to_unit_float(u: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 in [0, 1): use the top 24 bits."""
    return (u >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
COL_LIGHT_PICK = 0
COL_NEE_R1 = 1
COL_NEE_R2 = 2
COL_LOBE = 3
COL_PHI = 4
COL_RY = 5
COL_RR = 6


def make_key(seed: int) -> jax.Array:
    """Key = uint32[2] philox key derived from the integer seed."""
    s = np.uint32(seed & 0xFFFFFFFF)
    s2 = np.uint32((seed >> 32) & 0xFFFFFFFF) ^ np.uint32(0xA5A5A5A5)
    return jnp.asarray(np.stack([s, s2]))


def iter_key(base_key: jax.Array, tag) -> jax.Array:
    """Derive an independent subkey (e.g. per render pass)."""
    t = jnp.asarray(tag).astype(jnp.uint32)
    c0, c1, _, _ = philox4x32(t, np.uint32(0x5EEDF01D), np.uint32(0),
                              np.uint32(1), base_key[0], base_key[1])
    return jnp.stack([c0, c1])


_STREAM_PATH = np.uint32(0x50415448)    # "PATH": bounce-loop draws
_STREAM_JITTER = np.uint32(0x4A495454)  # "JITT": subpixel jitter


def uniforms(base_key: jax.Array, ray_ids: jnp.ndarray, iteration,
             num: int = NUM_COLS) -> jnp.ndarray:
    """(R, num) uniforms in [0,1), a pure function of (key, ray_id, iteration).

    ray_ids are *logical* ids (sample*npix + pixel), so the stream is
    invariant to how rays are batched or sharded across devices.
    `iteration` may be a scalar (lockstep megakernel) or a per-lane array
    (wavefront: each lane carries its own path-local bounce counter) - the
    same path sees the same stream either way.
    """
    assert num <= 8
    rid = jnp.asarray(ray_ids).astype(jnp.uint32)
    it = jnp.broadcast_to(jnp.asarray(iteration), rid.shape).astype(jnp.uint32)
    outs = []
    for block in range((num + 3) // 4):
        outs.extend(philox4x32(rid, it, jnp.full_like(rid, block),
                               jnp.broadcast_to(_STREAM_PATH, rid.shape),
                               base_key[0], base_key[1]))
    u = jnp.stack(outs[:num], axis=-1)
    return _to_unit_float(u)


def pixel_jitter(base_key: jax.Array, ray_ids: jnp.ndarray) -> jnp.ndarray:
    """(R, 2) subpixel jitter, keyed by logical ray id (GetPixelDirection's
    curand_uniform pair, pathtracer.cu:35-36)."""
    rid = jnp.asarray(ray_ids).astype(jnp.uint32)
    z = jnp.zeros_like(rid)
    c0, c1, _, _ = philox4x32(rid, z, z,
                              jnp.broadcast_to(_STREAM_JITTER, rid.shape),
                              base_key[0], base_key[1])
    return _to_unit_float(jnp.stack([c0, c1], axis=-1))


def randint_from_uniform(u: jnp.ndarray, n) -> jnp.ndarray:
    """Map u in [0,1) to an int in [0, n). Replaces `curand(s) % Nl`."""
    return jnp.minimum((u * n).astype(jnp.int32), n - 1)
