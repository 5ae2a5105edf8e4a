"""Counting-sort ray compaction (the wavefront "expert dispatch" analog).

The north star restructures divergent per-ray control flow into dense
batches via counting-sort compaction by (alive, lobe) keys (SURVEY.md §2
"Path integrator" row). The production paths do not use it: shading is
branchless over the four lobes, and the mesh traversal's dispatch is
sort-free (accel/binned.py build_pair_dispatch_v3). It stays as the
reusable compaction primitive for fixed-capacity queue maintenance.

Implemented as a stable vectorized counting sort: O(R*K) one-hot
histogram + exclusive-scan offsets + rank-within-class, all dense ops
(no data-dependent shapes).
"""

from __future__ import annotations

import jax.numpy as jnp


def counting_sort_perm(keys: jnp.ndarray, num_keys: int) -> jnp.ndarray:
    """Stable permutation `perm` with keys[perm] sorted ascending.

    keys: (R,) int32 in [0, num_keys). Ties keep original order.
    """
    r = keys.shape[0]
    onehot = (keys[:, None] == jnp.arange(num_keys)[None, :])      # (R, K)
    within = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1      # rank in class
    counts = jnp.sum(onehot.astype(jnp.int32), axis=0)             # (K,)
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(counts)[:-1]])           # (K,)
    pos = offsets[keys] + jnp.take_along_axis(
        within, keys[:, None], axis=1)[:, 0]
    perm = jnp.zeros((r,), jnp.int32).at[pos].set(
        jnp.arange(r, dtype=jnp.int32))
    return perm


def inverse_perm(perm: jnp.ndarray) -> jnp.ndarray:
    r = perm.shape[0]
    return jnp.zeros((r,), jnp.int32).at[perm].set(
        jnp.arange(r, dtype=jnp.int32))


def segment_starts(keys_sorted: jnp.ndarray, num_keys: int) -> jnp.ndarray:
    """(K,) start offset of each key segment in a sorted key array."""
    onehot = (keys_sorted[:, None] == jnp.arange(num_keys)[None, :])
    counts = jnp.sum(onehot.astype(jnp.int32), axis=0)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(counts)[:-1]])
