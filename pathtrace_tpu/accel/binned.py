"""Two-level binned traversal: the BVH walk for large scenes.

The reference walks its BVH with a per-thread stack (CudaUtil.cuh:93-148).
Here traversal is restructured into dense batched work:

1. Build: cut the scene into "clusters" of <= C triangles. Per cluster:
   an AABB and a (4, 16, C) block of MT-matmul coefficients
   (ops/mt_matmul.py), one (16, C) tile per MT quantity.
2. Query, stage 1 (cull): test every ray against every cluster AABB -
   one dense (R, M) slab test.
3. Query, stage 2 (dispatch): form (ray, cluster) pairs, group them by
   cluster, pad each cluster's run to the pair-block size B, and search
   each pair-block against ONE cluster's coefficient tiles.
4. Reduce: scatter-min the per-pair closest hits back to rays.

Work drops from O(R*T) (brute) to O(R*M + P*C) with P ~ R * clusters
per ray.

Two generations live here:

- v1 (raycast_binned / raycast_binned_closest): XLA-only, BVH-subtree
  clusters, sorted-key dispatch + einsum group loop, with a per-ray cap
  of k_max clusters (rays over it fall back to brute force). The routed
  backend for with_binned() scenes.
- v3 (raycast_binned_v3 / shadow_binned_v3, the production mesh path):
  KD cells (accel/kdgrid.py), a scatter-free dispatch (arithmetic slot
  inversion over per-panel popcount prefixes), no k_max, the pair-block
  search of ops/pallas/pair_kernel.py and ONE packed scatter-min reduce.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from pathtrace_tpu.accel.bvh import BVHArrays
from pathtrace_tpu.utils.pytree import pytree_dataclass
from pathtrace_tpu.utils.math3 import EPS


@pytree_dataclass(static=("num_clusters", "cluster_cap"))
class ClusterArrays:
    """Flat cluster table + per-cluster MT coefficient tiles."""

    bmin: jnp.ndarray        # (M, 3)
    bmax: jnp.ndarray        # (M, 3)
    prim_start: jnp.ndarray  # (M,) into the (reordered) triangle arrays
    prim_count: jnp.ndarray  # (M,)
    coeffs: jnp.ndarray      # (M, 4, 16, C): det, t_num, u_num, v_num
    num_clusters: int
    cluster_cap: int         # C
    # KD cells only (accel/kdgrid.py): member slot -> ORIGINAL tri id.
    # None for BVH-subtree clusters (member order = reordered tris).
    dup_map: jnp.ndarray = None


def _subtree_prim_ranges(bvh: BVHArrays):
    """Per-node contiguous prim range [start, end) via reverse pre-order."""
    n = bvh.num_nodes
    next_miss = np.asarray(bvh.next_miss)
    prim_start = np.asarray(bvh.prim_start)
    prim_count = np.asarray(bvh.prim_count)
    start = np.empty(n, np.int64)
    end = np.empty(n, np.int64)
    for i in range(n - 1, -1, -1):
        if prim_start[i] >= 0:
            start[i] = prim_start[i]
            end[i] = prim_start[i] + prim_count[i]
        else:
            left = i + 1
            right = next_miss[left]
            start[i] = start[left]
            end[i] = end[right]
            assert end[left] == start[right], "subtree prims not contiguous"
    return start, end


def build_clusters(bvh: BVHArrays, positions_reordered: np.ndarray,
                   max_tris: int = 128) -> ClusterArrays:
    """Cut the BVH into <=max_tris subtrees and build coefficient tiles.

    positions_reordered: (T, 3, 3) in the BVH's leaf-contiguous order.
    """
    from pathtrace_tpu.ops.mt_matmul import build_mt_coeffs

    start, end = _subtree_prim_ranges(bvh)
    bmin = np.asarray(bvh.bmin)
    bmax = np.asarray(bvh.bmax)
    next_miss = np.asarray(bvh.next_miss)
    prim_start = np.asarray(bvh.prim_start)

    clusters = []
    stack = [0]
    while stack:
        i = stack.pop()
        cnt = end[i] - start[i]
        if cnt <= max_tris or prim_start[i] >= 0:
            clusters.append(i)
        else:
            left = i + 1
            right = next_miss[left]
            stack.append(right)
            stack.append(left)

    m = len(clusters)
    c = max_tris
    cl_bmin = bmin[clusters]
    cl_bmax = bmax[clusters]
    cl_start = start[np.asarray(clusters)]
    cl_count = (end - start)[np.asarray(clusters)]

    # coefficient tiles: fit once over all tris, slice per cluster, pad.
    # padding slots keep zero det coeffs -> det = 0 < EPS -> culled.
    full = build_mt_coeffs(positions_reordered, pad_to=1)
    tiles = coefficient_tiles(full, cl_start, cl_count, c)

    return ClusterArrays(
        bmin=cl_bmin, bmax=cl_bmax,
        prim_start=cl_start.astype(np.int32),
        prim_count=cl_count.astype(np.int32),
        coeffs=tiles,
        num_clusters=m, cluster_cap=c,
    )


def coefficient_tiles(full, starts, counts, c: int) -> np.ndarray:
    """(M, 4, 16, C) per-cluster tiles sliced from all-triangle MTCoeffs.
    Padding slots keep zero det coefficients -> det = 0 < EPS -> culled."""
    stacked = np.stack([np.asarray(full.det), np.asarray(full.t_num),
                        np.asarray(full.u_num), np.asarray(full.v_num)])
    tiles = np.zeros((len(starts), 4, 16, c), np.float32)
    for k, (s, n) in enumerate(zip(starts, counts)):
        tiles[k, :, :, :n] = stacked[:, :, s:s + n]
    return tiles


def _slab_all(org, inv_d, bmin, bmax, t_min, t_max):
    """(R, M) slab test + entry t (reference-robust, accel/traverse.py)."""
    t0 = (bmin[None, :, :] - org[:, None, :]) * inv_d[:, None, :]
    t1 = (bmax[None, :, :] - org[:, None, :]) * inv_d[:, None, :]
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    tnear = jnp.maximum(jnp.max(tlo, axis=-1), t_min[:, None])
    tfar = jnp.minimum(jnp.min(thi, axis=-1), t_max[:, None]) * 1.00000024
    return tnear <= tfar, tnear


def raycast_binned_closest(clusters: ClusterArrays, org, dirn, t_min, t_max,
                           k_max: int = 48):
    """Closest-hit (tri_hit, t, global_tri_idx, u, v, overflow).

    overflow: (R,) bool - ray hit more than k_max cluster AABBs (its
    result may be wrong; caller patches those rays via fallback).
    """
    from pathtrace_tpu.accel.traverse import safe_inv_dir
    from pathtrace_tpu.ops.mt_matmul import ray_features
    from pathtrace_tpu.utils import math3

    r = org.shape[0]
    m = clusters.num_clusters
    c = clusters.cluster_cap
    k_max = min(k_max, m)

    inv_d = safe_inv_dir(dirn)
    hit_m, tnear = _slab_all(org, inv_d, clusters.bmin, clusters.bmax,
                             t_min, t_max)
    num_hit = jnp.sum(hit_m, axis=1)
    overflow = num_hit > k_max

    # K nearest hit clusters per ray
    tnear_masked = jnp.where(hit_m, tnear, jnp.inf)
    neg_top, top_idx = jax.lax.top_k(-tnear_masked, k_max)   # (R, K)
    pair_valid = jnp.isfinite(-neg_top)

    # Pairs sorted by cluster id without argsort or permutation gathers:
    # 1. pack (cluster, ray) into ONE uint32 key and jnp.sort it - no
    #    argsort, no permutation gathers (invalid pairs get id m, last);
    # 2. run boundaries via searchsorted with m+1 queries (not R*K);
    # 3. pad-to-block offsets propagated along runs with a cummax scan;
    # 4. one sorted-unique-index store scatter builds the padded slots.
    assert m < (1 << 10) and r <= (1 << 22), (m, r)
    pair_ray0 = jax.lax.broadcasted_iota(jnp.uint32, (r, k_max), 0)
    keys = ((jnp.where(pair_valid, top_idx, m).astype(jnp.uint32) << 22)
            | pair_ray0).reshape(-1)
    keys = jnp.sort(keys)
    pair_cluster = (keys >> 22).astype(jnp.int32)
    pair_ray = (keys & jnp.uint32((1 << 22) - 1)).astype(jnp.int32)
    p = pair_ray.shape[0]

    b = c  # pair-block size = cluster capacity (keeps matmuls square-ish)
    starts = jnp.searchsorted(pair_cluster,
                              jnp.arange(m + 2, dtype=jnp.int32))
    counts = jnp.diff(starts)                        # (m+1,)
    padded = ((counts + b - 1) // b) * b
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(padded)[:-1]])
    # cumulative padding inserted BEFORE each cluster's run; broadcast
    # down each run by a running max (it is non-decreasing), seeded at
    # the run starts by an (m+1)-element scatter
    cum_pad_before = offsets - starts[:m + 1]
    pad_seed = jnp.zeros((p + 1,), jnp.int32).at[starts[:m + 1]].max(
        jnp.maximum(cum_pad_before, 0))[:p]
    slot = (jnp.arange(p, dtype=jnp.int32)
            + jax.lax.cummax(pad_seed))

    cap = p + (m + 1) * (b - 1) + b
    cap = ((cap + b - 1) // b) * b
    slot_ray = jnp.full((cap,), -1, jnp.int32).at[slot].set(
        pair_ray, unique_indices=True, indices_are_sorted=True)
    nb = cap // b
    # block -> cluster: blocks of cluster m' span
    # [offsets[m']//b, offsets[m']//b + padded[m']//b)
    block_ids = jnp.arange(nb, dtype=jnp.int32)
    cum_pad_blocks = jnp.cumsum(padded // b)
    block_cluster = jnp.searchsorted(cum_pad_blocks, block_ids,
                                     side="right").astype(jnp.int32)
    block_cluster = jnp.minimum(block_cluster, m)  # trailing padding

    # gather features + coefficient tiles per block, batched matmuls
    # looped over groups of blocks: the full (NB, 4, B, C) product is
    # ~1.3 GB at 65k rays; groups bound it to ~150 MB.
    f = ray_features(org, dirn)                      # (R, 16)
    group = 512
    ng = (nb + group - 1) // group
    pad_blocks = ng * group - nb
    slot_ray_b = slot_ray.reshape(nb, b)
    if pad_blocks:
        slot_ray_b = jnp.pad(slot_ray_b, ((0, pad_blocks), (0, 0)),
                             constant_values=-1)
        block_cluster = jnp.pad(block_cluster, (0, pad_blocks),
                                constant_values=m)
    coeffs_all = jnp.asarray(clusters.coeffs)
    prim_start_all = jnp.asarray(clusters.prim_start)

    def group_body(_, x):
        sl_ray, bc = x                               # (G, B), (G,)
        safe_ray = jnp.maximum(sl_ray, 0)
        f_pairs = f[safe_ray]                        # (G, B, 16)
        safe_cluster = jnp.minimum(bc, m - 1)
        tiles = coeffs_all[safe_cluster]             # (G, 4, 16, C)
        # HIGHEST: IEEE f32 products. The default would run TF32 on the
        # GPU, which breaks the accept tests' t-ordering.
        prods = jnp.einsum("nbf,nqfc->qnbc", f_pairs, tiles,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
        det, t_num, u_num, v_num = prods

        inv_det = jnp.where(jnp.abs(det) > math3.TINY, 1.0 / det, 0.0)
        t = t_num * inv_det
        tmin_p = t_min[safe_ray][..., None]
        tmax_p = t_max[safe_ray][..., None]
        live = (sl_ray >= 0)[..., None] & (bc < m)[:, None, None]
        valid = live & (det >= EPS)
        valid &= (t >= tmin_p) & (t <= tmax_p)
        valid &= (u_num >= 0.0) & (u_num <= det)
        valid &= (v_num >= 0.0) & (u_num + v_num <= det)

        t_masked = jnp.where(valid, t, jnp.inf)
        g_best_t = jnp.min(t_masked, axis=2)                   # (G, B)
        lane = jax.lax.broadcasted_iota(jnp.int32, t_masked.shape, 2)
        lane_masked = jnp.where(t_masked <= g_best_t[..., None], lane, c)
        lane_masked = jnp.where(valid, lane_masked, c)
        g_arg = jnp.min(lane_masked, axis=2)                   # (G, B)
        pick = lane == g_arg[..., None]
        g_u = jnp.sum(jnp.where(pick, u_num * inv_det, 0.0), axis=2)
        g_v = jnp.sum(jnp.where(pick, v_num * inv_det, 0.0), axis=2)
        g_tri = (prim_start_all[safe_cluster][:, None]
                 + jnp.minimum(g_arg, c - 1))
        return None, (g_best_t, g_u, g_v, g_tri)

    # only blocks belonging to REAL clusters (< m) need processing: the
    # invalid-pair run (cluster id m: top_k slots beyond a ray's actual
    # AABB hits) sorts last, so the loop bound is dynamic - the product
    # work tracks the number of VALID pairs (~R * avg clusters per ray), not
    # the static R * k_max pair capacity.
    nb_real = cum_pad_blocks[m - 1]
    ng_real = (nb_real + group - 1) // group
    outs0 = (jnp.full((ng * group, b), jnp.inf, jnp.float32),
             jnp.zeros((ng * group, b), jnp.float32),
             jnp.zeros((ng * group, b), jnp.float32),
             jnp.zeros((ng * group, b), jnp.int32))

    def group_loop(g, outs):
        s = g * group
        sl_ray = jax.lax.dynamic_slice_in_dim(slot_ray_b, s, group)
        bc = jax.lax.dynamic_slice_in_dim(block_cluster, s, group)
        _, (g_t, g_u, g_v, g_tri) = group_body(None, (sl_ray, bc))
        return tuple(
            jax.lax.dynamic_update_slice_in_dim(o, val, s, 0)
            for o, val in zip(outs, (g_t, g_u, g_v, g_tri)))

    pair_best_t, pair_u, pair_v, pair_tri = jax.lax.fori_loop(
        0, ng_real, group_loop, outs0)
    pair_best_t = pair_best_t[:nb]
    pair_u = pair_u[:nb]
    pair_v = pair_v[:nb]
    pair_tri = pair_tri[:nb]
    slot_ray = slot_ray_b[:nb].reshape(-1)

    # scatter-min back to rays
    flat_ray = jnp.maximum(slot_ray, 0)
    flat_t = pair_best_t.reshape(-1)
    flat_t = jnp.where(slot_ray >= 0, flat_t, jnp.inf)
    best_t = jnp.full((r,), jnp.inf, jnp.float32).at[flat_ray].min(flat_t)

    # winner = lowest flat index among pairs matching the ray's best t
    flat_pos = jnp.arange(cap, dtype=jnp.int32)
    is_winner = (flat_t == best_t[flat_ray]) & jnp.isfinite(flat_t)
    winner_pos = jnp.full((r,), cap, jnp.int32).at[flat_ray].min(
        jnp.where(is_winner, flat_pos, cap))
    hit = jnp.isfinite(best_t)
    wp = jnp.minimum(winner_pos, cap - 1)
    u = pair_u.reshape(-1)[wp]
    v = pair_v.reshape(-1)[wp]
    tri = pair_tri.reshape(-1)[wp]
    return (hit, jnp.where(hit, best_t, 0.0), tri.astype(jnp.int32), u, v,
            overflow)


# ---------------------------------------------------------------------------
# v3: arithmetic slot inversion + packed scatter-min reduce
# ---------------------------------------------------------------------------
#
#   1. slot_ray is computed ARITHMETICALLY, not scattered: slot s in
#      cluster c's run at rank j names the (j+1)-th ray hitting c, i.e.
#      the (j+1)-th set bit of column c of the hit matrix. With the hit
#      matrix bit-packed per column into 512-row panels (16 u32 words)
#      and per-(panel, column) popcount prefix sums, the rank->ray map is
#      a panel search (dense compare-reduce), ONE (cap, 16) word-row
#      gather, and a 5-step in-word popcount binary search.
#   2. there is NO k_max: every (ray, cell) crossing gets a slot. The
#      only overflow is the static global slot budget (the cap);
#      exceeded runs mark exactly the affected rays (those crossing a
#      truncated cluster) for the capacity-bounded repair.
#   3. the per-ray reduce is ONE scatter-min of a packed 32-bit key
#      [quantized t | original tri id] over the slot axis. t is
#      quantized to a rebased-exponent log code (monotone for
#      t in [2^-10, 2^22]); the winner's exact t/u/v are recomputed
#      differentiably by the caller's mt_gather tail, so quantization
#      only influences WHICH of two triangles within ~2^-mant relative t
#      wins - ambiguous geometry at that separation. The tri budget
#      fixes the split: gid_bits = ceil(log2(T)), t gets 32 - gid_bits
#      (blob82k: 17 gid bits -> 5 exp + 10 mantissa, 1e-3 relative).
#
# Reference parity: same closest-hit contract as RayCast
# (CudaUtil.cuh:93-148); the dispatch itself has no reference analog.

_PANEL = 512           # rays per popcount panel (16 u32 words)
_T_EXP_BASE = 117      # biased exponent of 2^-10; t below collapses


def _key_bits(num_dup: int):
    """(gid_bits, exp_bits=5, mant_bits) split of the 32-bit reduce key."""
    gid_bits = max(1, int(np.ceil(np.log2(max(num_dup, 2)))))
    assert gid_bits <= 22, f"scene too large for packed reduce: {num_dup}"
    mant_bits = 32 - gid_bits - 5
    return gid_bits, mant_bits


def build_pair_dispatch_v3(clusters: ClusterArrays, hit_m, block_pairs: int):
    """Hit mask -> cluster-grouped pair dispatch, scatter- and peel-free.

    Returns a dict:
      slot_ray    (cap,) i32   ray id per pair slot (clamped safe; dead
                               slots flagged by `live`, not by -1)
      live        (cap,) bool  slot holds a real (ray, cluster) pair
      block_cluster (nb,) i32  cluster per block, clamped to [0, M)
      block_prim_start (nb,) i32  cluster's prim base, -1 = padding block
      block_count (nb,) i32    cluster's member count, 0 = padding block
      overflow    (R,) bool    ray crossed a cluster whose run was
                               truncated by the slot cap (repair needed)
    """
    r0, m = hit_m.shape
    b = block_pairs
    # Counted on the blob82k mix (camera / bounce / NEE shadow batches at
    # 65k lanes): mean cell membership ~2.0-2.4 per ray, max 2.73R, so
    # 2.75R + M*b covers every batch seen. Batches that overflow the
    # budget mark exactly the affected rays for the capacity-bounded
    # repair - correct at any budget.
    cap_budget = (11 * r0) // 4 + m * b
    cap = (cap_budget // b) * b
    r = -(-r0 // _PANEL) * _PANEL
    if r != r0:
        hit_m = jnp.pad(hit_m, ((0, r - r0), (0, 0)))
    p_cnt = r // _PANEL
    wpp = _PANEL // 32                                # words per panel

    hf = hit_m.astype(jnp.float32)
    pc_panel = hf.reshape(p_cnt, _PANEL, m).sum(axis=1)          # (P, M)
    counts = pc_panel.sum(axis=0).astype(jnp.int32)              # (M,)
    base_panel = (jnp.cumsum(pc_panel, axis=0)
                  - pc_panel).astype(jnp.int32)                  # excl (P, M)

    padded = ((counts + b - 1) // b) * b
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(padded)[:-1]])

    # column bitmask words: (M * P, wpp) u32, row-gatherable by (c, p)
    bits = hit_m.T.reshape(m, p_cnt, wpp, 32)
    shifts = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(bits.astype(jnp.uint32) * shifts,
                    axis=-1).reshape(m * p_cnt, wpp)

    nb = cap // b
    block_ids = jnp.arange(nb, dtype=jnp.int32)
    cum_pad_blocks = jnp.cumsum(padded // b)
    block_cluster = jnp.searchsorted(cum_pad_blocks, block_ids,
                                     side="right").astype(jnp.int32)
    is_pad_block = block_cluster >= m
    block_cluster = jnp.minimum(block_cluster, m - 1)
    ps = jnp.asarray(clusters.prim_start)
    block_prim_start = jnp.where(is_pad_block, -1, ps[block_cluster])
    block_count = jnp.where(is_pad_block, 0,
                            jnp.asarray(clusters.prim_count)[block_cluster])

    # per-slot rank within its cluster's run (all (nb,)-table gathers:
    # thousands of elements, negligible; per-slot math is dense)
    blk_off = offsets[block_cluster]                             # (nb,)
    blk_cnt = counts[block_cluster]
    lane = jnp.arange(b, dtype=jnp.int32)
    j = (block_ids[:, None] * b + lane[None, :]
         - blk_off[:, None])                                     # (nb, B)
    live = (j < blk_cnt[:, None]) & ~is_pad_block[:, None]
    j = jnp.clip(j, 0, r - 1)

    # panel holding the (j+1)-th set bit: largest p with base[p, c] <= j
    bp_rows = base_panel.T[block_cluster]                        # (nb, P)
    le = bp_rows[:, None, :] <= j[:, :, None]                    # (nb,B,P)
    p_of = jnp.sum(le, axis=-1).astype(jnp.int32) - 1
    base_sel = jnp.max(jnp.where(le, bp_rows[:, None, :], 0), axis=-1)
    jp = j - base_sel                                            # in-panel

    # the one real gather: this slot's 16 panel words
    row_idx = (block_cluster[:, None] * p_cnt + p_of).reshape(-1)
    wrows = words[row_idx]                                       # (cap,wpp)
    pcw = jax.lax.population_count(wrows).astype(jnp.int32)
    cum_incl = jnp.cumsum(pcw, axis=1)
    jp_f = jp.reshape(-1)
    w_sel = jnp.sum((cum_incl <= jp_f[:, None]).astype(jnp.int32),
                    axis=1)
    w_sel = jnp.minimum(w_sel, wpp - 1)
    iota_w = jnp.arange(wpp, dtype=jnp.int32)
    pick = iota_w[None, :] == w_sel[:, None]
    base_w = jnp.sum(jnp.where(pick, cum_incl - pcw, 0), axis=1)
    word_val = jnp.sum(jnp.where(pick, wrows, jnp.uint32(0)), axis=1,
                       dtype=jnp.uint32)
    jj = jp_f - base_w                                           # (cap,)

    # index of the (jj+1)-th set bit: popcount binary search, 5 rounds
    pos = jnp.zeros_like(jj)
    for width in (16, 8, 4, 2, 1):
        lmask = (jnp.uint32(1) << (pos + width).astype(jnp.uint32)) \
            - jnp.uint32(1)
        cnt = jax.lax.population_count(word_val & lmask).astype(jnp.int32)
        pos = pos + jnp.where(cnt <= jj, width, 0)

    ray = (p_of.reshape(-1) * _PANEL + w_sel * 32 + pos)
    slot_ray = jnp.clip(ray, 0, r0 - 1)

    bad_col = (offsets + padded) > cap                           # (M,)
    overflow = jnp.any(hit_m[:r0] & bad_col[None, :], axis=1)
    return dict(slot_ray=slot_ray, live=live.reshape(-1),
                block_cluster=block_cluster,
                block_prim_start=block_prim_start, block_count=block_count,
                overflow=overflow)


BLOCK_PAIRS = 64   # pairs per block: a power of two for the kernel


def pair_inputs_v3(clusters: ClusterArrays, org, dirn, t_min, t_max,
                   block_pairs: int):
    """Cull + dispatch + per-slot rows: (disp, feats (cap, 16),
    tmin (cap,), tmax (cap,)) for the pair-block search."""
    from pathtrace_tpu.accel.traverse import safe_inv_dir
    from pathtrace_tpu.ops.mt_matmul import ray_features

    assert clusters.dup_map is not None, \
        "v3 requires KD cells (non-overlapping, dup_map)"
    hit_m, _ = _slab_all(org, safe_inv_dir(dirn), clusters.bmin,
                         clusters.bmax, t_min, t_max)
    disp = build_pair_dispatch_v3(clusters, hit_m, block_pairs)
    # ONE per-ray row table [feats(16) | tmin | tmax], ONE (cap, 18) row
    # gather. Dead slots get ZERO rows: zero features make every product
    # zero, so det >= EPS rejects them with no live mask.
    table = jnp.concatenate([ray_features(org, dirn), t_min[:, None],
                             t_max[:, None]], axis=1)
    g = jnp.where(disp["live"][:, None], table[disp["slot_ray"]], 0.0)
    return disp, g[:, :16], g[:, 16], g[:, 17]


def search_pairs_v3(scene, org, dirn, t_min, t_max):
    """Closest hit per ray via the v3 dispatch + pair-block search +
    packed scatter-min.

    Returns (hit, t_approx, gid, overflow) per ray - detached primal.
    gid is in ORIGINAL triangle space (dup_map applied). t_approx carries
    the reduce key's quantization (~2^-mant relative); callers recompute
    exact t at gid (mt_gather). t_min/t_max: (R,) arrays, honored both in
    the cell cull and the accept tests.
    """
    from pathtrace_tpu.ops.pallas.pair_kernel import pair_search

    clusters = scene.clusters
    r = org.shape[0]
    b = BLOCK_PAIRS
    gid_bits, mant_bits = _key_bits(scene.num_tris)
    disp, feats, tmin_s, tmax_s = pair_inputs_v3(clusters, org, dirn,
                                                 t_min, t_max, b)
    slot_ray = disp["slot_ray"]
    live = disp["live"]
    nb = slot_ray.shape[0] // b
    t_row, member = pair_search(
        jnp.asarray(clusters.coeffs), disp["block_cluster"],
        disp["block_count"], feats, tmin_s, tmax_s, block_pairs=b)
    hit_row = jnp.isfinite(t_row) & live
    member = (disp["block_prim_start"][:, None]
              + member.reshape(nb, b)).reshape(-1)
    gid_row = jnp.asarray(clusters.dup_map)[jnp.clip(member, 0, None)]

    # packed scatter-min: key = [5-bit rebased exp | mant | original gid].
    # Duplicate copies of one triangle carry identical keys.
    tb = jax.lax.bitcast_convert_type(
        jnp.where(hit_row, t_row, 0.0), jnp.int32)
    e = jnp.clip((tb >> 23) - _T_EXP_BASE, 0, 31)
    mant = (tb >> (23 - mant_bits)) & ((1 << mant_bits) - 1)
    tq = ((e << mant_bits) | mant).astype(jnp.uint32)
    key = (tq << gid_bits) | gid_row.astype(jnp.uint32)
    dead_key = jnp.uint32(0xFFFFFFFF)
    key = jnp.where(hit_row, key, dead_key)
    best = jnp.full((r,), dead_key).at[slot_ray].min(key)
    hit = best != dead_key

    gid = (best & jnp.uint32((1 << gid_bits) - 1)).astype(jnp.int32)
    # approximate t back from the quantized code (exact recompute is the
    # caller's mt_gather; this only feeds the sphere-vs-tri compare)
    tq_back = (best >> gid_bits).astype(jnp.int32)
    e_b = (tq_back >> mant_bits) + _T_EXP_BASE
    m_b = (tq_back & ((1 << mant_bits) - 1)) << (23 - mant_bits)
    t_approx = jax.lax.bitcast_convert_type((e_b << 23) | m_b, jnp.float32)
    t_approx = jnp.where(hit, t_approx, 0.0)
    return hit, t_approx, gid, disp["overflow"]


def raycast_binned_v3(scene, org, dirn, t_min=None, t_max=None):
    """Drop-in raycast (HitRecord) through the v3 dispatch."""
    from pathtrace_tpu.ops.intersect import (BIG_T, finalize_hit,
                                             finalize_hit_packed, mt_gather)

    org_d = jax.lax.stop_gradient(org)
    dirn_d = jax.lax.stop_gradient(dirn)
    r = org.shape[0]
    if t_min is None:
        t_min = jnp.zeros((r,), jnp.float32)
    if t_max is None:
        t_max = jnp.full((r,), BIG_T, jnp.float32)
    tmin_d = jax.lax.stop_gradient(t_min)
    tmax_d = jax.lax.stop_gradient(t_max)
    hit, best_t, idx, overflow = search_pairs_v3(
        scene, org_d, dirn_d, tmin_d, tmax_d)

    if scene.mt is not None:
        zeros = jnp.zeros((r,), jnp.float32)
        hit, best_t, idx, _, _ = _overflow_repair(
            scene, (hit, best_t, idx, zeros, zeros), overflow, org_d,
            dirn_d, tmin_d, tmax_d)

    idx = jnp.minimum(jnp.maximum(idx, 0), scene.num_tris - 1)
    if scene.geom_pack is not None and scene.num_spheres == 0:
        # one-gather differentiable recompute + shading tail
        return finalize_hit_packed(scene, org, dirn, t_min, hit, idx)
    t2, u2, v2, _ = mt_gather(scene.tris, idx, org, dirn, t_min,
                              jnp.full_like(t_max, BIG_T))
    best_t = jnp.where(hit, t2, best_t)
    u = jnp.where(hit, u2, 0.0)
    v = jnp.where(hit, v2, 0.0)
    return finalize_hit(scene, org, dirn, t_min, t_max, hit, best_t, idx,
                        u, v)


def shadow_binned_v3(scene, org, dirn, t_min, t_max):
    """Lean shadow backend via the v3 dispatch: (hit, prim_id, is_sphere).
    NEE only identity-tests the winner (megakernel.nee_contribution)."""
    org_d = jax.lax.stop_gradient(org)
    dirn_d = jax.lax.stop_gradient(dirn)
    tmin_d = jax.lax.stop_gradient(t_min)
    tmax_d = jax.lax.stop_gradient(t_max)
    hit, tri_t, gid, overflow = search_pairs_v3(
        scene, org_d, dirn_d, tmin_d, tmax_d)

    if scene.mt is not None:
        res = (hit, tri_t, gid, jnp.zeros_like(tri_t),
               jnp.zeros_like(tri_t))
        hit, tri_t, gid, _, _ = _overflow_repair(
            scene, res, overflow, org_d, dirn_d, tmin_d, tmax_d)
    if scene.num_spheres:
        from pathtrace_tpu.ops.intersect import (closest_masked,
                                                 intersect_spheres_all)
        st, svalid = intersect_spheres_all(scene.spheres, org, dirn,
                                           t_min, t_max)
        sp_t, _, sp_hit = closest_masked(jnp.where(svalid, st, jnp.inf))
        use_sph = sp_hit & (~hit | (sp_t < jnp.where(hit, tri_t, jnp.inf)))
        return hit | sp_hit, gid, use_sph
    return hit, gid, jnp.zeros_like(hit)


# v3's only overflow class is global slot-budget truncation, which marks
# every ray of a truncated cluster - potentially thousands at once - so
# the repair capacity is sized for that burst (the cond fires only on
# overflow batches).
REPAIR_CAP = 4096


def _overflow_repair(scene, res, overflow, org_d, dirn_d, tmin_d, tmax_d):
    """Re-resolve overflow rays exactly, capacity-bounded.

    Rather than re-running the FULL-scene chunked MT product for the
    whole batch whenever ANY lane overflows, gather up to
    REPAIR_CAP overflow rays, brute them against the full scene
    (REPAIR_CAP x T products - one chunk), scatter back. The full-batch
    fallback remains only for > REPAIR_CAP overflows (pathological).
    """
    from pathtrace_tpu.ops.mt_matmul import (mt_closest_auto,
                                             mt_matmul_closest_chunked)

    n_over = jnp.sum(overflow.astype(jnp.int32))

    def repair(res):
        idx = jnp.nonzero(overflow, size=REPAIR_CAP, fill_value=0)[0]
        sel = overflow[idx]
        # wide blocks: at REPAIR_CAP rays the (REPAIR_CAP, block)
        # products are small, and 4 sequential steps beat the default
        # 4096-column scan's ~21
        block = min(32768, scene.mt.det.shape[1])
        ho, to, io, uo, vo = mt_matmul_closest_chunked(
            scene.mt, org_d[idx], dirn_d[idx], tmin_d[idx], tmax_d[idx],
            block=block)
        h, t, i, u, v = res
        def upd(a, b):
            return a.at[idx].set(jnp.where(sel, b, a[idx]))
        return (upd(h, ho), upd(t, to), upd(i, io), upd(u, uo), upd(v, vo))

    def full(res):
        hit_f, t_f, idx_f, u_f, v_f = mt_closest_auto(
            scene.mt, org_d, dirn_d, tmin_d, tmax_d)
        h, t, i, u, v = res
        return (jnp.where(overflow, hit_f, h),
                jnp.where(overflow, t_f, t),
                jnp.where(overflow, idx_f, i),
                jnp.where(overflow, u_f, u),
                jnp.where(overflow, v_f, v))

    res = jax.lax.cond(n_over > 0, repair, lambda a: a, res)
    res = jax.lax.cond(n_over > REPAIR_CAP, full, lambda a: a, res)
    return res


def raycast_binned(scene, org, dirn, t_min=None, t_max=None,
                   k_max: int = 48):
    """Drop-in raycast via binned traversal (scene.clusters required).

    Overflow rays (more than k_max cluster AABB hits) are re-resolved with
    the exact MT-matmul path against the full scene, masked in - always
    correct, at worst slower when overflow is common."""
    from pathtrace_tpu.ops.intersect import BIG_T, finalize_hit, mt_gather
    from pathtrace_tpu.ops.mt_matmul import mt_closest_auto

    clusters = scene.clusters
    assert clusters is not None, "scene has no clusters; Scene.with_binned()"
    assert clusters.dup_map is None, \
        "KD cells require the v3 path (raycast_binned_v3)"
    org_d = jax.lax.stop_gradient(org)
    dirn_d = jax.lax.stop_gradient(dirn)
    r = org.shape[0]
    if t_min is None:
        t_min = jnp.zeros((r,), jnp.float32)
    if t_max is None:
        t_max = jnp.full((r,), BIG_T, jnp.float32)
    tmin_d = jax.lax.stop_gradient(t_min)
    tmax_d = jax.lax.stop_gradient(t_max)

    hit, best_t, idx, u, v, overflow = raycast_binned_closest(
        clusters, org_d, dirn_d, tmin_d, tmax_d, k_max=k_max)

    if scene.mt is not None:
        # exact fallback for overflow rays, gated behind lax.cond: the
        # full-scene chunked MT product is ~R*T work (5.4G products per
        # bounce on blob82k at 65k lanes), so it must not run
        # unconditionally every raycast.
        # k_max must make overflow RARE IN EVERY BATCH, not just low-rate:
        # any single overflowing lane fires the whole fallback for the
        # iteration. Measured on blob82k INTERIOR rays (the bounce-ray
        # regime): mean 5 cluster-AABB hits, p99 15, max 33 -> k=48 gives
        # zero overflow with margin (camera rays: 4.25% at k=8).
        def fallback(args):
            h, bt, ix, uu, vv = args
            hit_f, t_f, idx_f, u_f, v_f = mt_closest_auto(
                scene.mt, org_d, dirn_d, tmin_d, tmax_d)
            return (jnp.where(overflow, hit_f, h),
                    jnp.where(overflow, t_f, bt),
                    jnp.where(overflow, idx_f, ix),
                    jnp.where(overflow, u_f, uu),
                    jnp.where(overflow, v_f, vv))

        hit, best_t, idx, u, v = jax.lax.cond(
            jnp.any(overflow), fallback, lambda a: a,
            (hit, best_t, idx, u, v))

    # differentiable recompute at the detached chosen prim. No-hit lanes
    # may carry indices into a cluster's padding slots; clamp into range
    # (their results are masked by `hit`).
    idx = jnp.minimum(idx, scene.num_tris - 1)
    t2, u2, v2, _ = mt_gather(scene.tris, idx, org, dirn, t_min,
                              jnp.full_like(t_max, BIG_T))
    best_t = jnp.where(hit, t2, best_t)
    u = jnp.where(hit, u2, u)
    v = jnp.where(hit, v2, v)
    return finalize_hit(scene, org, dirn, t_min, t_max, hit, best_t, idx, u, v)
