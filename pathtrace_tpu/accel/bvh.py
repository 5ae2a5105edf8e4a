"""SAH BVH builder -> flat SoA arrays (host side, numpy).

Reproduces the reference's SAHBVH build semantics (bvh.cpp:426-511):
- top-down recursive split, leaf when <= 4 prims (bvh.cpp:441)
- primitives sorted by centroid (mean of the 3 vertices, bvh.cpp:100-103)
  along a round-robin axis x->y->z, in *descending* order (the comparator
  is `centroid[A] > centroid[B]`, bvh.cpp:451-454)
- split index minimizing the area-weighted-count cost
  CSA[i-1]*i + (CSAtot-CSA[i-1])*(n-i) over the prefix sums CSA of the
  *parallelogram* areas |cross(v2-v1, v3-v1)| (bvh.cpp:458-477) - a SAH
  variant using primitive area, not node AABB area
- AABBs computed bottom-up (IntoBVHNode bvh.cpp:392-419, union at inner
  nodes bvh.cpp:505-508)

The reference then flattens the pointer tree for the GPU with leaf
primitives contiguous per leaf (LoadFromBVH, CudaPrimitive.cu:8-145).
Here flat arrays are the *source of truth*: we emit them directly in
pre-order DFS, plus threaded skip links (next_hit / next_miss) so
traversal needs NO per-ray stack - the batched replacement for the
reference's `int stack[128]` walk (CudaUtil.cuh:99-133).

A C++ builder (native/) accelerates large scenes; this numpy version is
the semantic reference and fallback.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from pathtrace_tpu.utils.pytree import pytree_dataclass

LEAF_SIZE = 4  # reference leaf threshold (bvh.cpp:441)


@pytree_dataclass(static=("num_nodes", "max_leaf", "max_depth"))
class BVHArrays:
    """Flat threaded BVH. Node i's children are i+1 (left) and next_hit
    of the left subtree's end (right) in pre-order; traversal only needs
    next_hit/next_miss."""

    bmin: jnp.ndarray        # (N, 3)
    bmax: jnp.ndarray        # (N, 3)
    next_hit: jnp.ndarray    # (N,) node to visit when AABB hit (first child;
    #                          for leaves == next_miss)
    next_miss: jnp.ndarray   # (N,) node to visit when AABB missed (skip)
    prim_start: jnp.ndarray  # (N,) first reordered prim of leaf, -1 if inner
    prim_count: jnp.ndarray  # (N,) leaf prim count, 0 if inner
    num_nodes: int
    max_leaf: int
    max_depth: int


def _centroids(positions: np.ndarray) -> np.ndarray:
    """Mean of the three vertices with the reference's 0.333333 factor
    (bvh.cpp:100-103)."""
    return positions.sum(axis=1) * 0.333333


def _parallelogram_area(positions: np.ndarray) -> np.ndarray:
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    return np.linalg.norm(np.cross(e1, e2), axis=-1)


def build_bvh(positions: np.ndarray, leaf_size: int = LEAF_SIZE,
              backend: str = "auto"):
    """Build the flat threaded BVH.

    positions: (T, 3, 3) world-space triangle vertices.
    Returns (BVHArrays, prim_order) where prim_order is the permutation
    applied to triangles so every leaf owns a contiguous range (the
    reference achieves the same by copying prims in leaf visit order,
    CudaPrimitive.cu:84-90).

    backend: "auto" (native C++ if compilable, else numpy), "native",
    or "numpy". Both backends implement identical build semantics
    (equivalence-tested in tests/test_native.py).
    """
    positions = np.asarray(positions, np.float32)
    if backend in ("auto", "native") and positions.shape[0] > 0:
        from pathtrace_tpu import native

        out = native.build_bvh_native(positions, leaf_size)
        if out is not None:
            (bmin, bmax, next_hit, next_miss, prim_start, prim_count,
             prim_order, max_depth) = out
            bvh = BVHArrays(
                bmin=bmin, bmax=bmax,
                next_hit=next_hit,
                next_miss=next_miss,
                prim_start=prim_start,
                prim_count=prim_count,
                num_nodes=bmin.shape[0],
                max_leaf=int(prim_count.max()) if prim_count.size else 0,
                max_depth=max_depth,
            )
            return bvh, prim_order
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable")
    t = positions.shape[0]
    cent = _centroids(positions)
    areas = _parallelogram_area(positions)

    # --- recursive split (iterative stack; big scenes blow Python's
    # recursion limit). Produces a pointer-free tree in lists.
    nodes_bmin, nodes_bmax = [], []
    nodes_left, nodes_right = [], []
    nodes_prims = []  # list[np.ndarray] or None
    nodes_depth = []

    prim_min = positions.min(axis=1)
    prim_max = positions.max(axis=1)

    def new_node(depth):
        nodes_bmin.append(None)
        nodes_bmax.append(None)
        nodes_left.append(-1)
        nodes_right.append(-1)
        nodes_prims.append(None)
        nodes_depth.append(depth)
        return len(nodes_bmin) - 1

    root = new_node(0)
    stack = [(root, np.arange(t, dtype=np.int64), 0, 0)]  # (node, ids, axis, depth)
    while stack:
        node, ids, axis, depth = stack.pop()
        if ids.size <= leaf_size:
            nodes_prims[node] = ids
            nodes_bmin[node] = prim_min[ids].min(axis=0)
            nodes_bmax[node] = prim_max[ids].max(axis=0)
            continue
        # descending centroid sort along round-robin axis (bvh.cpp:451-454);
        # stable mergesort mirrors std::sort determinism closely enough.
        order = np.argsort(-cent[ids, axis], kind="stable")
        ids = ids[order]
        csa = np.cumsum(areas[ids])
        n = ids.size
        i = np.arange(1, n)
        cost = csa[:-1] * i + (csa[-1] - csa[:-1]) * (n - i)
        split = int(np.argmin(cost)) + 1
        l = new_node(depth + 1)
        r = new_node(depth + 1)
        nodes_left[node], nodes_right[node] = l, r
        next_axis = (axis + 1) % 3
        stack.append((l, ids[:split], next_axis, depth + 1))
        stack.append((r, ids[split:], next_axis, depth + 1))

    # --- bottom-up AABBs for inner nodes (children were created after
    # parents, so reverse index order is a valid topological order).
    for node in range(len(nodes_bmin) - 1, -1, -1):
        if nodes_prims[node] is None:
            l, r = nodes_left[node], nodes_right[node]
            nodes_bmin[node] = np.minimum(nodes_bmin[l], nodes_bmin[r])
            nodes_bmax[node] = np.maximum(nodes_bmax[l], nodes_bmax[r])

    # --- pre-order DFS flatten with skip threading + prim reorder.
    n_nodes = len(nodes_bmin)
    bmin = np.empty((n_nodes, 3), np.float32)
    bmax = np.empty((n_nodes, 3), np.float32)
    next_hit = np.full(n_nodes, -1, np.int32)
    next_miss = np.full(n_nodes, -1, np.int32)
    prim_start = np.full(n_nodes, -1, np.int32)
    prim_count = np.zeros(n_nodes, np.int32)
    prim_order = np.empty(t, np.int64)

    flat_idx = {}
    counter = 0
    prim_cursor = 0
    # (old_node, miss_target_old) in DFS order; miss targets resolved later
    order_stack = [(root, -1)]
    dfs = []
    while order_stack:
        node, miss = order_stack.pop()
        idx = counter
        counter += 1
        flat_idx[node] = idx
        dfs.append((node, idx, miss))
        if nodes_prims[node] is None:
            # visit left child next; right child's miss is our miss
            order_stack.append((nodes_right[node], miss))
            order_stack.append((nodes_left[node], nodes_right[node]))

    for node, idx, miss in dfs:
        bmin[idx] = nodes_bmin[node]
        bmax[idx] = nodes_bmax[node]
        miss_idx = flat_idx[miss] if miss != -1 else -1
        next_miss[idx] = miss_idx
        if nodes_prims[node] is None:
            next_hit[idx] = flat_idx[nodes_left[node]]
        else:
            ids = nodes_prims[node]
            prim_start[idx] = prim_cursor
            prim_count[idx] = ids.size
            prim_order[prim_cursor:prim_cursor + ids.size] = ids
            prim_cursor += ids.size
            next_hit[idx] = miss_idx

    assert prim_cursor == t
    max_leaf = int(prim_count.max()) if n_nodes else 0
    bvh = BVHArrays(
        bmin=bmin, bmax=bmax,
        next_hit=next_hit, next_miss=next_miss,
        prim_start=prim_start, prim_count=prim_count,
        num_nodes=n_nodes, max_leaf=max_leaf,
        max_depth=int(max(nodes_depth)) if nodes_depth else 0,
    )
    return bvh, prim_order


def validate_bvh(bvh: BVHArrays, positions: np.ndarray,
                 prim_order: np.ndarray) -> None:
    """Structural invariants (SURVEY.md §4): every prim in exactly one
    leaf; parent AABB contains its leaf prims; links well-formed."""
    prim_start = np.asarray(bvh.prim_start)
    prim_count = np.asarray(bvh.prim_count)
    bmin = np.asarray(bvh.bmin)
    bmax = np.asarray(bvh.bmax)
    reordered = positions[prim_order]

    covered = np.zeros(positions.shape[0], bool)
    for i in range(bvh.num_nodes):
        s, c = prim_start[i], prim_count[i]
        if s < 0:
            continue
        assert c >= 1
        assert not covered[s:s + c].any(), "prim in two leaves"
        covered[s:s + c] = True
        pm = reordered[s:s + c].reshape(-1, 3)
        assert (pm >= bmin[i] - 1e-4).all() and (pm <= bmax[i] + 1e-4).all(), \
            "leaf AABB does not contain its prims"
    assert covered.all(), "some prim not in any leaf"
    nh = np.asarray(bvh.next_hit)
    nm = np.asarray(bvh.next_miss)
    assert ((nh >= -1) & (nh < bvh.num_nodes)).all()
    assert ((nm >= -1) & (nm < bvh.num_nodes)).all()
    # skip links must strictly advance in pre-order (guarantees termination)
    idx = np.arange(bvh.num_nodes)
    assert ((nh == -1) | (nh > idx)).all()
    assert ((nm == -1) | (nm > idx)).all()
