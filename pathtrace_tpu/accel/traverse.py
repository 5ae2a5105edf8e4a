"""Stackless batched BVH traversal (the #1 hot path).

Batched replacement for the reference's per-thread stack walk
(RayCast, CudaUtil.cuh:93-148: `int stack[128]` in local memory, push/pop,
AABB-prune against the running closest t). A per-lane stack maps poorly to
a vector machine, so the builder threads the tree with skip links
(next_hit/next_miss, accel/bvh.py) and every ray carries only a *current
node index*. Each step of the batched `while_loop` is a dense gather +
slab test + <=4 masked triangle tests over the whole ray batch.

The AABB test is the standard robust slab test with the Ize 1.00000024
tmax factor; the reference's `Normalize(inv(dir))` rescaling quirk
(CudaUtil.cuh:70) is deliberately NOT replicated (flagged in SURVEY.md §2
as mathematically wrong; pruning-only, does not change the estimator).

Pruning semantics match: AABB tested against [t_min, closest_t]
(CudaUtil.cuh:107), leaf prims tested against the running closest t,
spheres scanned after the tree (CudaUtil.cuh:137-145).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pathtrace_tpu.models.scene import Scene
from pathtrace_tpu.ops.intersect import (BIG_T, HitRecord, finalize_hit,
                                         mt_gather)
from pathtrace_tpu.utils import math3

# Robust slab-test expansion factor (Ize, "Robust BVH Ray Traversal";
# reference uses the same constant, CudaUtil.cuh:86).
TMAX_FUDGE = 1.00000024


def slab_test(org, inv_d, bmin, bmax, t_min, t_max):
    """(R,) robust slab test; inv_d precomputed per ray."""
    t0 = (bmin - org) * inv_d
    t1 = (bmax - org) * inv_d
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    tnear = jnp.maximum(jnp.max(tlo, axis=-1), t_min)
    tfar = jnp.minimum(jnp.min(thi, axis=-1), t_max) * TMAX_FUDGE
    return tnear <= tfar


def safe_inv_dir(dirn):
    """1/dir with +-inf replaced by a huge finite value (keeps the slab
    arithmetic NaN-free when org is exactly on a slab plane)."""
    big = 1e30
    s = jnp.where(dirn >= 0.0, 1.0, -1.0)
    return jnp.where(jnp.abs(dirn) > 1e-12, 1.0 / dirn, s * big)


def raycast_bvh(scene: Scene, org: jnp.ndarray, dirn: jnp.ndarray,
                t_min=None, t_max=None) -> HitRecord:
    """Drop-in replacement for raycast_brute using scene.bvh."""
    bvh = scene.bvh
    assert bvh is not None, "scene has no BVH; call Scene.with_bvh()"
    # host-built scenes carry numpy leaves; the while_loop body indexes
    # them with tracers, which requires device arrays
    bvh = jax.tree.map(jnp.asarray, bvh)
    tris_dev = jax.tree.map(jnp.asarray, scene.tris)
    # The while_loop (discrete traversal/selection) sees detached rays
    # (lax.while_loop is not reverse-differentiable); hit attributes are
    # recomputed differentiably at the chosen prim afterwards so transport
    # gradients flow (see raycast_matmul).
    org_raw, dirn_raw = org, dirn
    org = jax.lax.stop_gradient(org)
    dirn = jax.lax.stop_gradient(dirn)
    r = org.shape[0]
    if t_min is None:
        t_min = jnp.zeros((r,), jnp.float32)
    if t_max is None:
        t_max = jnp.full((r,), BIG_T, jnp.float32)

    inv_d = safe_inv_dir(dirn)
    max_leaf = max(bvh.max_leaf, 1)

    def cond(state):
        node = state[0]
        return jnp.any(node >= 0)

    def body(state):
        node, best_t, best_prim, best_u, best_v, tri_hit = state
        active = node >= 0
        nidx = jnp.maximum(node, 0)
        bmin = bvh.bmin[nidx]
        bmax = bvh.bmax[nidx]
        # prune against the running closest t (CudaUtil.cuh:107)
        cur_max = jnp.where(tri_hit, best_t, t_max)
        ahit = slab_test(org, inv_d, bmin, bmax, t_min, cur_max) & active

        pstart = bvh.prim_start[nidx]
        pcnt = bvh.prim_count[nidx]
        leaf_visit = ahit & (pstart >= 0)

        for k in range(max_leaf):
            valid_k = leaf_visit & (k < pcnt)
            pid = jnp.where(valid_k, pstart + k, 0)
            cur_max = jnp.where(tri_hit, best_t, t_max)
            t, u, v, ok = mt_gather(tris_dev, pid, org, dirn, t_min, cur_max)
            better = valid_k & ok
            best_t = jnp.where(better, t, best_t)
            best_prim = jnp.where(better, pid, best_prim)
            best_u = jnp.where(better, u, best_u)
            best_v = jnp.where(better, v, best_v)
            tri_hit = tri_hit | better

        nxt = jnp.where(ahit, bvh.next_hit[nidx], bvh.next_miss[nidx])
        node = jnp.where(active, nxt, node)
        return node, best_t, best_prim, best_u, best_v, tri_hit

    state = (
        jnp.zeros((r,), jnp.int32),            # current node = root
        jnp.full((r,), BIG_T, jnp.float32),    # best t
        jnp.zeros((r,), jnp.int32),            # best prim
        jnp.zeros((r,), jnp.float32),          # best u
        jnp.zeros((r,), jnp.float32),          # best v
        jnp.zeros((r,), bool),                 # tri hit
    )
    (node, best_t, best_prim, best_u, best_v,
     tri_hit) = jax.lax.while_loop(cond, body, state)

    # differentiable recompute at the (detached) chosen primitive
    t2, u2, v2, _ = mt_gather(scene.tris, best_prim, org_raw, dirn_raw,
                              t_min, jnp.full_like(t_max, BIG_T))
    best_t = jnp.where(tri_hit, t2, best_t)
    best_u = jnp.where(tri_hit, u2, best_u)
    best_v = jnp.where(tri_hit, v2, best_v)

    return finalize_hit(scene, org_raw, dirn_raw, t_min, t_max,
                        tri_hit, best_t, best_prim, best_u, best_v)
