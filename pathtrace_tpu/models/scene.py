"""SoA scene representation — the device-resident "model" of the world.

Batched replacement for the reference's AoS device scene
(Triangle objects with 12 vec3s + 3 Materials each, CudaPrimitive.cuh:74-235;
Sphere objects CudaPrimitive.cuh:249-323). Here every attribute is a flat
(T, ...) array so intersection and shading are dense vector ops, and the
material arrays form the *differentiable parameter pytree* (gradients flow
through per-hit gathers back to per-triangle parameters).

One material per triangle: in the reference each vertex carries a Material
copied from the mesh-level aiMaterial (model.h:173-207), so mat0==mat1==mat2
always, and shading reads mat0 only (CudaPrimitive.cuh:149-154). A single
per-triangle material is therefore exactly equivalent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from pathtrace_tpu.utils.pytree import pytree_dataclass
from pathtrace_tpu.utils import math3


@pytree_dataclass
class Material:
    """Per-primitive material parameters (the learnable pytree).

    Semantics follow the reference Material struct (CudaPrimitive.cuh:15-23):
    emittance/albedo/specular are RGB; opacity<1-EPS selects the refractive
    lobe family, roughness<1e-2 selects the delta lobe variant
    (CudaUtil.cuh:248-270, 284-334).
    """

    emittance: jnp.ndarray  # (N, 3)
    albedo: jnp.ndarray     # (N, 3)
    specular: jnp.ndarray   # (N, 3)
    opacity: jnp.ndarray    # (N,)
    roughness: jnp.ndarray  # (N,)
    metallic: jnp.ndarray   # (N,)

    @staticmethod
    def stack(mats: list["Material"]) -> "Material":
        # numpy when all inputs are host-side (scene build issues no eager
        # device ops), jnp otherwise.
        xp = np if all(isinstance(m.emittance, np.ndarray) for m in mats) else jnp
        return Material(
            *[xp.concatenate([getattr(m, f) for m in mats], axis=0)
              for f in ("emittance", "albedo", "specular", "opacity",
                        "roughness", "metallic")]
        )

    @staticmethod
    def make(n: int,
             emittance=(0.0, 0.0, 0.0),
             albedo=(1.0, 1.0, 1.0),
             specular=(0.04, 0.04, 0.04),
             opacity=1.0,
             roughness=1.0,
             metallic=0.0) -> "Material":
        f = np.float32
        return Material(
            emittance=np.broadcast_to(np.asarray(emittance, f), (n, 3)).copy(),
            albedo=np.broadcast_to(np.asarray(albedo, f), (n, 3)).copy(),
            specular=np.broadcast_to(np.asarray(specular, f), (n, 3)).copy(),
            opacity=np.full((n,), opacity, f),
            roughness=np.full((n,), roughness, f),
            metallic=np.full((n,), metallic, f),
        )

    def gather(self, idx: jnp.ndarray) -> "Material":
        from pathtrace_tpu.utils.math3 import gather_rows
        return Material(
            emittance=gather_rows(self.emittance, idx),
            albedo=gather_rows(self.albedo, idx),
            specular=gather_rows(self.specular, idx),
            opacity=gather_rows(self.opacity, idx),
            roughness=gather_rows(self.roughness, idx),
            metallic=gather_rows(self.metallic, idx),
        )


@pytree_dataclass
class Triangles:
    """World-space triangle soup with per-vertex shading attributes.

    Layout mirrors what the reference flattens to the GPU
    (Triangle::Copy, CudaPrimitive.cuh:171-215): positions, shading
    normals/tangents/bitangents per vertex, uv per vertex, plus derived
    E1/E2/geometric normal/area.
    """

    v0: jnp.ndarray   # (T, 3) positions
    v1: jnp.ndarray
    v2: jnp.ndarray
    n0: jnp.ndarray   # (T, 3) shading normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    t0: jnp.ndarray   # (T, 3) tangents
    t1: jnp.ndarray
    t2: jnp.ndarray
    b0: jnp.ndarray   # (T, 3) bitangents
    b1: jnp.ndarray
    b2: jnp.ndarray
    uv0: jnp.ndarray  # (T, 2)
    uv1: jnp.ndarray
    uv2: jnp.ndarray

    @property
    def e1(self) -> jnp.ndarray:
        return self.v1 - self.v0

    @property
    def e2(self) -> jnp.ndarray:
        return self.v2 - self.v0

    @property
    def geometric_normal(self) -> jnp.ndarray:
        """normalize(cross(E1, E2)) (CudaPrimitive.cuh:203)."""
        return math3.normalize(math3.cross(self.e1, self.e2))

    @property
    def area(self) -> jnp.ndarray:
        """|cross(E1, E2)| / 2 (CudaPrimitive.cuh:205)."""
        return math3.length(math3.cross(self.e1, self.e2)) * 0.5

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    @staticmethod
    def from_vertices(positions: np.ndarray, normals: np.ndarray,
                      tangents: Optional[np.ndarray] = None,
                      bitangents: Optional[np.ndarray] = None,
                      uvs: Optional[np.ndarray] = None) -> "Triangles":
        """Build from (T,3,3) position/normal arrays (+ optional T/B/uv).

        Tangent fallback mirrors the reference's (model.h:159-171): build an
        arbitrary orthonormal frame from the normal when no uv-derived
        tangents exist.
        """
        positions = np.asarray(positions, np.float32)
        normals = np.asarray(normals, np.float32)
        t = positions.shape[0]
        if tangents is None or bitangents is None:
            tangents, bitangents = tangent_frame_from_normals(normals)
        if uvs is None:
            uvs = np.zeros((t, 3, 2), np.float32)
        j = lambda a: np.ascontiguousarray(a, np.float32)
        return Triangles(
            v0=j(positions[:, 0]), v1=j(positions[:, 1]), v2=j(positions[:, 2]),
            n0=j(normals[:, 0]), n1=j(normals[:, 1]), n2=j(normals[:, 2]),
            t0=j(tangents[:, 0]), t1=j(tangents[:, 1]), t2=j(tangents[:, 2]),
            b0=j(bitangents[:, 0]), b1=j(bitangents[:, 1]), b2=j(bitangents[:, 2]),
            uv0=j(uvs[:, 0]), uv1=j(uvs[:, 1]), uv2=j(uvs[:, 2]),
        )

    @staticmethod
    def concatenate(parts: list["Triangles"]) -> "Triangles":
        import dataclasses
        fields = [f.name for f in dataclasses.fields(Triangles)]
        return Triangles(
            **{f: jnp.concatenate([getattr(p, f) for p in parts], axis=0)
               for f in fields}
        )


def tangent_frame_from_normals(normals: np.ndarray):
    """Arbitrary stable tangent frame per vertex from normals (numpy).

    Reference fallback (model.h:159-171) crosses the normal with a fixed
    axis; we pick the axis least aligned with n for stability.
    """
    n = np.asarray(normals, np.float32)
    flat = n.reshape(-1, 3)
    helper = np.where(
        (np.abs(flat[:, 1:2]) < 0.99), np.array([[0.0, 1.0, 0.0]], np.float32),
        np.array([[1.0, 0.0, 0.0]], np.float32))
    t = np.cross(helper, flat)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    b = np.cross(flat, t)
    return t.reshape(n.shape), b.reshape(n.shape)


@pytree_dataclass
class Spheres:
    """Analytic spheres; not in the BVH, linearly scanned after the tree walk
    exactly like the reference (CudaUtil.cuh:137-145)."""

    center: jnp.ndarray  # (S, 3)
    radius: jnp.ndarray  # (S,)
    mat: Material        # (S, ...) fields

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @staticmethod
    def empty() -> "Spheres":
        return Spheres(
            center=np.zeros((0, 3), np.float32),
            radius=np.zeros((0,), np.float32),
            mat=Material.make(0),
        )


@pytree_dataclass(static=("num_lights",))
class Scene:
    """Full device scene: triangle soup + materials + spheres + light table.

    `lights` indexes emissive triangles, discovered at build time by scanning
    emittance like the reference's upload loop (pathtracer.cu:164-174).
    `num_lights` is static so the sampler's modulus is compile-time.

    `bvh` (optional) holds the flat threaded BVH over `tris`; when present,
    `tris`/`mat` are already permuted to leaf-contiguous order (the
    reference does the same reorder when flattening, CudaPrimitive.cu:84-90).
    """

    tris: Triangles
    mat: Material         # per-triangle
    spheres: Spheres
    lights: jnp.ndarray   # (L,) int32 indices into tris
    num_lights: int
    bvh: object = None       # Optional[BVHArrays]
    mt: object = None        # Optional[MTCoeffs] - matmul intersection
    clusters: object = None  # Optional[ClusterArrays] - binned traversal
    # (T, 42) baked per-triangle shading row (ops/intersect.build_geom_pack)
    # for the one-gather finalize tail; built by with_kd_binned.
    geom_pack: object = None
    # (L, 13) per-light geometry [v0 v1 v2 area geometric_normal], packed at
    # build time so NEE's area sampling gathers from a tiny (L,) table
    # instead of five gathers over the full (T,) triangle arrays. Geometry is
    # gradient-free by scope, so baking it is exact.
    light_pack: object = None

    @property
    def num_tris(self) -> int:
        return self.tris.count

    @property
    def num_spheres(self) -> int:
        return self.spheres.count

    @staticmethod
    def build(tris: Triangles, mat: Material,
              spheres: Optional[Spheres] = None) -> "Scene":
        if spheres is None:
            spheres = Spheres.empty()
        # Light scan on host (mirrors pathtracer.cu:164-174: any emissive
        # channel -> light). EPS threshold on |emittance| as in the reference.
        emit = np.asarray(mat.emittance)
        is_light = np.linalg.norm(emit, axis=-1) > math3.EPS
        lights = np.nonzero(is_light)[0].astype(np.int32)
        if lights.size == 0:
            # Keep shapes static & nonzero; with num_lights==0 the
            # integrator skips NEE entirely.
            lights_arr = np.zeros((1,), np.int32)
        else:
            lights_arr = lights
        li = lights_arr.astype(np.int64)
        pack = np.concatenate([
            np.asarray(tris.v0)[li], np.asarray(tris.v1)[li],
            np.asarray(tris.v2)[li],
            np.asarray(tris.area)[li][:, None],
            np.asarray(tris.geometric_normal)[li],
        ], axis=1).astype(np.float32) if np.asarray(tris.v0).shape[0] else \
            np.zeros((1, 13), np.float32)
        return Scene(
            tris=tris, mat=mat, spheres=spheres,
            lights=lights_arr, num_lights=int(lights.size),
            light_pack=pack,
        )

    def with_bvh(self, leaf_size: int = 4) -> "Scene":
        """Build the SAH BVH and return a scene with triangles/materials
        permuted into leaf-contiguous order (light table rebuilt)."""
        import dataclasses
        from pathtrace_tpu.accel.bvh import build_bvh

        positions = np.stack(
            [np.asarray(self.tris.v0), np.asarray(self.tris.v1),
             np.asarray(self.tris.v2)], axis=1)
        bvh, order = build_bvh(positions, leaf_size=leaf_size)
        tri_fields = {f.name: np.asarray(getattr(self.tris, f.name))[order]
                      for f in dataclasses.fields(Triangles)}
        tris = Triangles(**tri_fields)
        mat = self.mat.gather(order)
        base = Scene.build(tris, mat, self.spheres)
        return Scene(tris=base.tris, mat=base.mat, spheres=base.spheres,
                     lights=base.lights, num_lights=base.num_lights, bvh=bvh,
                     mt=self.mt, light_pack=base.light_pack)

    def with_mt(self) -> "Scene":
        """Precompute the matmul intersection coefficients (ops/mt_matmul)."""
        import dataclasses
        from pathtrace_tpu.ops.mt_matmul import build_mt_coeffs

        positions = np.stack(
            [np.asarray(self.tris.v0), np.asarray(self.tris.v1),
             np.asarray(self.tris.v2)], axis=1)
        return dataclasses.replace(self, mt=build_mt_coeffs(positions))

    def to_device(self) -> "Scene":
        """Ship the whole scene to the default device in one batched
        transfer. Call once after building; without it numpy leaves are
        re-uploaded on every jit call."""
        import jax
        return jax.device_put(self)

    def with_binned(self, max_tris: int = 128) -> "Scene":
        """Build the two-level binned traversal structure (accel/binned.py);
        implies with_bvh() (clusters are BVH subtrees) and with_mt() (exact
        fallback for cluster-cap overflow rays)."""
        import dataclasses
        from pathtrace_tpu.accel.binned import build_clusters

        scene = self if self.bvh is not None else self.with_bvh()
        if scene.mt is None:
            scene = scene.with_mt()
        positions = np.stack(
            [np.asarray(scene.tris.v0), np.asarray(scene.tris.v1),
             np.asarray(scene.tris.v2)], axis=1)
        clusters = build_clusters(scene.bvh, positions, max_tris=max_tris)
        return dataclasses.replace(scene, clusters=clusters)

    def with_kd_binned(self, max_tris: int = 1024) -> "Scene":
        """Non-overlapping KD spatial cells for the pair-block traversal
        (accel/kdgrid.py) - bounded per-ray cluster membership even for
        rays starting on dense surfaces, where BVH-subtree AABBs stack.
        Implies with_mt() (overflow repair needs the exact coefficients).
        """
        import dataclasses
        from pathtrace_tpu.accel.kdgrid import build_kd_clusters

        scene = self if self.mt is not None else self.with_mt()
        positions = np.stack(
            [np.asarray(scene.tris.v0), np.asarray(scene.tris.v1),
             np.asarray(scene.tris.v2)], axis=1)
        # hybrid: midpoint cuts globally, a balanced final cut (better
        # leaf fill, fewer cells: blob82k 187 -> 157)
        clusters, dup_map = build_kd_clusters(
            positions, max_tris=max_tris, rule="hybrid")
        clusters = dataclasses.replace(clusters,
                                       dup_map=jnp.asarray(dup_map))
        from pathtrace_tpu.ops.intersect import build_geom_pack
        return dataclasses.replace(scene, clusters=clusters,
                                   geom_pack=build_geom_pack(scene.tris))
