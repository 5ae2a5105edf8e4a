"""pathtrace_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/XLA/Pallas reimplementation of the capabilities of the
CUDA renderer WaterPlease/PathTrace-on-CUDA, restructured as batched
array programs:

- SoA scene representation (flat device arrays, not pointer trees)
- SAH BVH built on host, flattened arrays as the source of truth
  (reference: bvh.cpp:426-511 + CudaPrimitive.cu:8-145)
- Batch "SIMT" megakernel integrator (lax.scan over bounces, masked lanes)
  and a wavefront pipeline (intersect/compact/shade) for scale
  (reference megakernel: CudaUtil.cuh:193-382)
- Differentiable end-to-end: pixel gradients w.r.t. material parameters
  (albedo/roughness/IOR/emission) via detached-sampling estimators
- Counter-based deterministic RNG (Philox4x32-10, utils/rng.py) keyed by
  (ray, bounce) replacing curand + clock64 (reference: pathtracer.cu:70-71)
- Multi-chip scaling via jax.sharding Mesh + shard_map: rays/tiles sharded,
  scene replicated, psum for film assembly and gradient all-reduce
"""

__version__ = "0.1.0"

from pathtrace_tpu.models.scene import Scene, Material, Spheres, Triangles
from pathtrace_tpu.core.camera import Camera
from pathtrace_tpu.integrator.render import render, render_image

__all__ = [
    "Scene",
    "Material",
    "Spheres",
    "Triangles",
    "Camera",
    "render",
    "render_image",
]
