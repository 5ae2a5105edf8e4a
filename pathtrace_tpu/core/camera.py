"""Pinhole camera + vectorized ray generation.

Replaces the reference's Camera class (camera.cpp) and the device-side
GetPixelDirection (pathtracer.cu:33-40). Camera parameters are plain traced
arrays, so ray generation is differentiable and jittable.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from pathtrace_tpu.utils.pytree import pytree_dataclass
from pathtrace_tpu.utils import math3


@pytree_dataclass(static=("width", "height"))
class Camera:
    pos: jnp.ndarray       # (3,)
    forward: jnp.ndarray   # (3,)
    up: jnp.ndarray        # (3,)
    right: jnp.ndarray     # (3,)
    fovy: jnp.ndarray      # scalar, radians
    fovx: jnp.ndarray      # scalar, radians
    width: int
    height: int

    @staticmethod
    def from_rotation(pos, rotation_deg=(0.0, 90.0, 0.0), fovy_deg=45.0,
                      width=512, height=512) -> "Camera":
        """Reference (roll, pitch, yaw) convention (camera.cpp:42-66):
        forward = (-sin(pitch) sin(yaw), cos(pitch), -sin(pitch) cos(yaw)),
        up      = ( cos(pitch) sin(yaw), sin(pitch),  cos(pitch) cos(yaw)),
        pitch clamped to [0, 180]. Default pose matches the viewer startup:
        pos (0,20,60), rotation (0,90,0) (renderer.cpp:19).
        """
        _, pitch, yaw = rotation_deg
        pitch = min(max(pitch, 0.0), 180.0)
        p, y = math.radians(pitch), math.radians(yaw)
        forward = np.array(
            [-math.sin(p) * math.sin(y), math.cos(p), -math.sin(p) * math.cos(y)],
            np.float32)
        up = np.array(
            [math.cos(p) * math.sin(y), math.sin(p), math.cos(p) * math.cos(y)],
            np.float32)
        forward /= np.linalg.norm(forward)
        up = up - forward * np.dot(forward, up)
        up /= np.linalg.norm(up)
        return Camera._finish(pos, forward, up, fovy_deg, width, height)

    @staticmethod
    def look_at(pos, target, up=(0.0, 1.0, 0.0), fovy_deg=45.0,
                width=512, height=512) -> "Camera":
        pos = np.asarray(pos, np.float32)
        forward = np.asarray(target, np.float32) - pos
        forward /= np.linalg.norm(forward)
        up = np.asarray(up, np.float32)
        up = up - forward * np.dot(forward, up)
        up /= np.linalg.norm(up)
        return Camera._finish(pos, forward, up, fovy_deg, width, height)

    @staticmethod
    def _finish(pos, forward, up, fovy_deg, width, height) -> "Camera":
        # right = normalize(cross(forward, up)) (camera.cpp GetRight)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        fovy = math.radians(fovy_deg)
        aspect = width / height
        # fovx from fovy and aspect (pathtracer.cu:198)
        fovx = 2.0 * math.atan2(math.tan(fovy * 0.5) * aspect, 1.0)
        # numpy leaves: camera construction issues no eager device ops;
        # values ride along with jit calls.
        f = np.float32
        return Camera(
            pos=np.asarray(pos, f), forward=np.asarray(forward, f),
            up=np.asarray(up, f), right=np.asarray(right, f),
            fovy=f(fovy), fovx=f(fovx),
            width=int(width), height=int(height),
        )

    def ray_directions(self, px: jnp.ndarray, py: jnp.ndarray,
                       jitter_x: jnp.ndarray, jitter_y: jnp.ndarray) -> jnp.ndarray:
        """Jittered primary directions, (R, 3).

        Exact reference formula (pathtracer.cu:33-40):
          dir = normalize(F + 2((px+u)/(W-1) - .5) tan(fovx/2) R
                            - 2((py+v)/(H-1) - .5) tan(fovy/2) U)
        (py measured from the top row; the minus sign flips image y.)
        """
        sx = 2.0 * ((px + jitter_x) / (self.width - 1) - 0.5)
        sy = 2.0 * ((py + jitter_y) / (self.height - 1) - 0.5)
        d = (self.forward[None, :]
             + (sx * jnp.tan(self.fovx * 0.5))[:, None] * self.right[None, :]
             - (sy * jnp.tan(self.fovy * 0.5))[:, None] * self.up[None, :])
        return math3.normalize(d)

    def pixel_grid(self):
        """(R,) px, py int arrays in row-major order (R = W*H)."""
        py, px = jnp.meshgrid(
            jnp.arange(self.height, dtype=jnp.float32),
            jnp.arange(self.width, dtype=jnp.float32), indexing="ij")
        return px.reshape(-1), py.reshape(-1)
