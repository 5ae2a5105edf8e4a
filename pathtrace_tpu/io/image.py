"""Film output: ACES tonemap, quantization, PNG/npy export.

Replaces exportImage + ACESFilm + ConverToUint8 (pathtracer.cu:94-122,
CudaUtil.cuh:383-391, image.h:6-8). Oracle comparisons are done in linear
pre-tonemap space (float32 .npy); tonemapping is for preview PNGs only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import jax.numpy as jnp


def aces_film(x: jnp.ndarray) -> jnp.ndarray:
    """ACES filmic fit, exact reference constants (CudaUtil.cuh:383-391)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def to_uint8(x) -> np.ndarray:
    """uint8(v * 255.99) (image.h:6-8)."""
    x = np.asarray(x)
    return (np.clip(x, 0.0, 1.0) * 255.99).astype(np.uint8)


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter 0, zlib)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(
                               h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, linear_image, tonemap: bool = True) -> None:
    img = jnp.asarray(linear_image)
    if tonemap:
        img = aces_film(img)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(np.asarray(img))))


def write_npy(path: str, linear_image) -> None:
    np.save(path, np.asarray(linear_image, np.float32))


def read_npy(path: str) -> np.ndarray:
    return np.load(path)
