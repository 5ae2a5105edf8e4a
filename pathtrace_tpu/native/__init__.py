"""Native (C++) host-runtime components, loaded via ctypes.

The reference's host runtime (scene ingest + BVH build, bvh.cpp /
CudaPrimitive.cu) is C++; ours is too where it counts: the SAH build is
the host-side hot path (tens of thousands of per-node sorts). The library
is compiled from bvh_builder.cpp with g++ on first use into build/ (a
git-ignored directory next to the source) and rebuilt when the source is
newer; accel/bvh.py falls back to the numpy reference implementation when
no compiler is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_LIB = None
_LOCK = threading.Lock()
_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
_SO = os.path.join(_DIR, "build", "libpathtrace_native.so")


def _compile() -> str | None:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", _SO + ".tmp"],
            check=True, capture_output=True, timeout=120)
        os.replace(_SO + ".tmp", _SO)
        return _SO
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _compile()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.pt_build_bvh.restype = ctypes.c_int64
        lib.pt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return _LIB


def build_bvh_native(positions, leaf_size: int = 4):
    """C++ SAH build. positions: (T,3,3) float32. Returns the same tuple
    layout as accel.bvh.build_bvh or None if the native lib is missing."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    t = positions.shape[0]
    tris = np.ascontiguousarray(positions.reshape(t, 9), np.float32)
    cap = max(2 * t, 1)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    next_hit = np.empty(cap, np.int32)
    next_miss = np.empty(cap, np.int32)
    prim_start = np.empty(cap, np.int32)
    prim_count = np.empty(cap, np.int32)
    prim_order = np.empty(t, np.int64)
    max_depth = np.zeros(1, np.int32)

    def p(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    n = lib.pt_build_bvh(
        p(tris, ctypes.c_float), t, leaf_size,
        p(bmin, ctypes.c_float), p(bmax, ctypes.c_float),
        p(next_hit, ctypes.c_int32), p(next_miss, ctypes.c_int32),
        p(prim_start, ctypes.c_int32), p(prim_count, ctypes.c_int32),
        p(prim_order, ctypes.c_int64), p(max_depth, ctypes.c_int32))
    n = int(n)
    return (bmin[:n], bmax[:n], next_hit[:n], next_miss[:n],
            prim_start[:n], prim_count[:n], prim_order, int(max_depth[0]))
