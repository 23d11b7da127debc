"""ctypes loader for the native C++ BVH builder (``csrc/bvh_builder.cpp``).

Compiles the shared library from source on first use into
``csrc/.build/`` (listed in ``.gitignore``; the library is never
committed, since ``-march=native`` ties it to the host that built it);
raises on any failure so callers fall back to the NumPy builder
(``ops.bvh.build``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None


def _csrc_dir() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "csrc"))


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    csrc = _csrc_dir()
    src = os.path.join(csrc, "bvh_builder.cpp")
    build = os.path.join(csrc, ".build")
    lib = os.path.join(build, "libbvh.so")
    if (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src)):
        os.makedirs(build, exist_ok=True)
        # build beside the target and rename into place, so concurrent
        # first users never load a half-written library
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", tmp, src],
            check=True, capture_output=True)
        os.replace(tmp, lib)
    L = ctypes.CDLL(lib)
    L.bvh_build.restype = ctypes.c_int64
    L.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    _LIB = L
    return L


def build(lo: np.ndarray, hi: np.ndarray, num_bins: int = 16):
    """Same signature/contract as ``ops.bvh.build``."""
    L = _load()
    n = lo.shape[0]
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    max_nodes = max(2 * n, 16)
    bounds4 = np.zeros((max_nodes, 4, 6), np.float32)
    child4 = np.full((max_nodes, 4), -1, np.int32)
    order = np.zeros((n,), np.int64)

    m = L.bvh_build(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, num_bins,
        bounds4.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        child4.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_nodes)
    if m < 0:
        raise RuntimeError(f"bvh_build failed: {m}")
    return bounds4[:m].copy(), child4[:m].copy(), order
