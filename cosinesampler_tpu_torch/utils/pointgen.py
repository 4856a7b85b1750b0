"""Collocation-point stream: native/pointgen.cpp through ctypes, or NumPy.

Counterpart of the JAX package's utils/pointgen.py, with its own loader (that
module's package pulls in JAX).  A C++ worker thread fills a ring of
Philox-2x32-10 uniform batches ahead of the training loop; a batch is a pure
function of (seed, step), so both packages, and the NumPy fallback here,
produce the same stream bit for bit.

The library is built with g++ at first use into the port's build directory
(ops/cuda/build.py); without a compiler the NumPy Philox takes over.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import subprocess
from typing import Optional

import numpy as np

from ..ops.cuda.build import build_shared_library

_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "pointgen.cpp"


@functools.cache
def _build_library() -> Optional[ctypes.CDLL]:
    """The native generator, or None when it cannot be built here."""
    if not _SRC.exists():
        return None
    try:
        path = build_shared_library(
            "pointgen", [_SRC],
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"])
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.pointgen_create.restype = ctypes.c_void_p
    lib.pointgen_create.argtypes = [ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_uint32, ctypes.c_float,
                                    ctypes.c_float, ctypes.c_int]
    lib.pointgen_destroy.restype = None
    lib.pointgen_destroy.argtypes = [ctypes.c_void_p]
    lib.pointgen_take.restype = None
    lib.pointgen_take.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_uint64]
    return lib


def _philox2x32(counter: np.ndarray, key: np.uint32) -> np.ndarray:
    """Vectorized Philox-2x32-10 matching native/pointgen.cpp exactly."""
    mul = np.uint64(0xD256D193)
    weyl = np.uint32(0x9E3779B9)
    c0 = counter.astype(np.uint32)
    c1 = (counter >> np.uint64(32)).astype(np.uint32)
    k = np.uint32(key)
    for _ in range(10):
        prod = c0.astype(np.uint64) * mul
        hi = (prod >> np.uint64(32)).astype(np.uint32)
        lo = prod.astype(np.uint32)
        c0 = hi ^ np.uint32(k) ^ c1
        c1 = lo
        k = np.uint32((int(k) + int(weyl)) & 0xFFFFFFFF)
    return np.stack([c0, c1], axis=-1)


def _fill_numpy(batch_points: int, dim: int, seed: int, step: int,
                lo: float, hi: float) -> np.ndarray:
    values = batch_points * dim
    n_ctr = (values + 1) // 2
    base = np.uint64(step) * np.uint64(values)
    counters = base + np.arange(n_ctr, dtype=np.uint64)
    bits = _philox2x32(counters, np.uint32(seed)).reshape(-1)[:values]
    u = (bits >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / 16777216.0)
    return (lo + (hi - lo) * u).reshape(batch_points, dim)


class PointGenerator:
    """Deterministic per-step collocation batches (native when available).

    Owns a native worker thread: call ``close()``, or use it as a context
    manager.
    """

    def __init__(self, batch_points: int, dim: int, seed: int = 0,
                 lo: float = -1.0, hi: float = 1.0, n_slots: int = 4,
                 force_numpy: bool = False):
        self.batch_points = int(batch_points)
        self.dim = int(dim)
        self.seed = int(seed) & 0xFFFFFFFF
        self.lo = float(lo)
        self.hi = float(hi)
        self._lib = None if force_numpy else _build_library()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.pointgen_create(
                self.batch_points, self.dim, self.seed,
                ctypes.c_float(self.lo), ctypes.c_float(self.hi),
                int(n_slots))

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def batch(self, step: int) -> np.ndarray:
        """The (batch_points, dim) float32 batch for training step ``step``."""
        if self._handle is not None:
            out = np.empty((self.batch_points, self.dim), dtype=np.float32)
            self._lib.pointgen_take(
                ctypes.c_void_p(self._handle),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.c_uint64(step))
            return out
        return _fill_numpy(self.batch_points, self.dim, self.seed, step,
                           self.lo, self.hi)

    def close(self):
        if self._handle is not None:
            self._lib.pointgen_destroy(ctypes.c_void_p(self._handle))
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
