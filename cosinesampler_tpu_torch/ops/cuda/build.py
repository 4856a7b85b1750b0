"""Build the port's native sources into shared libraries, once per content.

The CUDA kernels (``cosinesampler_tpu_torch/csrc/*.cu``) are compiled with
nvcc for ``sm_90a`` into one shared library with a plain C interface and
loaded with ctypes; no source includes PyTorch's headers, so a build takes
seconds.  Each library goes into ``build/<name>-<hash>/`` at the repository
root, keyed by a hash of its sources and its compile command, and a file
lock serialises concurrent builds (pytest workers, several processes on
one card).  A failed build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Sequence

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def build_shared_library(name: str, sources: Sequence[pathlib.Path],
                         command: Sequence[str],
                         deps: Sequence[pathlib.Path] = (),
                         root: pathlib.Path = BUILD_ROOT) -> pathlib.Path:
    """Compile ``sources`` with ``command + sources + ['-o', lib]``.

    ``deps`` (headers) enter the content hash but not the command line.
    Returns the path of the library, building it only if no library of the
    same content exists.
    """
    digest = hashlib.sha256(" ".join(command).encode())
    for path in (*sources, *deps):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = root / f"{name}-{digest.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
            proc = subprocess.run(
                [*command, *map(str, sources), "-o", str(tmp)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed (exit {proc.returncode}):\n"
                    f"{proc.stderr}")
            os.replace(tmp, lib)
    return lib


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels need the CUDA toolkit")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.fused2w_blend, lib.fused2w_bwd):
        # 3 data pointers; n, c, h, w, q, kernel, padding, align,
        # multicell, strict; the offset lattice's step and stop; the stream
        fn.argtypes = [ptr, ptr, ptr] + [i32] * 10 + [f32, f32, ptr]
        fn.restype = i32
    lib.fused2w_max_channels.argtypes = []
    lib.fused2w_max_channels.restype = i32
    lib.csm_error_string.argtypes = [i32]
    lib.csm_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the CUDA kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib = build_shared_library(
        "cosinesampler_kernels", sources,
        [nvcc_path(), *NVCC_FLAGS, f"-I{CSRC}"], deps=headers)
    return _declare(ctypes.CDLL(str(lib)))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.csm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
