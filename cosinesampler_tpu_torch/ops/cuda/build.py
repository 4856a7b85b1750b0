"""Build the port's native sources into shared libraries, once per content.

The CUDA kernels (``cosinesampler_tpu_torch/csrc/*.cu``) are compiled with
nvcc for ``sm_90a`` into one shared library with a plain C interface and
loaded with ctypes; no source includes PyTorch's headers, so a build takes
seconds.  Every source is compiled to an object by its own compiler
process, all started together, and the objects are then linked.  Each
library goes into ``build/<name>-<hash>/`` at the repository root, keyed by
a hash of its sources and its commands, and a file lock serialises
concurrent builds (pytest workers, several processes on one card).  A
failed build raises with the compiler's stderr.
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
from typing import Optional, Sequence

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build"

# the shared memory a block may opt in to on the H100 (232 448 bytes); the
# C entry points check it against the device's own limit
BLOCK_SMEM_BYTES = 227 * 1024

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def build_shared_library(name: str, sources: Sequence[pathlib.Path],
                         command: Sequence[str],
                         link_command: Optional[Sequence[str]] = None,
                         deps: Sequence[pathlib.Path] = (),
                         root: pathlib.Path = BUILD_ROOT) -> pathlib.Path:
    """Compile each of ``sources`` with ``command + ['-c', src, '-o', obj]``,
    all at once, then link with ``link_command + objs + ['-o', lib]``
    (``link_command`` defaults to ``command``).

    ``deps`` (headers) enter the content hash but not the command line.
    Returns the path of the library, building it only if no library of the
    same content exists.
    """
    link_command = command if link_command is None else link_command
    digest = hashlib.sha256(" ".join(command).encode())
    digest.update(" ".join(link_command).encode())
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
            tag = f"{os.getpid()}.tmp"
            # nvcc and g++ tell an object file by its ".o" suffix
            objs = [out_dir / f"{tag}-{i}-{src.stem}.o"
                    for i, src in enumerate(sources)]
            procs = [subprocess.Popen(
                [*command, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                for src, obj in zip(sources, objs)]
            stderrs = [proc.communicate()[1] for proc in procs]
            errors = [(proc.returncode, err)
                      for proc, err in zip(procs, stderrs)]
            tmp = out_dir / f"lib{name}.so.{tag}"
            if all(rc == 0 for rc, _ in errors):
                proc = subprocess.run(
                    [*link_command, *map(str, objs), "-o", str(tmp)],
                    capture_output=True, text=True)
                errors = [(proc.returncode, proc.stderr)]
            for obj in objs:
                obj.unlink(missing_ok=True)
            failed = [(rc, err) for rc, err in errors if rc != 0]
            if failed:
                raise RuntimeError(
                    f"building {name} failed (exit {failed[0][0]}):\n"
                    + "\n".join(err for _, err in failed))
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
    for fn in (lib.fused2w_blend, lib.fused2w_bwd, lib.fused2d_blend,
               lib.fused2d_bwd, lib.fused_v1_blend2, lib.fused_v1_bwd2):
        # 3 data pointers; n, c, h, w, q, kernel, padding, align,
        # multicell, strict; the offset lattice's step and stop; the stream
        fn.argtypes = [ptr, ptr, ptr] + [i32] * 10 + [f32, f32, ptr]
        fn.restype = i32
    for fn in (lib.fused3w_blend, lib.fused3w_bwd, lib.fused3d_blend,
               lib.fused3d_bwd, lib.fused_v1_blend3, lib.fused_v1_bwd3):
        # 3 data pointers; n, c, d, h, w, q, kernel, padding, align,
        # multicell, strict; the offset lattice's step and stop; the stream
        fn.argtypes = [ptr, ptr, ptr] + [i32] * 11 + [f32, f32, ptr]
        fn.restype = i32
    for fn in (lib.fused3s_blend, lib.fused3s_bwd):
        # cells or g, points, perm, table, out; n, c, d, h, w, q, table
        # blocks, kernel, padding, align, multicell, strict; the offset
        # lattice's step and stop; the stream
        fn.argtypes = [ptr] * 5 + [i32] * 12 + [f32, f32, ptr]
        fn.restype = i32
    for fn in (lib.fused3b_blend, lib.fused3b_bwd):
        # vol or g, slot points, occ, hasv, out; n, c, d, h, w, qp, kernel,
        # padding, align, multicell, strict; the offset lattice's step and
        # stop; the stream
        fn.argtypes = [ptr] * 5 + [i32] * 11 + [f32, f32, ptr]
        fn.restype = i32
    # g, slot points, occ, hasv, sbi, first, last, visited, bricks; n, c,
    # d, h, w, qp, nsb, nbz, nysb, own, rows_s, fp, nsh, kernel, padding,
    # align, multicell, strict; the offset lattice's step and stop; the
    # stream
    lib.fused3b_bwd_ghost.argtypes = [ptr] * 9 + [i32] * 18 + [f32, f32, ptr]
    lib.fused3b_bwd_ghost.restype = i32
    # bricks, visited, dvol; n, c, d, h, w, nbz, nysb, own, rows_s, fp, nsh;
    # the stream
    lib.fused3b_ghost_fold.argtypes = [ptr] * 3 + [i32] * 11 + [ptr]
    lib.fused3b_ghost_fold.restype = i32
    # cells, w1, b1, w2, b2, points, dcells, grads, scratch; n, c, h, w,
    # q, hidden, pde, kernel, padding, align, multicell, strict; the offset
    # lattice's step and stop; the stream
    lib.mega2w_step.argtypes = [ptr] * 9 + [i32] * 12 + [f32, f32, ptr]
    lib.mega2w_step.restype = i32
    for fn in (lib.blend_o, lib.splat_o):
        # 3 data pointers; dim, n, c, d, h, w, q, grid batch, 3 orders,
        # kernel, padding, align, multicell, strict; the offset lattice's
        # step and stop; the stream
        fn.argtypes = [ptr, ptr, ptr] + [i32] * 16 + [f32, f32, ptr]
        fn.restype = i32
    for fn in (lib.percell_blend, lib.percell_blend_query_order,
               lib.percell_splat):
        # input or gout, grid, perm, out; then as blend_o
        fn.argtypes = [ptr] * 4 + [i32] * 16 + [f32, f32, ptr]
        fn.restype = i32
    for fn in (lib.slab_blend, lib.slab_splat):
        # as blend_o, with the slab rows dz and channels cc after the orders
        fn.argtypes = [ptr, ptr, ptr] + [i32] * 18 + [f32, f32, ptr]
        fn.restype = i32
    lib.csm_error_string.argtypes = [i32]
    lib.csm_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the CUDA kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    nvcc = nvcc_path()
    lib = build_shared_library(
        "cosinesampler_kernels", sources, [nvcc, *NVCC_FLAGS, f"-I{CSRC}"],
        link_command=[nvcc, *NVCC_FLAGS, "-shared"], deps=headers)
    return _declare(ctypes.CDLL(str(lib)))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.csm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
