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
# the H100 SXM's SMs, and the shared memory of one of them with the 1 KB
# the card reserves a block
H100_SMS = 132
SM_SMEM_BYTES = 228 * 1024
RESERVED_SMEM_BYTES = 1024

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
    for dim, blend, bwd in ((2, lib.fused2d_blend, lib.fused2d_bwd),
                            (3, lib.fused3d_blend, lib.fused3d_bwd)):
        # cells, points, the texel-major copy, out; n, c, the dim sizes,
        # q, the blend layout (width, groups, cell lanes, threads, queries
        # a block, planar), kernel, padding, align, multicell, strict; the
        # offset lattice's step and stop; the stream
        blend.argtypes = [ptr] * 4 + [i32] * (14 + dim) + [f32, f32, ptr]
        # g, points, scratch, dcells; n, c, the dim sizes, q, the bwd
        # layout (width, block groups, lane groups, lanes, threads,
        # queries a block, planar), then as the blend
        bwd.argtypes = [ptr] * 4 + [i32] * (15 + dim) + [f32, f32, ptr]
        for fn in (blend, bwd):
            fn.restype = i32
    for dim, fn in ((2, lib.fused2w_bwd), (3, lib.fused3w_bwd)):
        # g, points, scratch, dcells; n, c, the dim sizes, q, the scatter
        # layout (width, block groups, lane groups, lanes, threads),
        # planar, kernel, padding, align, multicell, strict; the offset
        # lattice's step and stop; the stream
        fn.argtypes = [ptr] * 4 + [i32] * (14 + dim) + [f32, f32, ptr]
        fn.restype = i32
    for dim, blend in ((2, lib.fused2w_blend), (3, lib.fused3w_blend),
                       (2, lib.fused_v1_blend2), (3, lib.fused_v1_blend3)):
        # cells, points, the texel-major copy, out; n, c, the dim sizes,
        # q, the blend layout (width, groups, cell lanes, threads,
        # planar), kernel, padding, align, multicell, strict; the offset
        # lattice's step and stop; the stream
        blend.argtypes = [ptr] * 4 + [i32] * (13 + dim) + [f32, f32, ptr]
        blend.restype = i32
    for dim, bwd in ((2, lib.fused_v1_bwd2), (3, lib.fused_v1_bwd3)):
        # g, points, scratch, out; n, c, the dim sizes, q, the scatter
        # layout (width, block groups, lane groups, lanes, threads),
        # kernel, padding, align, multicell, strict; the offset lattice's
        # step and stop; the stream
        bwd.argtypes = [ptr] * 4 + [i32] * (13 + dim) + [f32, f32, ptr]
        bwd.restype = i32
    # cells, points, perm, table, the texel-major copy, the query-major
    # rows, out; n, c, d, h, w, q, table blocks, the gather layout (width,
    # groups, cell lanes, threads), planar, kernel, padding, align,
    # multicell, strict; the offset lattice's step and stop; the stream
    lib.fused3s_blend.argtypes = [ptr] * 7 + [i32] * 17 + [f32, f32, ptr]
    # g, points, perm, table, scratch, out; n, c, d, h, w, q, table
    # blocks, the scatter layout (width, block groups, lane groups, lanes,
    # threads), then as fused3s_blend
    lib.fused3s_bwd.argtypes = [ptr] * 6 + [i32] * 17 + [f32, f32, ptr]
    # vol, slot points, occ, hasv, out; n, c, d, h, w, qp, the gather
    # layout (width, groups, cell lanes, threads), kernel, padding, align,
    # multicell, strict; the offset lattice's step and stop; the stream
    lib.fused3b_blend.argtypes = [ptr] * 5 + [i32] * 15 + [f32, f32, ptr]
    # g, slot points, occ, hasv, dvol; n, c, d, h, w, qp, the scatter
    # layout (width, block groups, lane groups, lanes, threads), then as
    # fused3b_blend
    lib.fused3b_bwd.argtypes = [ptr] * 5 + [i32] * 16 + [f32, f32, ptr]
    for fn in (lib.fused3s_blend, lib.fused3s_bwd, lib.fused3b_blend,
               lib.fused3b_bwd):
        fn.restype = i32
    # in, out; rows, cols, element bytes; the stream
    lib.texel_transpose.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.texel_transpose.restype = i32
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
    # q, hidden, pde, the work units (chunks, cells, stride, slices,
    # q_per_slice, lanes), kernel, padding, align, multicell, strict; the
    # offset lattice's step and stop; the stream
    lib.mega2w_step.argtypes = [ptr] * 9 + [i32] * 18 + [f32, f32, ptr]
    lib.mega2w_step.restype = i32
    # input, grid, out; dim, n, c, d, h, w, q, grid batch, 3 orders, the
    # launch geometry (cells, interleave, stride, q_blocks), kernel,
    # padding, align, multicell, strict; the offset lattice's step and
    # stop; the stream
    lib.blend_o.argtypes = [ptr, ptr, ptr] + [i32] * 20 + [f32, f32, ptr]
    lib.blend_o.restype = i32
    # gout, grid, out; then as blend_o, with splat_o's launch geometry
    # (cells, lanes, stride, q_per_block, q_blocks) in place of blend_o's
    lib.splat_o.argtypes = [ptr] * 3 + [i32] * 21 + [f32, f32, ptr]
    lib.splat_o.restype = i32
    # input, grid, perm, starts, out; then as percell_splat below, with
    # staged in place of the splat's threads
    lib.percell_blend.argtypes = [ptr] * 5 + [i32] * 22 + [f32, f32, ptr]
    lib.percell_blend.restype = i32
    # gout, grid, perm, starts, out; dim, n, c, d, h, w, q, grid batch, 3
    # orders, the plan's keys (kz, ky), the tile's z rows dz, y rows ty,
    # channels cc, threads a block, kernel, padding, align, multicell,
    # strict; the offset lattice's step and stop; the stream
    lib.percell_splat.argtypes = [ptr] * 5 + [i32] * 22 + [f32, f32, ptr]
    lib.percell_splat.restype = i32
    for fn in (lib.slab_blend, lib.slab_splat):
        # input or gout, grid, perm, starts, out; then as percell_splat,
        # with the slab rows dz and channels cc after the orders
        fn.argtypes = [ptr] * 5 + [i32] * 18 + [f32, f32, ptr]
        fn.restype = i32
    # grid, key, rank, starts, perm; dim, n, d, h, w, q, grid batch,
    # padding, align, multicell, strict; the offset lattice's step and
    # stop; the stream
    lib.slab_bins.argtypes = [ptr] * 5 + [i32] * 11 + [f32, f32, ptr]
    lib.slab_bins.restype = i32
    # grid, key, rank, starts, perm, the scan's scratch; n, d, h, w, q,
    # grid batch, the keys (kz, ky), padding, align, multicell, strict;
    # the offset lattice's step and stop; the stream
    lib.percell_plan.argtypes = [ptr] * 6 + [i32] * 12 + [f32, f32, ptr]
    lib.percell_plan.restype = i32
    # the scan scratch's ints for N * K counts
    lib.percell_scan_scratch.argtypes = [i32]
    lib.percell_scan_scratch.restype = i32
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
