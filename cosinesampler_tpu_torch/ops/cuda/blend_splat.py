"""The blend_o / splat_o pair: gather-and-weigh at any per-axis derivative
order, and its transpose with respect to the input, in 2D and 3D.

Counterpart of the JAX package's ops/pallas/kernels.py.  Each op has two
versions in this module:

* ``plain_blend`` / ``plain_splat``: plain PyTorch, ops/generic.py, any
  dtype.  They are the oracle the kernels are held to.
* ``blend`` / ``splat``: the wrappers of the hand-written CUDA kernels in
  csrc/blend_splat.cu.  Tensors on the CPU take the plain version; CUDA
  tensors launch the kernel on the current stream, or raise for what the
  kernel does not take.  Each wrapper counts its launches in its
  ``launches`` attribute.

The kernels compute in f32 whatever ``cfg.precision`` says, as the JAX
package's v1 kernels do (HIGHEST-precision contractions).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import SamplerConfig, effective_align
from ..coords import offset_lattice
from ..generic import blend as plain_blend
from ..generic import splat as plain_splat
from .build import (BLOCK_SMEM_BYTES, H100_SMS, RESERVED_SMEM_BYTES,
                    SM_SMEM_BYTES, check, load_kernels)
from .fused2w import KERNEL_IDS, PADDING_IDS, cuda_device

__all__ = ["BlendGeometry", "SplatGeometry", "blend", "blend_geometry",
           "launch_blend", "launch_pairs", "launch_splat", "plain_blend",
           "plain_splat", "splat", "splat_geometry"]


def _check_tensors(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(
                f"the CUDA blend_o/splat_o kernels take float32, got "
                f"{t.dtype}; backend='xla' computes other dtypes")
        if not t.is_contiguous():
            raise ValueError("the CUDA blend_o/splat_o kernels take "
                             "contiguous tensors")
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError("tensor too large for the kernels' 32-bit indexing")


def _check_shapes(cfg: SamplerConfig, n: int, spatial, grid, orders) -> int:
    """The query count Q of a grid that fits (N, C, *spatial) cells."""
    d = cfg.dim
    if (len(spatial) != d or grid.dim() != d + 2 or grid.shape[-1] != d
            or grid.shape[0] not in (1, n) or len(orders) != d
            or min(orders) < 0):
        raise ValueError(
            f"expected {d}D cells (N, C, *S), a grid (N or 1, ..., {d}) and "
            f"{d} orders >= 0, got spatial {tuple(spatial)}, grid "
            f"{tuple(grid.shape)} and orders {tuple(orders)}")
    return math.prod(grid.shape[1:-1])


def launch_pairs(entry: str, pointers, cfg: SamplerConfig, n: int, c: int,
                 spatial, q: int, grid_batch: int, orders, align: bool,
                 extra=()) -> None:
    """Call ``entry``, a C entry point of the blend_o / splat_o family
    (blend_o, splat_o, percell_*, slab_*), on the current stream of the
    device of ``pointers[0]``: the data pointers (None for a null one),
    then dim, n, c, d, h, w, q, grid batch, three orders, ``extra``
    (ints), the config flags, the offset lattice and the stream."""
    lib = load_kernels()
    if n * c * max(q, math.prod(spatial)) >= 2**31:
        raise ValueError("cells or queries too many for the kernels' 32-bit "
                         "indexing")
    d, h, w = (1, *spatial) if cfg.dim == 2 else spatial
    ox, oy, oz = (*orders, 0) if cfg.dim == 2 else orders
    step, stop = offset_lattice(n, cfg.multicell)
    device = pointers[0].device
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            *(0 if t is None else t.data_ptr() for t in pointers), cfg.dim,
            n, c, d, h, w, q, grid_batch, ox, oy, oz, *extra,
            KERNEL_IDS[cfg.kernel], PADDING_IDS[cfg.padding_mode],
            int(align), int(cfg.multicell),
            int(cfg.strict_reference), float(step), float(stop),
            torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, f"{entry} launch")


# the staged blend's mbarrier ahead of its cells (csrc/blend_splat.cu
# kBarrierBytes)
BARRIER_BYTES = 16


class BlendGeometry(NamedTuple):
    """One blend_o launch's geometry (csrc/blend_splat.cu): ``cells`` a
    block stages in shared memory (0: none, the unstaged kernel gathers
    the corners through L1 and L2), their layout there (``interleave``:
    the channels of a texel side by side, else channel planes), ``stride``
    floats a cell there, and ``q_blocks`` blocks along the queries, block
    y taking rounds y, y + q_blocks, ... of STAGED_THREADS queries."""
    cells: int
    interleave: bool
    stride: int
    q_blocks: int


# the staged blend_o's threads a block and the blocks an SM its registers
# allow (csrc/blend_splat.cu kStagedThreads, kStagedBlocksPerSm)
STAGED_THREADS = 512
STAGED_BLOCKS_PER_SM = 2
# the shared memory of a staged block's cells: up to 16 KB of small cells
# (4 of the 2D main path's 4 KB cells), or one larger cell
BLEND_CELL_BYTES = 16 * 1024
# waves of the blocks that fit the card at once a staged blend_o launch
# takes (chip_smoke.py blend_sweep_phase, PERF.md section 6)
BLEND_WAVES = 1
# a cell is staged when it has at least this many queries a texel: on
# 1024 x 4 x 16^3 cells staged against unstaged read 0.050 / 0.033-0.045
# ms at a sixteenth of a query a texel, within 10% either way at a
# quarter, 0.117 / 0.222 at one (chip_smoke.py blend_sweep_phase, PERF.md
# section 6)
STAGE_QUERIES_PER_TEXEL = 1


def blend_geometry(n: int, c: int, spatial, q: int,
                   sms: int = H100_SMS) -> BlendGeometry:
    """The geometry of blend_o over (N, C, *S) cells and Q queries a cell
    on a card of ``sms`` SMs.

    A cell over a block's BLOCK_SMEM_BYTES, or with fewer than
    STAGE_QUERIES_PER_TEXEL queries a texel, takes the unstaged kernel.
    Otherwise a block stages the most cells that BLEND_CELL_BYTES hold
    (at least one), channels interleaved where C is a multiple of 4 (one
    128-bit shared load serves a corner's 4 channels), and its blocks
    along the queries (no more than rounds of STAGED_THREADS queries)
    make BLEND_WAVES waves of the blocks that fit the card at once.  The
    unstaged kernel takes no geometry: one thread a pair."""
    texels = math.prod(spatial)
    stride = -(-c * texels // 4) * 4
    cell_bytes = 4 * stride
    if (BARRIER_BYTES + cell_bytes > BLOCK_SMEM_BYTES
            or q < STAGE_QUERIES_PER_TEXEL * texels):
        return BlendGeometry(0, False, c * texels, 1)
    cells = max(1, min(n, BLEND_CELL_BYTES // cell_bytes))
    # blocks an SM holds: by shared memory, and by registers
    per_sm = max(1, min(STAGED_BLOCKS_PER_SM, SM_SMEM_BYTES // (
        BARRIER_BYTES + cells * cell_bytes + RESERVED_SMEM_BYTES)))
    chunks = -(-n // cells)
    q_blocks = max(1, min(BLEND_WAVES * per_sm * sms // chunks,
                          -(-q // STAGED_THREADS), 65535))
    return BlendGeometry(cells, c % 4 == 0, stride, q_blocks)


def launch_blend(input: torch.Tensor, grid: torch.Tensor, cfg: SamplerConfig,
                 orders, geom: BlendGeometry) -> torch.Tensor:
    """blend_o of ``input`` at ``grid`` with the launch geometry ``geom``:
    (N, C, *out_spatial), on the card."""
    n, c, *spatial = input.shape
    out = torch.empty((n, c, *grid.shape[1:-1]), dtype=torch.float32,
                      device=input.device)
    # the strict-mode 2D align quirk applies to the order-0 gather only
    launch_pairs("blend_o", (input, grid, out), cfg, n, c, tuple(spatial),
                 math.prod(grid.shape[1:-1]), grid.shape[0], orders,
                 effective_align(cfg, orders),
                 extra=(geom.cells, int(geom.interleave), geom.stride,
                        geom.q_blocks))
    return out


def blend(input: torch.Tensor, grid: torch.Tensor, cfg: SamplerConfig,
          orders: Tuple[int, ...]) -> torch.Tensor:
    """(N, C, *out_spatial): generic.blend of (N, C, *S) cells at the grid
    (N or 1, *out_spatial, d); kernel on CUDA tensors, plain on CPU ones."""
    if input.device.type == "cpu" and grid.device.type == "cpu":
        return plain_blend(input, grid, cfg, orders)
    device = cuda_device(input, grid)
    _check_tensors(input, grid)
    n, c, *spatial = input.shape
    q = _check_shapes(cfg, n, spatial, grid, orders)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = launch_blend(input, grid, cfg, orders,
                       blend_geometry(n, c, spatial, q, sms))
    blend.launches += 1
    return out


class SplatGeometry(NamedTuple):
    """One splat_o launch's geometry (csrc/blend_splat.cu): ``cells`` a
    block accumulates in shared memory (0: none, global atomics into out),
    ``lanes`` of them a warp's lanes split over, ``stride`` floats a cell
    in shared memory, and ``q_blocks`` blocks of ``q_per_block`` queries
    along the queries."""
    cells: int
    lanes: int
    stride: int
    q_per_block: int
    q_blocks: int


# waves of the blocks that fit the card at once a splat_o launch takes
# (chip_smoke.py splat_sweep_phase, PERF.md section 6: on the 3D main
# path ~2.9 waves beat half and twice as many query blocks; on the 2D
# main path 1.5, 3 and 6 waves read within a run's spread of each other)
SPLAT_WAVES = 3


def splat_geometry(n: int, c: int, spatial, q: int,
                   sms: int = H100_SMS) -> SplatGeometry:
    """The geometry of splat_o over (N, C, *S) cells and Q queries on a
    card of ``sms`` SMs.

    A cell over a block's BLOCK_SMEM_BYTES takes global atomics, in blocks
    of at least 256 queries, about four a SM.  Otherwise a block holds
    ``lanes`` cells, the most (a power of two up to 8, and up to N) whose
    strides fit a third of an SM's shared memory, each stride padded to 4
    floats past a multiple of 32 when there are several (8 cells then sit
    in 8 distinct bank quads); and its blocks along the queries (at least
    256 queries each) make SPLAT_WAVES waves of the blocks that fit the
    card at once."""
    cell_elems = c * math.prod(spatial)
    if 4 * cell_elems > BLOCK_SMEM_BYTES:
        q_blocks = max(1, min(4 * sms, -(-q // 256), 65535))
        qpb = -(-q // q_blocks)
        return SplatGeometry(0, 1, cell_elems, qpb, -(-q // qpb))
    padded = (cell_elems + 27) // 32 * 32 + 4
    lanes = 1
    while (lanes < 8 and 2 * lanes <= n
           and 4 * 2 * lanes * padded <= SM_SMEM_BYTES // 3):
        lanes *= 2
    stride = cell_elems if lanes == 1 else padded
    # blocks an SM holds: by shared memory, and 2048 threads
    per_sm = max(1, min(8, SM_SMEM_BYTES
                        // (4 * lanes * stride + RESERVED_SMEM_BYTES)))
    chunks = -(-n // lanes)
    q_blocks = max(1, min(SPLAT_WAVES * per_sm * sms // chunks,
                          -(-q // 256), 65535))
    qpb = -(-q // q_blocks)
    return SplatGeometry(lanes, lanes, stride, qpb, -(-q // qpb))


def launch_splat(gout: torch.Tensor, grid: torch.Tensor, cfg: SamplerConfig,
                 in_spatial, orders, geom: SplatGeometry) -> torch.Tensor:
    """splat_o of ``gout`` at ``grid`` with the launch geometry ``geom``:
    (N, C, *in_spatial), on the card."""
    n, c = gout.shape[:2]
    out = torch.zeros((n, c, *in_spatial), dtype=torch.float32,
                      device=gout.device)
    launch_pairs("splat_o", (gout, grid, out), cfg, n, c, tuple(in_spatial),
                 math.prod(gout.shape[2:]), grid.shape[0], orders,
                 cfg.align_corners, extra=tuple(geom))
    return out


def splat(gout: torch.Tensor, grid: torch.Tensor,
          in_spatial: Tuple[int, ...], cfg: SamplerConfig,
          orders: Tuple[int, ...]) -> torch.Tensor:
    """(N, C, *in_spatial): generic.splat, the transpose of blend with
    respect to the input; kernel on CUDA tensors, plain on CPU ones."""
    if gout.device.type == "cpu" and grid.device.type == "cpu":
        return plain_splat(gout, grid, tuple(in_spatial), cfg, orders)
    device = cuda_device(gout, grid)
    _check_tensors(gout, grid)
    n, c = gout.shape[:2]
    q = _check_shapes(cfg, n, in_spatial, grid, orders)
    if math.prod(gout.shape[2:]) != q:
        raise ValueError(f"gout {tuple(gout.shape)} does not match the grid "
                         f"{tuple(grid.shape)}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = launch_splat(gout, grid, cfg, in_spatial, orders,
                       splat_geometry(n, c, in_spatial, q, sms))
    splat.launches += 1
    return out


blend.launches = 0
splat.launches = 0
