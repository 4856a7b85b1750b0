"""Bricked 3D fused blend and its transpose over a kernel-layout volume.

Counterpart of the JAX package's ops/pallas/fused3b.py, the route of large
3D volumes (BASELINE config 5: 16 cells x 4 ch x 128^3 at 1M points):

* **The brick plan** (``make_plan``): the JAX package's ``_brick_bin`` in
  torch ops, bit-equal to it.  Queries are sorted by the bin key
  (z slab, y group of ``gy`` rows) of their shared floor, each bin padded
  to whole blocks of ``q_block`` slots, and the plan is the 6-tuple
  ``(positions, occ, z0, y0, hasv, pts_p)``: each query's slot, the (QP,)
  real-slot mask, each block's brick origin, whether the block holds a
  real query, and the points in slot order.  It is built once per fixed
  point set.
* **The kernel layout** of the volume is (D, H, W, N, C): the cells
  (N, C, D, H, W) permuted so that one texel's N * C values lie together,
  with no pad slots.  A query reads a cell's C channels at a corner as
  one 16-byte load at C = 4, and its transpose adds them with one vector
  atomic.  The TPU layout's 128-lane W padding, sublane-padded N and
  z/y front pads exist for its DMA tiling and are not carried over.
  ``cells_to_vol`` / ``vol_to_cells`` move a tensor between the two
  layouts, differentiably: on the card through the tiled transpose of
  csrc/fused3s.cu (``transpose_layout``, counted in its ``launches``),
  on the CPU through torch's permuted copy (``plain_cells_to_vol`` /
  ``plain_vol_to_cells``, the plain versions the kernel is held to).
* ``plain_fused3b_blend_vol`` / ``plain_fused3b_bwd_vol``: plain PyTorch,
  the fused rows of ops/cuda/fused2w.py over the plan's slot-ordered
  points, masked by ``occ``.  They are the oracle the kernels are held to.
* ``fused3b_blend_vol`` / ``fused3b_bwd_vol``: the wrappers of the
  hand-written CUDA kernels in csrc/fused3b.cu, over the shared gather
  (csrc/texel_gather.cuh, layouts ops/cuda/gather.py) and scatter
  (csrc/texel_scatter.cuh, ops/cuda/scatter.py).  A tensor on the CPU takes
  the plain version; a CUDA tensor launches the kernel on the current
  stream, or raises for what the kernel does not take.  Each wrapper
  counts its launches in its ``launches`` attribute.

The kernels gather and scatter anywhere in the volume; the plan only
orders the queries, so that the queries of one block share one brick of
it and their gathers and atomics stay in L2.

**The ghost path** (the JAX package's ``ghost=True``,
``_fused3b_bwd_ghost_kernel`` with its fold ``_fold_bricks``): the same
volume cotangent, accumulated per *super-brick* (one z slab of the plan
times ``rb`` consecutive y bins) into a private brick, then folded onto
the volume.  ``ghost_plan`` numbers the blocks' super-bricks as JAX does;
``plain_fused3b_bwd_ghost_vol`` accumulates and folds with torch ops and
the index math of the CUDA pair (csrc/fused3b_ghost.cu), which
``fused3b_bwd_ghost_vol`` wraps.  ``fused3b_bwd_vol(..., ghost=None)``
takes it where ``GHOST_ROUTE`` says so and the bricks fit
``GHOST_BUDGET_BYTES``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import SamplerConfig
from ..coords import clip_coordinates, reflect_coordinates, unnormalize
from .build import BLOCK_SMEM_BYTES, check, load_kernels
from .fused2w import (check_kernel_inputs, cuda_device, plain_fused_blend,
                      plain_fused_bwd, sampler_args)
from .gather import GatherGeometry, gather_geometry
from .scatter import ScatterGeometry, scatter_geometry

__all__ = ["cells_to_vol", "fold_bricks", "fused3b_blend_vol",
           "fused3b_bwd_ghost_vol", "fused3b_bwd_vol", "ghost_bricks",
           "ghost_fits", "ghost_plan", "launch_blend", "launch_bwd",
           "make_plan", "plain_cells_to_vol", "plain_fold_bricks",
           "plain_fused3b_blend_vol", "plain_fused3b_bwd_ghost_vol",
           "plain_fused3b_bwd_vol", "plain_ghost_bricks", "plain_vol_to_cells",
           "supports", "transpose_layout", "vol_layout", "vol_to_cells"]

# the JAX package's defaults (fused3b.V3B_Q_BLOCK, V3B_GY): slots per plan
# block, and y rows per bin; csrc/fused3b.cu runs one CUDA block of
# Q_BLOCK threads per plan block
Q_BLOCK = 128
GY = 2
# fewest queries per bin the route takes (fused3b._MIN_Q_PER_BIN): below
# it the padding blocks outnumber the real ones
MIN_Q_PER_BIN = 2
# y bins per super-brick of the ghost path (JAX: V3B_RB = 8, cut by its
# VMEM fit).  Here rb sets the bricks' bytes, nsh * (rb * GY + fp) /
# (rb * GY) times the volume's, and the blocks' count: at config 5 rb = 8
# was the fastest of 1, 2, 4 and 8 (chip_smoke.py ghost_time_phase,
# PERF.md section 6)
GHOST_RB = 8
# the most bytes of private bricks the ghost path allocates; above it
# fused3b_bwd_vol takes fused3b_bwd.  JAX's _GHOST_HBM_BUDGET (6 << 30)
# counted the same bricks in its padded TPU layout (W to 128 lanes, N to
# 8 sublanes), which only adds bytes: the same 6 GiB of the port's
# unpadded bricks admits every shape JAX's admits
GHOST_BUDGET_BYTES = 6 << 30
# whether fused3b_bwd_vol(ghost=None) takes the ghost path where it fits:
# opt-in, as in JAX, unless the card shows it faster than fused3b_bwd at
# config 5 (PERF.md section 6)
GHOST_ROUTE = False


def _geom(d: int, h: int, gy: int):
    """(nby, nbz, nbins): y groups, z slabs and bins of a (D, H, W) volume
    (fused3b._geom; a far out-of-bounds query is clipped into the edge
    bins)."""
    nby = -(-(h + 2) // gy)
    nbz = d + 2
    return nby, nbz, nby * nbz


def supports(cfg: SamplerConfig, cells_shape, n_queries=None) -> bool:
    """Whether the bricked kernels take this config and (N, C, D, H, W)
    shape: 3D, any padding, any channel count (csrc/fused3b.cu walks
    channel groups of at most 8 on a grid axis), and at least
    MIN_Q_PER_BIN queries per bin.  The TPU kernel's VMEM and lane gates
    do not apply on the card."""
    if cfg.dim != 3 or len(cells_shape) != 5:
        return False
    _, _, d, h, _ = cells_shape
    nbins = _geom(d, h, GY)[2]
    return n_queries is None or n_queries >= MIN_Q_PER_BIN * nbins


def bin_base(coord, size: int, cfg: SamplerConfig):
    """The folded shared base the queries are binned on (prep.bin_base):
    the source coordinate before the per-cell shift, clipped (border) or
    reflected and clipped (reflection) as the sampler folds it."""
    base, _ = unnormalize(coord, size, cfg.align_corners, cfg.multicell, 0.0)
    if cfg.padding_mode == "border":
        base, _ = clip_coordinates(base, size)
    elif cfg.padding_mode == "reflection":
        eff = size - 1 if (cfg.multicell or cfg.strict_reference) else size
        if cfg.align_corners:
            base, _ = reflect_coordinates(base, 0, 2 * (eff - 1))
        else:
            base, _ = reflect_coordinates(base, -1, 2 * size - 1)
        base, _ = clip_coordinates(base, size)
    return base


def make_plan(points, in_spatial, cfg: SamplerConfig, q_block: int = Q_BLOCK,
              gy: int = GY):
    """The brick plan of a fixed (Q, 3) point set over a (D, H, W) volume:
    ``(positions, occ, z0, y0, hasv, pts_p)`` with the values of the JAX
    package's ``fused3b.make_plan``.

    ``positions`` (Q,) int64 is each query's slot; ``occ`` (QP,) f32 the
    real-slot mask; ``z0``, ``y0`` (QP / q_block,) int32 each block's brick
    origin in the TPU kernel's padded volume (z0 = fz + 2, y0 = group *
    gy); ``hasv`` (QP / q_block,) int32 whether the block holds a real
    query; ``pts_p`` (QP, 3) the points in slot order, zero in pad slots,
    in the points' dtype.  QP is the static bound (cdiv(Q, q_block) +
    nbins) * q_block; ops/fused.py's trim_plan cuts it to the used prefix.

    The bin key is computed from the points cast to f32, as the JAX
    package does.  Within a bin the queries keep their order: a stable
    sort gives what both of the JAX package's branches give (its one-hot
    rank and its stable ``lax.sort_key_val``).
    """
    d, h, _ = in_spatial
    points = points.detach()
    q = points.shape[0]
    device = points.device
    nby, nbz, nbins = _geom(d, h, gy)
    p32 = points.to(torch.float32)
    fz = torch.floor(bin_base(p32[:, 2], d, cfg)).to(torch.int32)
    fy = torch.floor(bin_base(p32[:, 1], h, cfg)).to(torch.int32)
    bz = torch.clamp(fz + 2, 0, nbz - 1)
    by = torch.clamp(torch.div(fy + 2, gy, rounding_mode="floor"), 0,
                     nby - 1)
    key = (bz * nby + by).to(torch.int64)
    qp = (-(-q // q_block) + nbins) * q_block
    nblocks = qp // q_block

    counts = torch.bincount(key, minlength=nbins)
    padded = (counts + q_block - 1) // q_block * q_block
    offs = torch.cumsum(padded, 0) - padded          # each bin's first slot
    starts = torch.cumsum(counts, 0) - counts        # its first sorted rank
    skey, perm = torch.sort(key, stable=True)
    rank = torch.arange(q, device=device) - starts[skey]
    positions = torch.empty((q,), dtype=torch.int64, device=device)
    positions[perm] = offs[skey] + rank

    # each block's bin: +1 at every bin's first block, running sum; a
    # zero-width bin stacks its mark on its successor's and owns no block
    first = offs // q_block
    mark = torch.zeros((nblocks,), dtype=torch.int64, device=device)
    keep = first < nblocks
    mark.index_add_(0, first[keep], torch.ones_like(first[keep]))
    bbin = torch.clamp(torch.cumsum(mark, 0) - 1, max=nbins - 1)
    z0 = (bbin // nby).to(torch.int32)
    y0 = (bbin % nby * gy).to(torch.int32)
    # real slots: +1 at each bin's first slot, -1 one past its last real one
    step = torch.zeros((qp + 1,), dtype=torch.int64, device=device)
    step.index_add_(0, offs, torch.ones_like(offs))
    step.index_add_(0, offs + counts, -torch.ones_like(offs))
    occ = torch.cumsum(step, 0)[:qp].to(torch.float32)
    hasv = (occ[::q_block] > 0).to(torch.int32)
    pts_p = torch.zeros((qp, 3), dtype=points.dtype, device=device)
    pts_p[positions] = points
    return positions, occ, z0, y0, hasv, pts_p


def vol_layout(n: int, c: int, in_spatial) -> Tuple[int, ...]:
    """Shape of the kernel-layout volume of N cells of C channels over
    (D, H, W): (D, H, W, N, C)."""
    return (*in_spatial, n, c)


def plain_cells_to_vol(cells: torch.Tensor) -> torch.Tensor:
    """(N, C, *S) -> the kernel layout (*S, N, C), S of 2 or 3 axes, a new
    tensor: torch's permuted copy, the plain version of cells_to_vol."""
    d = cells.dim() - 2
    return cells.permute(*range(2, 2 + d), 0, 1).clone(
        memory_format=torch.contiguous_format)


def plain_vol_to_cells(vol: torch.Tensor) -> torch.Tensor:
    """Kernel layout (*S, N, C) -> (N, C, *S), a new tensor: the plain
    version of vol_to_cells."""
    d = vol.dim() - 2
    return vol.permute(d, d + 1, *range(d)).clone(
        memory_format=torch.contiguous_format)


def transpose_layout(x: torch.Tensor, to_vol: bool) -> torch.Tensor:
    """The layout move of a contiguous f32 or f64 CUDA tensor by the tiled
    transpose kernel (csrc/fused3s.cu ``texel_transpose``): (N, C, *S) ->
    (*S, N, C) where ``to_vol``, the other way otherwise, S of 2 or 3
    axes; bit for bit.  Counts its launches in ``launches``."""
    cuda_device(x)
    if x.dim() not in (4, 5):
        raise ValueError(f"the layout move takes a 4-D or 5-D tensor; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the layout move takes float32 or float64, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the layout move takes a contiguous tensor")
    if to_vol:
        n, c, *spatial = x.shape
        rows, cols, shape = n * c, math.prod(spatial), (*spatial, n, c)
    else:
        *spatial, n, c = x.shape
        rows, cols, shape = math.prod(spatial), n * c, (n, c, *spatial)
    if max(rows, cols) >= 2**31:
        raise ValueError("too many rows or columns for the layout move")
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        err = lib.texel_transpose(
            x.data_ptr(), out.data_ptr(), rows, cols, x.element_size(),
            torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, "texel_transpose launch")
    transpose_layout.launches += 1
    return out


def _move(x: torch.Tensor, to_vol: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_cells_to_vol(x) if to_vol else plain_vol_to_cells(x)
    return transpose_layout(x, to_vol)


class _LayoutMove(torch.autograd.Function):
    """The layout move, whose backward is the move the other way."""

    @staticmethod
    def forward(ctx, x, to_vol):
        ctx.to_vol = to_vol
        return _move(x, to_vol)

    @staticmethod
    def backward(ctx, g):
        return _LayoutMove.apply(g.contiguous(), not ctx.to_vol), None


def cells_to_vol(cells: torch.Tensor) -> torch.Tensor:
    """(N, C, *S) -> the kernel layout (*S, N, C) (3D: (D, H, W, N, C)); a
    pure permutation, differentiable: the transpose kernel on a CUDA
    tensor, plain_cells_to_vol on a CPU one."""
    return _LayoutMove.apply(cells, True)


def vol_to_cells(vol: torch.Tensor) -> torch.Tensor:
    """Kernel layout (*S, N, C) -> (N, C, *S); the inverse of
    cells_to_vol, the same way."""
    return _LayoutMove.apply(vol, False)


def plain_fused3b_blend_vol(vol, plan, cfg: SamplerConfig):
    """(7, C, QP) fused rows at the plan's slots, zero in pad slots."""
    occ, pts_p = plan[1], plan[5]
    out = plain_fused_blend(plain_vol_to_cells(vol), pts_p, cfg)
    return out * occ.to(out.dtype)


def plain_fused3b_bwd_vol(g_p, plan, in_spatial, cfg: SamplerConfig,
                          n_cells: int):
    """Kernel-layout volume cotangent of plain_fused3b_blend_vol for the
    (7, C, QP) slot cotangent ``g_p``; pad slots add nothing."""
    occ, pts_p = plan[1], plan[5]
    dcells = plain_fused_bwd(g_p * occ.to(g_p.dtype), pts_p,
                             tuple(in_spatial), cfg, n_cells)
    return plain_cells_to_vol(dcells)


def _plan_args(plan, qp_tensor: torch.Tensor):
    """occ, hasv and pts_p of ``plan``, checked against the slot count of
    ``qp_tensor`` (its last dimension) for the kernels."""
    _, occ, _, _, hasv, pts_p = plan
    qp = qp_tensor.shape[-1]
    if (occ.shape != (qp,) or pts_p.shape != (qp, 3) or qp % Q_BLOCK
            or hasv.shape != (qp // Q_BLOCK,)):
        raise ValueError(
            f"the plan does not match {qp} slots of {Q_BLOCK}-slot blocks: "
            f"occ {tuple(occ.shape)}, hasv {tuple(hasv.shape)}, pts_p "
            f"{tuple(pts_p.shape)}")
    if hasv.dtype != torch.int32 or not hasv.is_contiguous():
        raise ValueError("the plan's hasv must be contiguous int32")
    return occ, hasv, pts_p


def _launch(entry: str, first: torch.Tensor, plan, out: torch.Tensor,
            cfg: SamplerConfig, vol_shape, qp_tensor: torch.Tensor,
            extra=()) -> None:
    occ, hasv, pts_p = _plan_args(plan, qp_tensor)
    cuda_device(first, occ, hasv, pts_p, out)
    check_kernel_inputs(cfg, first, occ, pts_p)
    if cfg.dim != 3 or len(vol_shape) != 5:
        raise ValueError(f"{entry} takes a 3D config and a (D, H, W, N, C) "
                         f"volume; got dim {cfg.dim}, {tuple(vol_shape)}")
    d, h, w, n, c = vol_shape
    lib = load_kernels()
    if math.prod(vol_shape) >= 2**31:
        raise ValueError("volume too large for the kernels' 32-bit indexing")
    with torch.cuda.device(out.device):
        err = getattr(lib, entry)(
            first.data_ptr(), pts_p.data_ptr(), occ.data_ptr(),
            hasv.data_ptr(), out.data_ptr(), n, c, d, h, w,
            qp_tensor.shape[-1], *extra, *sampler_args(cfg, n, out.device))
    check(lib, err, f"{entry} launch")


def fused3b_blend_vol(vol: torch.Tensor, plan,
                      cfg: SamplerConfig) -> torch.Tensor:
    """(7, C, QP) slot-ordered fused rows of the kernel-layout volume
    (D, H, W, N, C) at the plan's slots, zero in pad slots; kernel on CUDA
    tensors, plain on CPU ones."""
    if vol.device.type == "cpu" and plan[5].device.type == "cpu":
        return plain_fused3b_blend_vol(vol, plan, cfg)
    if vol.dim() != 5:
        raise ValueError(f"fused3b_blend takes a (D, H, W, N, C) volume; "
                         f"got {tuple(vol.shape)}")
    out = launch_blend(vol, plan, cfg, gather_geometry(
        vol.shape[3], vol.shape[4], bricked=True))
    fused3b_blend_vol.launches += 1
    return out


def launch_blend(vol: torch.Tensor, plan, cfg: SamplerConfig,
                 geom: GatherGeometry) -> torch.Tensor:
    """fused3b_blend_vol's kernel with the launch layout ``geom``
    (ops/cuda/gather.py), on the card; not counted."""
    out = torch.empty((7, vol.shape[-1], plan[1].shape[0]),
                      dtype=torch.float32, device=vol.device)
    _launch("fused3b_blend", vol, plan, out, cfg, tuple(vol.shape), out,
            geom.args())
    return out


def fused3b_bwd_vol(g_p: torch.Tensor, plan, in_spatial: Tuple[int, ...],
                    cfg: SamplerConfig, n_cells: int,
                    ghost: Optional[bool] = None) -> torch.Tensor:
    """Kernel-layout (D, H, W, N, C) cotangent of fused3b_blend_vol for the
    (7, C, QP) slot cotangent ``g_p``; kernel on CUDA tensors, plain on CPU
    ones.  ``ghost`` (None: GHOST_ROUTE) takes fused3b_bwd_ghost_vol where
    its bricks fit (ghost_fits), as JAX's ``ghost`` does."""
    if ((GHOST_ROUTE if ghost is None else ghost)
            and ghost_fits(cfg, vol_layout(n_cells, g_p.shape[1],
                                           in_spatial))):
        return fused3b_bwd_ghost_vol(g_p, plan, in_spatial, cfg, n_cells)
    if g_p.device.type == "cpu" and plan[5].device.type == "cpu":
        return plain_fused3b_bwd_vol(g_p, plan, in_spatial, cfg, n_cells)
    dvol = launch_bwd(g_p, plan, in_spatial, cfg, n_cells,
                      scatter_geometry(n_cells, g_p.shape[1]))
    fused3b_bwd_vol.launches += 1
    return dvol


def launch_bwd(g_p: torch.Tensor, plan, in_spatial: Tuple[int, ...],
               cfg: SamplerConfig, n_cells: int,
               geom: ScatterGeometry) -> torch.Tensor:
    """fused3b_bwd_vol's kernel with the launch layout ``geom``
    (ops/cuda/scatter.py), on the card; not counted."""
    if g_p.dim() != 3 or g_p.shape[0] != 7 or len(in_spatial) != 3:
        raise ValueError(f"fused3b_bwd takes g_p (7, C, QP) and 3 spatial "
                         f"sizes; got {tuple(g_p.shape)}, {tuple(in_spatial)}")
    shape = vol_layout(n_cells, g_p.shape[1], in_spatial)
    dvol = torch.zeros(shape, dtype=torch.float32, device=g_p.device)
    _launch("fused3b_bwd", g_p, plan, dvol, cfg, shape, g_p, geom.args())
    return dvol


def fused3b_bwd_ghost_vol(g_p: torch.Tensor, plan,
                          in_spatial: Tuple[int, ...], cfg: SamplerConfig,
                          n_cells: int, rb: int = GHOST_RB) -> torch.Tensor:
    """fused3b_bwd_vol's result through private super-bricks and the fold
    (the ghost kernel and its fold, csrc/fused3b_ghost.cu); kernels on
    CUDA tensors, plain_fused3b_bwd_ghost_vol on CPU ones."""
    if g_p.device.type == "cpu" and plan[5].device.type == "cpu":
        return plain_fused3b_bwd_ghost_vol(g_p, plan, in_spatial, cfg,
                                           n_cells, rb)
    gplan = ghost_plan(plan, in_spatial, rb)
    bricks = ghost_bricks(g_p, plan, gplan, in_spatial, cfg, n_cells, rb)
    dvol = fold_bricks(bricks, gplan[3], in_spatial, cfg, rb)
    fused3b_bwd_ghost_vol.launches += 1
    return dvol


transpose_layout.launches = 0
fused3b_blend_vol.launches = 0
fused3b_bwd_vol.launches = 0
fused3b_bwd_ghost_vol.launches = 0


# --- the ghost path -----------------------------------------------------------

class _GhostGeom(NamedTuple):
    """The super-bricks of a (D, H, W) volume: in coordinates padded by
    ``fp`` texels in front of z and y, super-brick sbi = ysb * nbz + z0
    covers slabs [z0, z0 + nsh) and rows [ysb * own, ysb * own + rows_s)."""
    nbz: int
    nysb: int
    own: int
    rows_s: int
    fp: int
    nsh: int

    @property
    def nsb(self) -> int:
        return self.nbz * self.nysb


def _ghost_geom(cfg: SamplerConfig, in_spatial, rb: int,
                gy: int = GY) -> _GhostGeom:
    """prep.front_pad / n_shifts and fused3b's super-brick geometry: a
    query's corners span nsh = fp + 1 texels from its bin's padded
    origin."""
    d, h, _ = in_spatial
    nby, nbz, _ = _geom(d, h, gy)
    fp = 3 if cfg.padding_mode == "reflection" else 2
    return _GhostGeom(nbz=nbz, nysb=-(-nby // rb), own=rb * gy,
                      rows_s=rb * gy + fp, fp=fp, nsh=fp + 1)


def _group_width(c: int) -> int:
    """csrc/fused_rows.cuh group_width: channels of one group of <= 8."""
    return -(-c // -(-c // 8))


def ghost_fits(cfg: SamplerConfig, vol_shape, rb: int = GHOST_RB) -> bool:
    """Whether the ghost path takes a (D, H, W, N, C) volume: its bricks
    within GHOST_BUDGET_BYTES and one cell of one channel group's brick
    within a block's shared memory (csrc/fused3b_ghost.cu)."""
    d, h, w, n, c = vol_shape
    g = _ghost_geom(cfg, (d, h, w), rb)
    brick = g.nsh * g.rows_s * w * n * c * 4
    return (g.nsb * brick <= GHOST_BUDGET_BYTES
            and g.nsh * g.rows_s * w * _group_width(c) * 4
            <= BLOCK_SMEM_BYTES)


def ghost_plan(plan, in_spatial, rb: int = GHOST_RB, gy: int = GY):
    """``(sbi, first, last, visited)`` of a brick plan: each block's
    super-brick (int32, (nblocks,)), each super-brick's first and last
    block and whether a block maps to it (int32, (nsb,)), on the plan's
    device, with no host sync.

    As JAX's _bwd3b_from_slots: sbi = (y0 // gy // rb) * nbz + z0, and the
    blocks without a real query (the plan's tail) take the last real
    block's super-brick."""
    z0, y0, hasv = plan[2].long(), plan[3].long(), plan[4].long()
    d, h, _ = in_spatial
    nby, nbz, _ = _geom(d, h, gy)
    nsb = nbz * -(-nby // rb)
    nblocks = hasv.shape[0]
    dev = hasv.device
    bi = torch.arange(nblocks, dtype=torch.int64, device=dev)
    sbi = (y0 // gy // rb) * nbz + z0
    last_real = sbi[torch.clamp(torch.max(bi * hasv), min=0)]
    sbi = torch.where(hasv > 0, sbi, last_real)
    visited = torch.zeros((nsb,), dtype=torch.int32, device=dev)
    visited.scatter_(0, sbi, 1)
    first = torch.full((nsb,), nblocks, dtype=torch.int64,
                       device=dev).scatter_reduce_(0, sbi, bi, "amin")
    last = torch.full((nsb,), -1, dtype=torch.int64,
                      device=dev).scatter_reduce_(0, sbi, bi, "amax")
    return sbi.int(), first.int(), last.int(), visited


def plain_ghost_bricks(g_p, plan, gplan, in_spatial, cfg: SamplerConfig,
                       n_cells: int, rb: int = GHOST_RB):
    """(nsb, nsh, rows_s, W, N, C) private bricks: brick sbi holds the
    kernel-layout cotangent of its blocks' real slots over its window of
    the padded volume.  Bricks no block visits are NaN, as the kernel
    leaves them uninitialized; a contribution outside its brick raises
    (the kernel would drop it).

    The super-bricks are taken in classes whose windows lie apart (z0
    modulo 2 nsh, ysb modulo 1 + ceil(rows_s / own)), one plain_fused_bwd
    per class: a corner that left its window would land between the
    class's windows, where the check finds it."""
    d, h, w = in_spatial
    c = g_p.shape[1]
    occ, pts_p = plan[1], plan[5]
    sbi, _, _, visited = gplan
    g = _ghost_geom(cfg, in_spatial, rb)
    dev = g_p.device
    bricks = torch.full((g.nsb, g.nsh, g.rows_s, w, n_cells, c), math.nan,
                        dtype=g_p.dtype, device=dev)
    my = 1 + -(-g.rows_s // g.own)
    sb_all = torch.arange(g.nsb, device=dev)
    sb_class = sb_all % g.nbz % (2 * g.nsh) * my + sb_all // g.nbz % my
    slot_sb = sbi.long().repeat_interleave(Q_BLOCK)
    live = occ > 0
    for k in range(2 * g.nsh * my):
        sbs = torch.nonzero((sb_class == k) & (visited > 0)).flatten()
        if sbs.numel() == 0:
            continue
        idx = torch.nonzero(live & (sb_class[slot_sb] == k)).flatten()
        part = plain_cells_to_vol(plain_fused_bwd(
            g_p[:, :, idx], pts_p[idx], tuple(in_spatial), cfg, n_cells))
        # the padded volume: fp in front of z and y, room behind for the
        # last windows
        pad = part.new_zeros((g.nbz + g.nsh, g.nysb * g.own + g.rows_s,
                              w, n_cells, c))
        pad[g.fp:g.fp + d, g.fp:g.fp + h] = part
        zi = (sbs % g.nbz)[:, None, None] + torch.arange(
            g.nsh, device=dev)[None, :, None]
        yi = (sbs // g.nbz * g.own)[:, None, None] + torch.arange(
            g.rows_s, device=dev)[None, None, :]
        bricks[sbs] = pad[zi, yi]
        pad[zi, yi] = 0
        if pad.abs().max() > 0:
            raise AssertionError(
                "a corner falls outside its super-brick's window")
    return bricks


def plain_fold_bricks(bricks, visited, in_spatial, cfg: SamplerConfig,
                      rb: int = GHOST_RB):
    """(D, H, W, N, C): each texel's sum over the bricks that cover it,
    the owning y-brick first, then those whose spill rows reach it, z
    shifts in order (csrc/fused3b_ghost.cu fold_kernel's order); unvisited
    bricks are selected out, never multiplied."""
    d, h, _ = in_spatial
    g = _ghost_geom(cfg, in_spatial, rb)
    dev = bricks.device
    pz = torch.arange(d, device=dev) + g.fp
    py = torch.arange(h, device=dev) + g.fp
    out = bricks.new_zeros((d, h, *bricks.shape[3:]))
    for dsb in range(1 + -(-g.fp // g.own)):
        ysb = py // g.own - dsb
        row = py - ysb * g.own
        yok = (ysb >= 0) & (ysb < g.nysb) & (row < g.rows_s)
        for k in range(g.nsh):
            zs = pz - k
            zok = (zs >= 0) & (zs < g.nbz)
            sb = (ysb[None, :] * g.nbz + zs[:, None]).clamp(0, g.nsb - 1)
            ok = zok[:, None] & yok[None, :] & (visited[sb] > 0)
            vals = bricks[sb, k, row.clamp(0, g.rows_s - 1)[None, :]]
            out = out + torch.where(ok[..., None, None, None], vals, 0.0)
    return out


def plain_fused3b_bwd_ghost_vol(g_p, plan, in_spatial, cfg: SamplerConfig,
                                n_cells: int, rb: int = GHOST_RB):
    """plain_fused3b_bwd_vol's result through plain_ghost_bricks and
    plain_fold_bricks."""
    gplan = ghost_plan(plan, in_spatial, rb)
    bricks = plain_ghost_bricks(g_p, plan, gplan, in_spatial, cfg, n_cells,
                                rb)
    return plain_fold_bricks(bricks, gplan[3], in_spatial, cfg, rb)


def ghost_bricks(g_p: torch.Tensor, plan, gplan, in_spatial,
                 cfg: SamplerConfig, n_cells: int,
                 rb: int = GHOST_RB) -> torch.Tensor:
    """plain_ghost_bricks' bricks from the ghost kernel on CUDA tensors
    (unvisited bricks uninitialized), the plain version on CPU ones."""
    if g_p.device.type == "cpu" and plan[5].device.type == "cpu":
        return plain_ghost_bricks(g_p, plan, gplan, in_spatial, cfg, n_cells,
                                  rb)
    d, h, w = in_spatial
    c = g_p.shape[1]
    if g_p.dim() != 3 or g_p.shape[0] != 7:
        raise ValueError(f"fused3b_bwd_ghost takes g_p (7, C, QP); got "
                         f"{tuple(g_p.shape)}")
    if not ghost_fits(cfg, vol_layout(n_cells, c, in_spatial), rb):
        raise ValueError("the ghost path does not take this volume "
                         "(ghost_fits)")
    occ, hasv, pts_p = _plan_args(plan, g_p)
    sbi, first, last, visited = gplan
    cuda_device(g_p, occ, hasv, pts_p, sbi, first, last, visited)
    check_kernel_inputs(cfg, g_p, occ, pts_p)
    g = _ghost_geom(cfg, in_spatial, rb)
    if visited.shape != (g.nsb,) or sbi.shape != hasv.shape:
        raise ValueError("the ghost plan does not match the plan and rb")
    bricks = torch.empty((g.nsb, g.nsh, g.rows_s, w, n_cells, c),
                         dtype=torch.float32, device=g_p.device)
    lib = load_kernels()
    with torch.cuda.device(g_p.device):
        err = lib.fused3b_bwd_ghost(
            g_p.data_ptr(), pts_p.data_ptr(), occ.data_ptr(), hasv.data_ptr(),
            sbi.data_ptr(), first.data_ptr(), last.data_ptr(),
            visited.data_ptr(), bricks.data_ptr(), n_cells, c, d, h, w,
            g_p.shape[-1], g.nsb, g.nbz, g.nysb, g.own, g.rows_s, g.fp, g.nsh,
            *sampler_args(cfg, n_cells, g_p.device))
    check(lib, err, "fused3b_bwd_ghost launch")
    return bricks


def fold_bricks(bricks: torch.Tensor, visited: torch.Tensor, in_spatial,
                cfg: SamplerConfig, rb: int = GHOST_RB) -> torch.Tensor:
    """plain_fold_bricks from the fold kernel on CUDA tensors, the plain
    version on CPU ones."""
    if bricks.device.type == "cpu" and visited.device.type == "cpu":
        return plain_fold_bricks(bricks, visited, in_spatial, cfg, rb)
    cuda_device(bricks, visited)
    d, h, w = in_spatial
    g = _ghost_geom(cfg, in_spatial, rb)
    n, c = bricks.shape[-2:]
    if (bricks.shape != (g.nsb, g.nsh, g.rows_s, w, n, c)
            or visited.shape != (g.nsb,) or visited.dtype != torch.int32):
        raise ValueError("the bricks do not match the volume and rb")
    if d * h * w * n * c >= 2**31:
        raise ValueError("volume too large for the kernels' 32-bit indexing")
    dvol = torch.empty((d, h, w, n, c), dtype=torch.float32,
                       device=bricks.device)
    lib = load_kernels()
    with torch.cuda.device(bricks.device):
        err = lib.fused3b_ghost_fold(
            bricks.data_ptr(), visited.data_ptr(), dvol.data_ptr(), n, c, d,
            h, w, g.nbz, g.nysb, g.own, g.rows_s, g.fp, g.nsh,
            torch.cuda.current_stream(bricks.device).cuda_stream)
    check(lib, err, "fused3b_ghost_fold launch")
    return dvol
