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
* ``plain_fused3b_blend_vol`` / ``plain_fused3b_bwd_vol``: plain PyTorch,
  the fused rows of ops/cuda/fused2w.py over the plan's slot-ordered
  points, masked by ``occ``.  They are the oracle the kernels are held to.
* ``fused3b_blend_vol`` / ``fused3b_bwd_vol``: the wrappers of the
  hand-written CUDA kernels in csrc/fused3b.cu.  A tensor on the CPU takes
  the plain version; a CUDA tensor launches the kernel on the current
  stream, or raises for what the kernel does not take.  Each wrapper
  counts its launches in its ``launches`` attribute.

The kernels gather and scatter anywhere in the volume; the plan only
orders the queries, so that the queries of one block share one brick of
it and their gathers and atomics stay in L2.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import SamplerConfig
from ..coords import clip_coordinates, reflect_coordinates, unnormalize
from .build import check, load_kernels
from .fused2w import (check_kernel_inputs, cuda_device, plain_fused_blend,
                      plain_fused_bwd, sampler_args)

__all__ = ["cells_to_vol", "fused3b_blend_vol", "fused3b_bwd_vol",
           "make_plan", "plain_fused3b_blend_vol", "plain_fused3b_bwd_vol",
           "supports", "vol_layout", "vol_to_cells"]

# the JAX package's defaults (fused3b.V3B_Q_BLOCK, V3B_GY): slots per plan
# block, and y rows per bin; csrc/fused3b.cu runs one CUDA block of
# Q_BLOCK threads per plan block
Q_BLOCK = 128
GY = 2
# fewest queries per bin the route takes (fused3b._MIN_Q_PER_BIN): below
# it the padding blocks outnumber the real ones
MIN_Q_PER_BIN = 2


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


def cells_to_vol(cells: torch.Tensor) -> torch.Tensor:
    """(N, C, D, H, W) -> the kernel layout (D, H, W, N, C); a pure
    permutation, differentiable."""
    return cells.permute(2, 3, 4, 0, 1).contiguous()


def vol_to_cells(vol: torch.Tensor) -> torch.Tensor:
    """Kernel layout (D, H, W, N, C) -> (N, C, D, H, W); the inverse of
    cells_to_vol."""
    return vol.permute(3, 4, 0, 1, 2).contiguous()


def plain_fused3b_blend_vol(vol, plan, cfg: SamplerConfig):
    """(7, C, QP) fused rows at the plan's slots, zero in pad slots."""
    occ, pts_p = plan[1], plan[5]
    out = plain_fused_blend(vol_to_cells(vol), pts_p, cfg)
    return out * occ.to(out.dtype)


def plain_fused3b_bwd_vol(g_p, plan, in_spatial, cfg: SamplerConfig,
                          n_cells: int):
    """Kernel-layout volume cotangent of plain_fused3b_blend_vol for the
    (7, C, QP) slot cotangent ``g_p``; pad slots add nothing."""
    occ, pts_p = plan[1], plan[5]
    dcells = plain_fused_bwd(g_p * occ.to(g_p.dtype), pts_p,
                             tuple(in_spatial), cfg, n_cells)
    return cells_to_vol(dcells)


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
            cfg: SamplerConfig, vol_shape, qp_tensor: torch.Tensor) -> None:
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
            qp_tensor.shape[-1], *sampler_args(cfg, n, out.device))
    check(lib, err, f"{entry} launch")


def fused3b_blend_vol(vol: torch.Tensor, plan,
                      cfg: SamplerConfig) -> torch.Tensor:
    """(7, C, QP) slot-ordered fused rows of the kernel-layout volume
    (D, H, W, N, C) at the plan's slots, zero in pad slots; kernel on CUDA
    tensors, plain on CPU ones."""
    if vol.device.type == "cpu" and plan[5].device.type == "cpu":
        return plain_fused3b_blend_vol(vol, plan, cfg)
    c = vol.shape[-1]
    out = torch.empty((7, c, plan[1].shape[0]), dtype=torch.float32,
                      device=vol.device)
    _launch("fused3b_blend", vol, plan, out, cfg, tuple(vol.shape), out)
    fused3b_blend_vol.launches += 1
    return out


def fused3b_bwd_vol(g_p: torch.Tensor, plan, in_spatial: Tuple[int, ...],
                    cfg: SamplerConfig, n_cells: int) -> torch.Tensor:
    """Kernel-layout (D, H, W, N, C) cotangent of fused3b_blend_vol for the
    (7, C, QP) slot cotangent ``g_p``; kernel on CUDA tensors, plain on CPU
    ones."""
    if g_p.device.type == "cpu" and plan[5].device.type == "cpu":
        return plain_fused3b_bwd_vol(g_p, plan, in_spatial, cfg, n_cells)
    if g_p.dim() != 3 or g_p.shape[0] != 7 or len(in_spatial) != 3:
        raise ValueError(f"fused3b_bwd takes g_p (7, C, QP) and 3 spatial "
                         f"sizes; got {tuple(g_p.shape)}, {tuple(in_spatial)}")
    shape = vol_layout(n_cells, g_p.shape[1], in_spatial)
    dvol = torch.zeros(shape, dtype=torch.float32, device=g_p.device)
    _launch("fused3b_bwd", g_p, plan, dvol, cfg, shape, g_p)
    fused3b_bwd_vol.launches += 1
    return dvol


fused3b_blend_vol.launches = 0
fused3b_bwd_vol.launches = 0
