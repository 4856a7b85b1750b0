"""Binned per-cell blend_o / splat_o: the pair plan, the plain versions and
the wrappers of csrc/percell.cu.

Counterpart of the JAX package's ops/pallas/percell.py, the route of the
public sampler's per-order blend and splat over 3D volumes too large for
one block's shared memory (the nested 3D trainer on 128^3 cells, per-cell
sampling of large volumes):

* **The pair plan** (``make_plan``): every (cell, query) pair, a shared
  grid expanded to N x Q pairs since each cell has its own offset lattice,
  keyed by (cell, z row) on the floor of the cell's own source coordinate
  (``compute_source_coords`` with the cell's shift, so the per-cell floor
  is ``floor(base + offset)``) and sorted stably.  It holds each slot's
  pair and, since the cell leads the key, each query's slot within its
  cell, by which the blend's output goes back to query order.  The key
  only orders the pairs: the kernels gather and scatter
  anywhere in the volume, so a corner in the next row is read like any
  other.  The JAX package's per-bin block padding, window DMA chain and
  ``_FP`` front pad serve its VMEM windows and are not carried over.
* ``plain_blend_percell`` / ``plain_splat_percell``: plain PyTorch over
  the plan's slot order (ops/generic.py's corner math, each slot with its
  cell's shift), scattered back to query order.  They are the oracle the
  kernels are held to.
* ``blend`` / ``splat``: the wrappers of the hand-written CUDA kernels.
  A tensor on the CPU takes the plain version; a CUDA tensor launches the
  kernel on the current stream, or raises for what the kernel does not
  take.  Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Tuple

import torch

from .. import generic
from ..config import SamplerConfig, effective_align
from ..coords import compute_source_coords, multicell_offsets
from .blend_splat import _check_shapes, _check_tensors, launch_pairs
from .fused2w import cuda_device

__all__ = ["PairPlan", "blend", "make_plan", "plain_blend_percell",
           "plain_splat_percell", "splat", "supports"]


@dataclasses.dataclass(frozen=True)
class PairPlan:
    """The (cell, z row) order of the N * Q pairs of one grid.

    ``perm`` (P,) int32 is the pair index ``n * Q + q`` of each slot; the
    slots of cell n are ``n * Q`` to ``n * Q + Q - 1``.  ``back`` (N, 1, Q)
    int64 is the slot of each query within its cell, ``slot - n * Q``."""
    perm: torch.Tensor
    back: torch.Tensor
    n: int
    q: int


def supports(cfg: SamplerConfig, cells_shape) -> bool:
    """Whether the percell kernels take this config and (N, C, D, H, W)
    shape: 3D (as the JAX package's route), any padding and order."""
    return cfg.dim == 3 and len(cells_shape) == 5


def make_plan(grid: torch.Tensor, cells_shape,
              cfg: SamplerConfig) -> PairPlan:
    """The pair plan of ``grid`` (N or 1, *out, 3) over (N, C, D, H, W)
    cells, on the grid's device.

    The key is the cell and the floor of the pair's source z coordinate
    (folded as the sampler folds it), clamped to the cell's rows, in f32 as
    the kernels compute it; the sort is stable, so the pairs of one key
    keep their (cell, query) order.
    """
    n, d = cells_shape[0], cells_shape[2]
    gb = grid.shape[0]
    q = math.prod(grid.shape[1:-1])
    device = grid.device
    z = grid.detach().reshape(gb, q, 3)[..., 2].to(torch.float32)
    offsets = multicell_offsets(n, cfg.multicell, torch.float32, device)
    base, _ = compute_source_coords(z, d, cfg.padding_mode, cfg.align_corners,
                                    cfg.multicell, offsets[:, None],
                                    strict=cfg.strict_reference)
    # int32 keys sort faster; n * d keys fit the kernels' 32-bit indexing
    row = torch.floor(base).nan_to_num_(nan=0.0).clamp_(0, d - 1)
    key = (row.to(torch.int32)
           + torch.arange(0, n * d, d, dtype=torch.int32, device=device)
           [:, None]).reshape(-1)
    _, perm = torch.sort(key, stable=True)
    back = torch.empty(n * q, dtype=torch.int64, device=device)
    back[perm] = torch.arange(q, device=device).repeat(n)
    return PairPlan(perm.to(torch.int32), back.view(n, 1, q), n, q)


def _check_plan(plan: PairPlan, n: int, q: int) -> None:
    if (plan.n != n or plan.q != q or plan.perm.shape != (n * q,)
            or plan.back.shape != (n, 1, q)):
        raise ValueError(f"the pair plan is for {plan.n} cells x {plan.q} "
                         f"queries, the call has {n} x {q}")


def _slots(grid, plan: PairPlan, n: int, cfg: SamplerConfig):
    """Each slot's cell (P,), query (P,), coordinates (1, P, 3) and cell
    shift (1, P)."""
    pair = plan.perm.to(torch.int64)
    cell, qi = pair // plan.q, pair % plan.q
    gf = grid.reshape(grid.shape[0], plan.q, 3)
    pts = gf[cell if grid.shape[0] > 1 else 0, qi]
    shift = multicell_offsets(n, cfg.multicell, grid.dtype, grid.device)
    return cell, qi, pts[None], shift[cell][None]


def _to_query_order(slots: torch.Tensor, plan: PairPlan) -> torch.Tensor:
    """(N, C, Q) in each cell's slot order -> (N, C, Q) in query order."""
    return torch.gather(slots, 2, plan.back.expand(*slots.shape))


def plain_blend_percell(input, grid, cfg: SamplerConfig,
                        orders: Tuple[int, ...], plan: PairPlan):
    """generic.blend computed slot by slot in the plan's order and put back
    in query order as the wrapper puts the kernel's output back:
    (N, C, *out_spatial)."""
    n, c, *spatial = input.shape
    _check_plan(plan, n, math.prod(grid.shape[1:-1]))
    cell, _, pts, shift = _slots(grid, plan, n, cfg)
    tables = generic.per_axis_tables(pts, spatial, cfg, orders, n,
                                     fwd_quirk=True, offset=shift)
    total = math.prod(spatial)
    inp = input.reshape(n, c, total)
    vals = torch.zeros((c, cell.numel()), dtype=input.dtype,
                       device=input.device)
    for corner in itertools.product((0, 1), repeat=3):
        idx, wgt, ok = generic.corner_index_weight(tables, corner, spatial, 3)
        v = inp[cell, :, idx[0].clamp(0, total - 1)].T        # (C, P)
        vals = vals + torch.where(ok, wgt * v, 0.0)
    slots = vals.reshape(c, n, plan.q).transpose(0, 1)
    out = _to_query_order(slots, plan)
    return out.reshape(n, c, *grid.shape[1:-1])


def plain_splat_percell(gout, grid, in_spatial: Tuple[int, ...],
                        cfg: SamplerConfig, orders: Tuple[int, ...],
                        plan: PairPlan):
    """generic.splat with the contributions taken slot by slot in the
    plan's order: (N, C, *in_spatial)."""
    in_spatial = tuple(in_spatial)
    n, c = gout.shape[:2]
    _check_plan(plan, n, math.prod(grid.shape[1:-1]))
    cell, qi, pts, shift = _slots(grid, plan, n, cfg)
    tables = generic.per_axis_tables(pts, in_spatial, cfg, orders, n,
                                     offset=shift)
    total = math.prod(in_spatial)
    g = gout.reshape(n, c, plan.q)[cell, :, qi]                # (P, C)
    base = (cell[:, None] * c + torch.arange(c, device=gout.device)) * total
    acc = torch.zeros((n * c * total,), dtype=gout.dtype, device=gout.device)
    for corner in itertools.product((0, 1), repeat=3):
        idx, wgt, ok = generic.corner_index_weight(tables, corner, in_spatial,
                                                   3)
        contrib = torch.where(ok[0][:, None], wgt[0][:, None] * g, 0.0)
        dst = base + idx[0].clamp(0, total - 1)[:, None]
        acc.index_add_(0, dst.reshape(-1), contrib.reshape(-1))
    return acc.reshape(n, c, *in_spatial)


def _check_call(cfg: SamplerConfig, n: int, spatial, grid, orders,
                plan: PairPlan) -> int:
    if cfg.dim != 3:
        raise ValueError(f"the percell kernels are 3D; got dim {cfg.dim}")
    q = _check_shapes(cfg, n, spatial, grid, orders)
    _check_plan(plan, n, q)
    if plan.perm.dtype != torch.int32 or not plan.perm.is_contiguous():
        raise ValueError("the plan's perm must be contiguous int32")
    return q


def blend(input: torch.Tensor, grid: torch.Tensor, cfg: SamplerConfig,
          orders: Tuple[int, ...], plan: PairPlan) -> torch.Tensor:
    """(N, C, *out_spatial): generic.blend of (N, C, D, H, W) cells at the
    grid, through the pair plan of ``grid``; kernel on CUDA tensors, plain
    on CPU ones."""
    if input.device.type == "cpu" and grid.device.type == "cpu":
        return plain_blend_percell(input, grid, cfg, orders, plan)
    device = cuda_device(input, grid, plan.perm, plan.back)
    _check_tensors(input, grid)
    n, c, *spatial = input.shape
    q = _check_call(cfg, n, spatial, grid, orders, plan)
    slots = torch.empty((n, c, q), dtype=torch.float32, device=device)
    launch_pairs("percell_blend", (input, grid, plan.perm, slots), cfg, n, c,
                 spatial, q, grid.shape[0], orders,
                 effective_align(cfg, orders))
    blend.launches += 1
    # coalesced slot-order stores and one gather beat scattered query-order
    # stores (PERF.md section 6)
    return _to_query_order(slots, plan).view(n, c, *grid.shape[1:-1])


def splat(gout: torch.Tensor, grid: torch.Tensor,
          in_spatial: Tuple[int, ...], cfg: SamplerConfig,
          orders: Tuple[int, ...], plan: PairPlan) -> torch.Tensor:
    """(N, C, *in_spatial): generic.splat, the transpose of blend, through
    the pair plan of ``grid``; kernel on CUDA tensors, plain on CPU ones."""
    if gout.device.type == "cpu" and grid.device.type == "cpu":
        return plain_splat_percell(gout, grid, in_spatial, cfg, orders, plan)
    device = cuda_device(gout, grid, plan.perm)
    _check_tensors(gout, grid)
    n, c = gout.shape[:2]
    q = _check_call(cfg, n, tuple(in_spatial), grid, orders, plan)
    if math.prod(gout.shape[2:]) != q:
        raise ValueError(f"gout {tuple(gout.shape)} does not match the grid "
                         f"{tuple(grid.shape)}")
    out = torch.zeros((n, c, *in_spatial), dtype=torch.float32, device=device)
    launch_pairs("percell_splat", (gout, grid, plan.perm, out), cfg, n, c,
                 tuple(in_spatial), q, grid.shape[0], orders,
                 cfg.align_corners)
    splat.launches += 1
    return out


blend.launches = 0
splat.launches = 0
