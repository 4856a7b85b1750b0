"""Slab-decomposed blend_o / splat_o: the slab geometry, the plain versions
and the wrappers of csrc/slab.cu.

Counterpart of the JAX package's ops/pallas/slab.py, a route of the public
sampler's per-order blend and splat over volumes, 2D or 3D, too large for
one block's shared memory:

* **The geometry** (``geometry``), the card's own version of the JAX
  package's ``_pick_geom``: the leading spatial axis (D in 3D, H in 2D) is
  cut into slabs of ``dz`` rows and the channels into chunks of ``cc``, so
  that one CUDA block holds ``cc`` channels of its slab (and, for the
  blend, one halo row) in the SMEM_BYTES of shared memory a block may
  use.  It takes whole channels with the fattest slab and splits the
  channels only when one row of all of them does not fit.
* ``plain_blend_slab`` / ``plain_splat_slab``: plain PyTorch that does
  what the kernels do, slab by slab and chunk by chunk, with the slab
  height and the chunk as parameters so that small shapes can take many
  slabs.  The blend evaluates each pair in the slab of its floor row (the
  edge slabs take the floors outside the volume) from that slab's rows and
  its halo row; the splat gathers into each slab the corners that fall in
  it.  Both sum ops/generic.py's corner terms.  They are the oracle the
  kernels are held to.
* ``blend`` / ``splat``: the wrappers of the hand-written CUDA kernels,
  on the geometry of SMEM_BYTES.  A tensor on the CPU takes the plain
  version; a CUDA tensor launches the kernel on the current stream, or
  raises for what the kernel does not take.  Each wrapper counts its
  launches in its ``launches`` attribute.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Tuple

import torch

from .. import generic
from ..config import SamplerConfig, effective_align
from .blend_splat import _check_shapes, _check_tensors, launch_pairs
from .build import BLOCK_SMEM_BYTES
from .fused2w import cuda_device

__all__ = ["blend", "geometry", "plain_blend_slab", "plain_splat_slab",
           "splat", "supports"]

# the shared memory a slab may take (a module attribute, so that tests can
# shrink it)
SMEM_BYTES = BLOCK_SMEM_BYTES


def geometry(c: int, spatial, halo: int) -> Optional[Tuple[int, int]]:
    """(dz, cc): slab rows and channels per block so that cc channels of
    dz + ``halo`` rows of ``spatial`` fit SMEM_BYTES of f32, the most
    channels first and then the most rows; None if one row of one channel
    with its halo does not fit."""
    row_bytes = 4 * math.prod(spatial[1:])
    for cc in range(c, 0, -1):
        dz = SMEM_BYTES // (cc * row_bytes) - halo
        if dz >= 1:
            return min(dz, spatial[0]), cc
    return None


def supports(cfg: SamplerConfig, cells_shape) -> bool:
    """Whether the slab kernels take this config and (N, C, *S) shape: 2D
    or 3D, any padding and order, at most 65 535 cells, and a blend
    geometry (two rows of one channel fit a block)."""
    return (len(cells_shape) == cfg.dim + 2 and cells_shape[0] <= 65535
            and geometry(cells_shape[1], cells_shape[2:], 1) is not None)


def _corners(grid, spatial, cfg: SamplerConfig, orders, n: int, fwd_quirk):
    """ops/generic.py's (flat index, weight, in bounds) of every corner,
    each (N, Q), and the slab-axis floor of every pair (N, Q)."""
    d = cfg.dim
    q = math.prod(grid.shape[1:-1])
    tables = generic.per_axis_tables(grid.reshape(grid.shape[0], q, d),
                                     spatial, cfg, orders, n,
                                     fwd_quirk=fwd_quirk)
    corners = [tuple(t.expand(n, q) for t in generic.corner_index_weight(
        tables, corner, spatial, d))
        for corner in itertools.product((0, 1), repeat=d)]
    return corners, tables[d - 1][0].expand(n, q)


def plain_blend_slab(input, grid, cfg: SamplerConfig,
                     orders: Tuple[int, ...], dz: int, cc: int):
    """generic.blend, each pair evaluated in the slab of its floor row from
    that slab's rows [z0, z0 + dz] (csrc/slab.cu slab_blend):
    (N, C, *out_spatial)."""
    n, c, *spatial = input.shape
    depth, row = spatial[0], math.prod(spatial[1:])
    ns = -(-depth // dz)
    q = math.prod(grid.shape[1:-1])
    corners, floor = _corners(grid, spatial, cfg, orders, n, True)
    owner = torch.div(floor, dz, rounding_mode="floor").clamp(0, ns - 1)
    inp = input.reshape(n, c, depth * row)
    out = torch.zeros((n, c, q), dtype=input.dtype, device=input.device)
    for c0 in range(0, c, cc):
        cn = min(cc, c - c0)
        for s in range(ns):
            z0 = s * dz
            win_elems = min(dz + 1, depth - z0) * row
            win = inp[:, c0:c0 + cn, z0 * row:z0 * row + win_elems]
            acc = torch.zeros((n, cn, q), dtype=input.dtype,
                              device=input.device)
            for idx, wgt, ok in corners:
                loc = idx - z0 * row
                ok = ok & (loc >= 0) & (loc < win_elems)
                vals = torch.gather(win, 2, loc.clamp(0, win_elems - 1)
                                    [:, None, :].expand(n, cn, q))
                acc = acc + torch.where(ok[:, None, :], wgt[:, None, :] * vals,
                                        0.0)
            own = (owner == s)[:, None, :]
            out[:, c0:c0 + cn] = torch.where(own, acc, out[:, c0:c0 + cn])
    return out.reshape(n, c, *grid.shape[1:-1])


def plain_splat_slab(gout, grid, in_spatial: Tuple[int, ...],
                     cfg: SamplerConfig, orders: Tuple[int, ...], dz: int,
                     cc: int):
    """generic.splat accumulated slab by slab, each slab's rows
    [z0, z0 + dz) from the corners that fall in them (csrc/slab.cu
    slab_splat): (N, C, *in_spatial)."""
    in_spatial = tuple(in_spatial)
    n, c = gout.shape[:2]
    depth, row = in_spatial[0], math.prod(in_spatial[1:])
    q = math.prod(grid.shape[1:-1])
    corners, _ = _corners(grid, in_spatial, cfg, orders, n, False)
    gq = gout.reshape(n, c, q)
    out = torch.empty((n, c, depth * row), dtype=gout.dtype,
                      device=gout.device)
    for c0 in range(0, c, cc):
        cn = min(cc, c - c0)
        for z0 in range(0, depth, dz):
            slab_elems = min(dz, depth - z0) * row
            base = (torch.arange(n * cn, device=gout.device)
                    * slab_elems).reshape(n, cn, 1)
            acc = torch.zeros((n * cn * slab_elems,), dtype=gout.dtype,
                              device=gout.device)
            for idx, wgt, ok in corners:
                loc = idx - z0 * row
                ok = ok & (loc >= 0) & (loc < slab_elems)
                contrib = torch.where(ok[:, None, :], wgt[:, None, :]
                                      * gq[:, c0:c0 + cn], 0.0)
                dst = base + loc.clamp(0, slab_elems - 1)[:, None, :]
                acc.index_add_(0, dst.reshape(-1), contrib.reshape(-1))
            out[:, c0:c0 + cn, z0 * row:z0 * row + slab_elems] = (
                acc.reshape(n, cn, slab_elems))
    return out.reshape(n, c, *in_spatial)


def _geometry_or_raise(c: int, spatial, halo: int) -> Tuple[int, int]:
    geom = geometry(c, spatial, halo)
    if geom is None:
        raise ValueError(f"no slab geometry: {1 + halo} rows of one channel "
                         f"of {tuple(spatial)} exceed {SMEM_BYTES} bytes")
    return geom


def blend(input: torch.Tensor, grid: torch.Tensor, cfg: SamplerConfig,
          orders: Tuple[int, ...]) -> torch.Tensor:
    """(N, C, *out_spatial): generic.blend of (N, C, *S) cells at the grid,
    slab by slab; kernel on CUDA tensors, plain on CPU ones."""
    n, c, *spatial = input.shape
    dz, cc = _geometry_or_raise(c, spatial, 1)
    if input.device.type == "cpu" and grid.device.type == "cpu":
        return plain_blend_slab(input, grid, cfg, orders, dz, cc)
    device = cuda_device(input, grid)
    _check_tensors(input, grid)
    q = _check_shapes(cfg, n, spatial, grid, orders)
    if n > 65535:
        raise ValueError(f"the slab kernels take at most 65535 cells, got {n}")
    out = torch.empty((n, c, *grid.shape[1:-1]), dtype=torch.float32,
                      device=device)
    launch_pairs("slab_blend", (input, grid, out), cfg, n, c, spatial, q,
                 grid.shape[0], orders, effective_align(cfg, orders),
                 extra=(dz, cc))
    blend.launches += 1
    return out


def splat(gout: torch.Tensor, grid: torch.Tensor,
          in_spatial: Tuple[int, ...], cfg: SamplerConfig,
          orders: Tuple[int, ...]) -> torch.Tensor:
    """(N, C, *in_spatial): generic.splat, the transpose of blend, slab by
    slab; kernel on CUDA tensors, plain on CPU ones."""
    n, c = gout.shape[:2]
    dz, cc = _geometry_or_raise(c, in_spatial, 0)
    if gout.device.type == "cpu" and grid.device.type == "cpu":
        return plain_splat_slab(gout, grid, in_spatial, cfg, orders, dz, cc)
    device = cuda_device(gout, grid)
    _check_tensors(gout, grid)
    q = _check_shapes(cfg, n, tuple(in_spatial), grid, orders)
    if math.prod(gout.shape[2:]) != q:
        raise ValueError(f"gout {tuple(gout.shape)} does not match the grid "
                         f"{tuple(grid.shape)}")
    if n > 65535:
        raise ValueError(f"the slab kernels take at most 65535 cells, got {n}")
    # every element is written by the kernel: no memset
    out = torch.empty((n, c, *in_spatial), dtype=torch.float32, device=device)
    launch_pairs("slab_splat", (gout, grid, out), cfg, n, c, tuple(in_spatial),
                 q, grid.shape[0], orders, cfg.align_corners, extra=(dz, cc))
    splat.launches += 1
    return out


blend.launches = 0
splat.launches = 0
