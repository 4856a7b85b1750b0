"""Slab-decomposed blend_o / splat_o over binned pairs: the slab geometry,
the bins, the plain versions and the wrappers of csrc/slab.cu.

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
* **The bins** (``make_bins``, ``SlabBins``): every (cell, query) pair,
  a shared grid expanded to N x Q pairs, keyed by its cell and the floor
  row of its leading-axis source coordinate clamped to the cell's rows,
  ordered by key, with the first slot of each (cell, row).  A slab's bin
  is the contiguous slots of its rows, for any slab height, so a blend
  and a splat of other geometries share one build: the sampler carries it
  along an autograd chain in ``route.GridPlans``.  On the card the bins
  are a counting sort in csrc/slab.cu with no host sync, its order within
  a bin that of its atomics, over a histogram of a cell's rows in one
  block's shared memory (at most BIN_MAX_DEPTH rows); ``plain_bins`` is
  the oracle, a stable sort of the same keys.  A volume of one slab needs
  no bins.
* ``plain_blend_slab`` / ``plain_splat_slab``: plain PyTorch that does
  what the kernels do, slab height and channel chunk as parameters so
  that small shapes can take many slabs.  The blend evaluates each slot
  in the slab of its bin from that slab's rows and its halo row; the
  splat adds each slot's corners into the slabs whose blocks walk its bin
  (floor rows z0 - 1 to z0 + dz - 1).  Both sum ops/generic.py's corner
  terms.  They are the oracle the kernels are held to.
* ``blend`` / ``splat``: the wrappers of the hand-written CUDA kernels,
  on the geometry of SMEM_BYTES.  A tensor on the CPU takes the plain
  version; a CUDA tensor launches the kernel on the current stream, or
  raises for what the kernel does not take.  Each wrapper (and
  ``make_bins``) counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import torch

from .. import generic
from ..config import SamplerConfig, effective_align
from ..coords import compute_source_coords, multicell_offsets, offset_lattice
from .blend_splat import _check_shapes, _check_tensors, launch_pairs
from .build import BLOCK_SMEM_BYTES, check, load_kernels
from .fused2w import PADDING_IDS, cuda_device

__all__ = ["SlabBins", "blend", "geometry", "make_bins", "needs_bins",
           "plain_bins", "plain_blend_slab", "plain_splat_slab", "splat",
           "supports"]

# the shared memory a slab may take (a module attribute, so that tests can
# shrink it)
SMEM_BYTES = BLOCK_SMEM_BYTES
# the most rows of a leading axis the card's bins take: the count kernel
# keeps one int32 a row of a cell in a block's shared memory
BIN_MAX_DEPTH = BLOCK_SMEM_BYTES // 4


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
    or 3D, any padding and order, at most 65 535 cells, a blend geometry
    (two rows of one channel fit a block) and at most BIN_MAX_DEPTH rows
    of the leading axis for the bins."""
    return (len(cells_shape) == cfg.dim + 2 and cells_shape[0] <= 65535
            and cells_shape[2] <= BIN_MAX_DEPTH
            and geometry(cells_shape[1], cells_shape[2:], 1) is not None)


def needs_bins(cells_shape, blend: bool) -> bool:
    """Whether the blend (or the splat) over (N, C, *S) cells cuts the
    leading axis into more than one slab, and so walks bins."""
    dz, _ = _geometry_or_raise(cells_shape[1], cells_shape[2:], blend)
    return dz < cells_shape[2]


# --- the bins -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlabBins:
    """The (cell, floor row) order of the N * Q pairs of one grid.

    ``perm`` (P,) int32 is the pair index ``n * Q + q`` of each slot; the
    slots of cell n are ``n * Q`` to ``n * Q + Q - 1``.  ``starts``
    (N * D + 1,) int32 is the first slot of each (cell, row) key, and the
    pair count last."""
    perm: torch.Tensor
    starts: torch.Tensor
    n: int
    q: int
    depth: int


def _bin_rows(grid, cells_shape, cfg: SamplerConfig, align: bool):
    """(N, Q) int64: each pair's floor row of the leading axis, folded as
    the sampler folds it with ``align`` and clamped to [0, D), computed in
    the grid's dtype as ops/generic.py computes the corners' floor."""
    n, depth, d = cells_shape[0], cells_shape[2], cfg.dim
    gb = grid.shape[0]
    q = math.prod(grid.shape[1:-1])
    coord = grid.detach().reshape(gb, q, d)[..., d - 1]
    offsets = multicell_offsets(n, cfg.multicell, coord.dtype, coord.device)
    base, _ = compute_source_coords(coord, depth, cfg.padding_mode, align,
                                    cfg.multicell, offsets[:, None],
                                    strict=cfg.strict_reference)
    row = torch.floor(base).nan_to_num_(nan=0.0).clamp_(0, depth - 1)
    return row.to(torch.int64).expand(n, q)


def plain_bins(grid: torch.Tensor, cells_shape, cfg: SamplerConfig,
               align: bool) -> SlabBins:
    """The bins of ``grid`` (N or 1, *out, d) over (N, C, *S) cells, on the
    grid's device: a stable sort of the (cell, row) keys, so the pairs of
    one key keep their query order (the kernel's order within a key is
    its atomics')."""
    n, depth = cells_shape[0], cells_shape[2]
    q = math.prod(grid.shape[1:-1])
    device = grid.device
    key = (_bin_rows(grid, cells_shape, cfg, align)
           + torch.arange(0, n * depth, depth, device=device)[:, None]
           ).reshape(-1)
    skey, perm = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        skey, torch.arange(n * depth + 1, device=device))
    return SlabBins(perm.to(torch.int32), starts.to(torch.int32), n, q,
                    depth)


def make_bins(grid: torch.Tensor, cells_shape, cfg: SamplerConfig,
              align: bool) -> SlabBins:
    """The bins of ``grid`` over (N, C, *S) cells with ``align`` (the
    blend's effective align_corners or the splat's): csrc/slab.cu
    slab_bins on a CUDA grid (at most 65 535 cells and BIN_MAX_DEPTH
    rows), ``plain_bins`` on a CPU one."""
    if grid.device.type == "cpu":
        return plain_bins(grid, cells_shape, cfg, align)
    device = cuda_device(grid)
    _check_tensors(grid)
    n, depth = cells_shape[0], cells_shape[2]
    spatial = tuple(cells_shape[2:])
    q = _check_shapes(cfg, n, spatial, grid, (0,) * cfg.dim)
    if n > 65535 or n * max(q, depth) >= 2**31 or depth > BIN_MAX_DEPTH:
        raise ValueError(f"the slab bins take at most 65535 cells, 2^31 "
                         f"pairs and {BIN_MAX_DEPTH} rows, got {n} x {q} "
                         f"pairs over {depth} rows")
    lib = load_kernels()
    key = torch.empty(n * q, dtype=torch.int32, device=device)
    rank = torch.empty_like(key)
    perm = torch.empty_like(key)
    starts = torch.zeros(n * depth + 1, dtype=torch.int32, device=device)
    d, h, w = (1, *spatial) if cfg.dim == 2 else spatial
    step, stop = offset_lattice(n, cfg.multicell)
    with torch.cuda.device(device):
        err = lib.slab_bins(
            grid.data_ptr(), key.data_ptr(), rank.data_ptr(),
            starts.data_ptr(), perm.data_ptr(), cfg.dim, n, d, h, w, q,
            grid.shape[0], PADDING_IDS[cfg.padding_mode], int(align),
            int(cfg.multicell), int(cfg.strict_reference), float(step),
            float(stop),
            torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, "slab_bins launch")
    make_bins.launches += 1
    return SlabBins(perm, starts, n, q, depth)


def _check_bins(bins: SlabBins, n: int, q: int, depth: int) -> None:
    if (bins.n, bins.q, bins.depth) != (n, q, depth):
        raise ValueError(f"the slab bins are for {bins.n} cells x {bins.q} "
                         f"queries over {bins.depth} rows, the call has {n} "
                         f"x {q} over {depth}")


def _slots(bins: SlabBins):
    """Each slot's cell, query and floor row (P,) int64."""
    pair = bins.perm.to(torch.int64)
    slot = torch.arange(pair.numel(), device=pair.device)
    key = torch.searchsorted(bins.starts.to(torch.int64), slot,
                             right=True) - 1
    cell = pair // bins.q
    return cell, pair % bins.q, key - cell * bins.depth


# --- the plain versions -------------------------------------------------------

def _corners(grid, spatial, cfg: SamplerConfig, orders, n: int, fwd_quirk,
             cell, qi):
    """ops/generic.py's (flat index, weight, in bounds) of every corner,
    each (P,), for the slots' pairs (``cell``, ``qi``)."""
    d = cfg.dim
    q = math.prod(grid.shape[1:-1])
    tables = generic.per_axis_tables(grid.reshape(grid.shape[0], q, d),
                                     spatial, cfg, orders, n,
                                     fwd_quirk=fwd_quirk)
    return [tuple(t.expand(n, q)[cell, qi] for t in
                  generic.corner_index_weight(tables, corner, spatial, d))
            for corner in itertools.product((0, 1), repeat=d)]


def plain_blend_slab(input, grid, cfg: SamplerConfig,
                     orders: Tuple[int, ...], dz: int, cc: int,
                     bins: Optional[SlabBins] = None):
    """generic.blend, each slot evaluated in the slab of its bin's row from
    that slab's rows [z0, z0 + dz] (csrc/slab.cu slab_blend), channel
    chunk by channel chunk: (N, C, *out_spatial).  ``bins`` defaults to
    ``plain_bins``."""
    n, c, *spatial = input.shape
    depth, row = spatial[0], math.prod(spatial[1:])
    q = math.prod(grid.shape[1:-1])
    if bins is None:
        bins = plain_bins(grid, input.shape, cfg, effective_align(cfg, orders))
    _check_bins(bins, n, q, depth)
    cell, qi, slot_row = _slots(bins)
    z0 = torch.div(slot_row, dz, rounding_mode="floor") * dz
    win_elems = (depth - z0).clamp(max=dz + 1) * row
    corners = _corners(grid, spatial, cfg, orders, n, True, cell, qi)
    inp = input.reshape(n, c, depth * row)
    out = torch.zeros((n, c, q), dtype=input.dtype, device=input.device)
    for c0 in range(0, c, cc):
        chans = torch.arange(c0, min(c0 + cc, c), device=input.device)
        acc = 0.0
        for idx, wgt, ok in corners:
            loc = idx - z0 * row
            ok = ok & (loc >= 0) & (loc < win_elems)
            vals = inp[cell[:, None], chans, idx.clamp(0, depth * row - 1)
                       [:, None]]                                # (P, cn)
            acc = acc + torch.where(ok[:, None], wgt[:, None] * vals, 0.0)
        out[cell[:, None], chans, qi[:, None]] = acc
    return out.reshape(n, c, *grid.shape[1:-1])


def plain_splat_slab(gout, grid, in_spatial: Tuple[int, ...],
                     cfg: SamplerConfig, orders: Tuple[int, ...], dz: int,
                     cc: int, bins: Optional[SlabBins] = None):
    """generic.splat accumulated slot by slot in bin order, each corner
    added into its slab [z0, z0 + dz) where that slab's block walks the
    slot's bin (floor rows z0 - 1 to z0 + dz - 1; csrc/slab.cu
    slab_splat), channel chunk by channel chunk: (N, C, *in_spatial).
    ``bins`` defaults to ``plain_bins``."""
    in_spatial = tuple(in_spatial)
    n, c = gout.shape[:2]
    depth, row = in_spatial[0], math.prod(in_spatial[1:])
    total = depth * row
    q = math.prod(grid.shape[1:-1])
    if bins is None:
        bins = plain_bins(grid, (n, c, *in_spatial), cfg, cfg.align_corners)
    _check_bins(bins, n, q, depth)
    cell, qi, slot_row = _slots(bins)
    corners = _corners(grid, in_spatial, cfg, orders, n, False, cell, qi)
    gq = gout.reshape(n, c, q)
    acc = torch.zeros((n * c * total,), dtype=gout.dtype, device=gout.device)
    for c0 in range(0, c, cc):
        chans = torch.arange(c0, min(c0 + cc, c), device=gout.device)
        g = gq[cell[:, None], chans, qi[:, None]]                # (P, cn)
        for idx, wgt, ok in corners:
            z0 = torch.div(idx, row * dz, rounding_mode="floor") * dz
            walks = ((slot_row >= z0 - 1)
                     & (slot_row < (z0 + dz).clamp(max=depth)))
            contrib = torch.where((ok & walks)[:, None], wgt[:, None] * g,
                                  0.0)
            dst = ((cell[:, None] * c + chans) * total
                   + idx.clamp(0, total - 1)[:, None])
            acc.index_add_(0, dst.reshape(-1), contrib.reshape(-1))
    return acc.reshape(n, c, *in_spatial)


# --- the wrappers -------------------------------------------------------------

def _geometry_or_raise(c: int, spatial, blend: bool) -> Tuple[int, int]:
    """The blend's geometry (with its halo row) or the splat's."""
    geom = geometry(c, spatial, int(blend))
    if geom is None:
        raise ValueError(f"no slab geometry: {1 + int(blend)} rows of one "
                         f"channel of {tuple(spatial)} exceed {SMEM_BYTES} "
                         f"bytes")
    return geom


def _launch(entry: str, first, grid, out, cfg: SamplerConfig, n: int, c: int,
            spatial, q: int, orders, align: bool, dz: int, cc: int,
            bins: Optional[SlabBins]) -> None:
    """Launch ``entry`` with the bins where the leading axis takes more
    than one slab (made here if ``bins`` is None), else with none."""
    if n > 65535:
        raise ValueError(f"the slab kernels take at most 65535 cells, got {n}")
    perm = starts = None
    if dz < spatial[0]:
        if bins is None:
            bins = make_bins(grid, (n, c, *spatial), cfg, align)
        _check_bins(bins, n, q, spatial[0])
        cuda_device(out, bins.perm, bins.starts)
        perm, starts = bins.perm, bins.starts
    launch_pairs(entry, (first, grid, perm, starts, out), cfg, n, c, spatial,
                 q, grid.shape[0], orders, align, extra=(dz, cc))


def blend(input: torch.Tensor, grid: torch.Tensor, cfg: SamplerConfig,
          orders: Tuple[int, ...],
          bins: Optional[SlabBins] = None) -> torch.Tensor:
    """(N, C, *out_spatial): generic.blend of (N, C, *S) cells at the grid,
    slab by slab over ``bins`` (made in the call if None and needed);
    kernel on CUDA tensors, plain on CPU ones."""
    n, c, *spatial = input.shape
    dz, cc = _geometry_or_raise(c, spatial, True)
    if input.device.type == "cpu" and grid.device.type == "cpu":
        return plain_blend_slab(input, grid, cfg, orders, dz, cc, bins)
    device = cuda_device(input, grid)
    _check_tensors(input, grid)
    q = _check_shapes(cfg, n, spatial, grid, orders)
    out = torch.empty((n, c, *grid.shape[1:-1]), dtype=torch.float32,
                      device=device)
    _launch("slab_blend", input, grid, out, cfg, n, c, spatial, q, orders,
            effective_align(cfg, orders), dz, cc, bins)
    blend.launches += 1
    return out


def splat(gout: torch.Tensor, grid: torch.Tensor,
          in_spatial: Tuple[int, ...], cfg: SamplerConfig,
          orders: Tuple[int, ...],
          bins: Optional[SlabBins] = None) -> torch.Tensor:
    """(N, C, *in_spatial): generic.splat, the transpose of blend, slab by
    slab over ``bins`` (made in the call if None and needed); kernel on
    CUDA tensors, plain on CPU ones."""
    n, c = gout.shape[:2]
    in_spatial = tuple(in_spatial)
    dz, cc = _geometry_or_raise(c, in_spatial, False)
    if gout.device.type == "cpu" and grid.device.type == "cpu":
        return plain_splat_slab(gout, grid, in_spatial, cfg, orders, dz, cc,
                                bins)
    device = cuda_device(gout, grid)
    _check_tensors(gout, grid)
    q = _check_shapes(cfg, n, in_spatial, grid, orders)
    if math.prod(gout.shape[2:]) != q:
        raise ValueError(f"gout {tuple(gout.shape)} does not match the grid "
                         f"{tuple(grid.shape)}")
    # every element is written by the kernel: no memset
    out = torch.empty((n, c, *in_spatial), dtype=torch.float32, device=device)
    _launch("slab_splat", gout, grid, out, cfg, n, c, in_spatial, q, orders,
            cfg.align_corners, dz, cc, bins)
    splat.launches += 1
    return out


blend.launches = 0
splat.launches = 0
make_bins.launches = 0
