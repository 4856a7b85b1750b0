"""Binned per-cell blend_o / splat_o: the tiles, the pair plan, the plain
versions and the wrappers of csrc/percell.cu.

Counterpart of the JAX package's ops/pallas/percell.py, the route of the
public sampler's per-order blend and splat over 3D volumes whose rows are
too large for the slab kernels (ops/cuda/route.py rule):

* **The tiles** (``geometry``): each cell's (D, H) rows are cut into tiles
  of ``dz`` z rows by ``ty`` y rows.  A blend block stages its tile's
  window, z rows [z0, z0 + dz] by y rows [y0, y0 + ty] of ``cc``
  channels, in TILE_BYTES of shared memory, so that two blocks share an
  SM; the tile is the one with the fewest halo rows to stage per owned
  row.  Where two rows of one channel of two planes do not fit, or a
  cell's tiles are more than its histogram holds, the blend is not staged
  and gathers from the volume.
* **The pair plan** (``make_plan``, ``PairPlan``): every (cell, query)
  pair, a shared grid expanded to N x Q pairs since each cell has its own
  offset lattice, keyed by its cell and the tile of its floor corner (the
  z and y floors of the cell's own source coordinate, folded as the
  sampler folds them and clamped to the cell's rows), ordered by key, with
  the first slot of each (cell, tile).  On the card it is csrc/percell.cu
  percell_plan, the counting sort of csrc/pair_bins.cuh with no host
  sync, its order within a tile that of its atomics; ``plain_plan``, a
  stable sort of the same keys, is its oracle.  The JAX package's
  per-bin block padding, window DMA chain and ``_FP`` front pad serve its
  VMEM windows and are not carried over.
* ``plain_blend_percell`` / ``plain_splat_percell``: plain PyTorch over
  the plan's slot order (ops/generic.py's corner math, each slot with its
  cell's shift); the blend reads each slot's corners from its tile's
  window, as the kernel does, and writes query order.  They are the
  oracle the kernels are held to.
* ``blend`` / ``splat``: the wrappers of the hand-written CUDA kernels.
  A tensor on the CPU takes the plain version; a CUDA tensor launches the
  kernel on the current stream, or raises for what the kernel does not
  take.  Each wrapper (and ``make_plan``) counts its launches in its
  ``launches`` attribute.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Tuple

import torch

from .. import generic
from ..config import SamplerConfig, effective_align
from ..coords import compute_source_coords, multicell_offsets, offset_lattice
from .blend_splat import _check_shapes, _check_tensors, launch_pairs
from .build import BLOCK_SMEM_BYTES, check, load_kernels
from .fused2w import PADDING_IDS, cuda_device

__all__ = ["PairPlan", "blend", "geometry", "make_plan", "plain_blend_percell",
           "plain_plan", "plain_splat_percell", "splat", "supports"]

# the shared memory a blend tile may take, its mbarrier included: two
# blocks on an SM's 228 KB, each with the 1 KB the card reserves a block (a
# module attribute, so that tests can shrink it)
TILE_BYTES = 113 * 1024
# the mbarrier ahead of a staged window (csrc/percell.cu kBarrierBytes)
BARRIER_BYTES = 16
# the most tiles a cell may have: the plan's count kernel keeps one int32 a
# tile of a cell in a block's shared memory
BIN_MAX_KEYS = BLOCK_SMEM_BYTES // 4


def _tiles_of(d: int, h: int, dz: int, ty: int) -> int:
    return -(-d // dz) * -(-h // ty)


def _window_bytes(cc: int, d: int, h: int, w: int, dz: int, ty: int) -> int:
    return BARRIER_BYTES + 4 * cc * min(dz + 1, d) * min(ty + 1, h) * w


@functools.lru_cache(maxsize=256)
def _geometry(c: int, spatial: Tuple[int, int, int], budget: int):
    d, h, w = spatial
    best = None
    for dz in range(1, d + 1):
        zrows = min(dz + 1, d)
        # the most y rows a band takes with its halo row, all channels
        ty = (budget - BARRIER_BYTES) // (4 * c * zrows * w) - 1
        if ty < 1:
            break
        ty = min(ty, h)
        if _tiles_of(d, h, dz, ty) > BIN_MAX_KEYS:
            continue
        # rows staged per row owned
        cost = zrows * min(ty + 1, h) / (min(dz, d) * ty)
        if best is None or cost < best[0]:
            best = (cost, dz, ty)
    return None if best is None else best[1:]


def geometry(c: int, spatial) -> Tuple[int, int]:
    """(dz, ty): the tiles of (D, H, W) cells of ``c`` channels, the
    fewest staged rows per owned row among those whose window of all
    channels fits TILE_BYTES, else of one channel; where none fits (or
    every one has more tiles than BIN_MAX_KEYS), whole planes of as few z
    rows as the histogram allows, not staged."""
    d, h, _ = spatial
    for cc in (c, 1):
        tile = _geometry(cc, tuple(spatial), TILE_BYTES)
        if tile is not None:
            return tile
    return max(1, -(-d // BIN_MAX_KEYS)), h


def channels(c: int, spatial, dz: int, ty: int) -> int:
    """The channels a blend block stages for tiles (dz, ty): the most that
    fit TILE_BYTES, 0 if one does not (the blend then gathers from the
    volume)."""
    d, h, w = spatial
    for cc in range(c, 0, -1):
        if _window_bytes(cc, d, h, w, dz, ty) <= TILE_BYTES:
            return cc
    return 0


@dataclasses.dataclass(frozen=True)
class PairPlan:
    """The (cell, tile) order of the N * Q pairs of one grid.

    ``perm`` (P,) int32 is the pair index ``n * Q + q`` of each slot; the
    slots of cell n are ``n * Q`` to ``n * Q + Q - 1``.  ``starts``
    (N * T + 1,) int32 is the first slot of each (cell, tile), T tiles of
    (dz, ty) a cell in (z tile, y band) order, and the pair count last."""
    perm: torch.Tensor
    starts: torch.Tensor
    n: int
    q: int
    dz: int
    ty: int


def supports(cfg: SamplerConfig, cells_shape) -> bool:
    """Whether the percell kernels take this config and (N, C, D, H, W)
    shape: 3D (as the JAX package's route), any padding and order."""
    return cfg.dim == 3 and len(cells_shape) == 5


def _tile_keys(grid, cells_shape, cfg: SamplerConfig, dz: int, ty: int):
    """(N, Q) int64: each pair's tile within its cell, (z tile) * bands +
    (y band), from the floors of its source coordinates folded as the
    sampler folds them and clamped to the cell's rows, computed in the
    grid's dtype as ops/generic.py computes the corners' floor."""
    n, _, d, h, _ = cells_shape
    gb = grid.shape[0]
    q = math.prod(grid.shape[1:-1])
    pts = grid.detach().reshape(gb, q, 3)
    offsets = multicell_offsets(n, cfg.multicell, pts.dtype, pts.device)

    def floor(axis, size):
        base, _ = compute_source_coords(
            pts[..., axis], size, cfg.padding_mode, cfg.align_corners,
            cfg.multicell, offsets[:, None], strict=cfg.strict_reference)
        row = torch.floor(base).nan_to_num_(nan=0.0).clamp_(0, size - 1)
        return row.to(torch.int64).expand(n, q)

    return floor(2, d) // dz * -(-h // ty) + floor(1, h) // ty


def plain_plan(grid: torch.Tensor, cells_shape, cfg: SamplerConfig,
               tile=None) -> PairPlan:
    """The plan of ``grid`` (N or 1, *out, 3) over (N, C, D, H, W) cells
    with tiles ``tile`` (``geometry``'s by default), on the grid's device:
    a stable sort of the (cell, tile) keys, so the pairs of one key keep
    their query order (the kernel's order within a key is its
    atomics')."""
    n, c, d, h, _ = cells_shape
    dz, ty = geometry(c, cells_shape[2:]) if tile is None else tile
    tiles = _tiles_of(d, h, dz, ty)
    q = math.prod(grid.shape[1:-1])
    device = grid.device
    key = (_tile_keys(grid, cells_shape, cfg, dz, ty)
           + torch.arange(0, n * tiles, tiles, device=device)[:, None]
           ).reshape(-1)
    skey, perm = torch.sort(key, stable=True)
    starts = torch.searchsorted(skey, torch.arange(n * tiles + 1,
                                                   device=device))
    return PairPlan(perm.to(torch.int32), starts.to(torch.int32), n, q, dz,
                    ty)


def make_plan(grid: torch.Tensor, cells_shape, cfg: SamplerConfig,
              tile=None) -> PairPlan:
    """The plan of ``grid`` over (N, C, D, H, W) cells with tiles ``tile``
    (``geometry``'s by default): csrc/percell.cu percell_plan on a CUDA
    grid, ``plain_plan`` on a CPU one."""
    if grid.device.type == "cpu":
        return plain_plan(grid, cells_shape, cfg, tile)
    device = cuda_device(grid)
    _check_tensors(grid)
    n, c, d, h, w = cells_shape
    q = _check_shapes(cfg, n, (d, h, w), grid, (0, 0, 0))
    dz, ty = geometry(c, (d, h, w)) if tile is None else tile
    tiles = _tiles_of(d, h, dz, ty)
    if (n * max(q, tiles) >= 2**31 or tiles > BIN_MAX_KEYS
            or not (1 <= dz <= d and 1 <= ty <= h)):
        raise ValueError(f"the percell plan takes 2^31 pairs and "
                         f"{BIN_MAX_KEYS} tiles a cell, got {n} x {q} pairs "
                         f"and tiles ({dz}, {ty}) of ({d}, {h})")
    lib = load_kernels()
    key = torch.empty(n * q, dtype=torch.int32, device=device)
    rank = torch.empty_like(key)
    perm = torch.empty_like(key)
    starts = torch.zeros(n * tiles + 1, dtype=torch.int32, device=device)
    step, stop = offset_lattice(n, cfg.multicell)
    with torch.cuda.device(device):
        err = lib.percell_plan(
            grid.data_ptr(), key.data_ptr(), rank.data_ptr(),
            starts.data_ptr(), perm.data_ptr(), n, d, h, w, q, grid.shape[0],
            dz, ty, PADDING_IDS[cfg.padding_mode], int(cfg.align_corners),
            int(cfg.multicell), int(cfg.strict_reference), float(step),
            float(stop), torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, "percell_plan launch")
    make_plan.launches += 1
    return PairPlan(perm, starts, n, q, dz, ty)


def _check_plan(plan: PairPlan, n: int, q: int, spatial) -> None:
    d, h, _ = spatial
    tiles = (_tiles_of(d, h, plan.dz, plan.ty)
             if 1 <= plan.dz <= d and 1 <= plan.ty <= h else -1)
    if (plan.n != n or plan.q != q or plan.perm.shape != (n * q,)
            or plan.starts.shape != (n * tiles + 1,)):
        raise ValueError(f"the pair plan is for {plan.n} cells x {plan.q} "
                         f"queries in tiles ({plan.dz}, {plan.ty}), the call "
                         f"has {n} x {q} over {tuple(spatial)}")


def _slots(grid, plan: PairPlan, n: int, cfg: SamplerConfig):
    """Each slot's cell (P,), query (P,), coordinates (1, P, 3) and cell
    shift (1, P)."""
    pair = plan.perm.to(torch.int64)
    cell, qi = pair // plan.q, pair % plan.q
    gf = grid.reshape(grid.shape[0], plan.q, 3)
    pts = gf[cell if grid.shape[0] > 1 else 0, qi]
    shift = multicell_offsets(n, cfg.multicell, grid.dtype, grid.device)
    return cell, qi, pts[None], shift[cell][None]


def plain_blend_percell(input, grid, cfg: SamplerConfig,
                        orders: Tuple[int, ...], plan: PairPlan):
    """generic.blend computed slot by slot in the plan's order, each slot's
    corners read from its tile's window (z rows [z0, z0 + dz], y rows
    [y0, y0 + ty]) where the kernel stages one (csrc/percell.cu), written
    in query order: (N, C, *out_spatial)."""
    n, c, *spatial = input.shape
    d, h, _ = spatial
    _check_plan(plan, n, math.prod(grid.shape[1:-1]), spatial)
    cell, qi, pts, shift = _slots(grid, plan, n, cfg)
    tables = generic.per_axis_tables(pts, spatial, cfg, orders, n,
                                     fwd_quirk=True, offset=shift)
    staged = channels(c, spatial, plan.dz, plan.ty) > 0
    if staged:
        slot = torch.arange(cell.numel(), device=input.device)
        tile = torch.searchsorted(plan.starts.to(torch.int64), slot,
                                  right=True) - 1
        bands = -(-h // plan.ty)
        tile = tile - cell * _tiles_of(d, h, plan.dz, plan.ty)
        z0 = tile // bands * plan.dz
        y0 = tile % bands * plan.ty
    total = math.prod(spatial)
    inp = input.reshape(n, c, total)
    vals = torch.zeros((c, cell.numel()), dtype=input.dtype,
                       device=input.device)
    for corner in itertools.product((0, 1), repeat=3):
        idx, wgt, ok = generic.corner_index_weight(tables, corner, spatial, 3)
        if staged:
            y = tables[1][0] + corner[1]
            z = tables[2][0] + corner[2]
            ok = (ok & (z >= z0) & (z <= z0 + plan.dz) & (y >= y0)
                  & (y <= y0 + plan.ty))
        v = inp[cell, :, idx[0].clamp(0, total - 1)].T        # (C, P)
        vals = vals + torch.where(ok, wgt * v, 0.0)
    out = torch.zeros((n, c, plan.q), dtype=input.dtype, device=input.device)
    out[cell, :, qi] = vals.T
    return out.reshape(n, c, *grid.shape[1:-1])


def plain_splat_percell(gout, grid, in_spatial: Tuple[int, ...],
                        cfg: SamplerConfig, orders: Tuple[int, ...],
                        plan: PairPlan):
    """generic.splat with the contributions taken slot by slot in the
    plan's order: (N, C, *in_spatial)."""
    in_spatial = tuple(in_spatial)
    n, c = gout.shape[:2]
    _check_plan(plan, n, math.prod(grid.shape[1:-1]), in_spatial)
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
    _check_plan(plan, n, q, spatial)
    for t in (plan.perm, plan.starts):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("the plan's perm and starts must be contiguous "
                             "int32")
    return q


def blend(input: torch.Tensor, grid: torch.Tensor, cfg: SamplerConfig,
          orders: Tuple[int, ...], plan: PairPlan) -> torch.Tensor:
    """(N, C, *out_spatial): generic.blend of (N, C, D, H, W) cells at the
    grid, tile by tile through the pair plan of ``grid``; kernel on CUDA
    tensors, plain on CPU ones."""
    if input.device.type == "cpu" and grid.device.type == "cpu":
        return plain_blend_percell(input, grid, cfg, orders, plan)
    device = cuda_device(input, grid, plan.perm, plan.starts)
    _check_tensors(input, grid)
    n, c, *spatial = input.shape
    q = _check_call(cfg, n, spatial, grid, orders, plan)
    cc = channels(c, spatial, plan.dz, plan.ty)
    out = torch.empty((n, c, q), dtype=torch.float32, device=device)
    launch_pairs("percell_blend", (input, grid, plan.perm, plan.starts, out),
                 cfg, n, c, spatial, q, grid.shape[0], orders,
                 effective_align(cfg, orders),
                 extra=(plan.dz, plan.ty, cc or c, int(cc > 0)))
    blend.launches += 1
    return out.view(n, c, *grid.shape[1:-1])


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
make_plan.launches = 0
