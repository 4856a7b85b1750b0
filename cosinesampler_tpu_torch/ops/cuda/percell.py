"""Binned per-cell blend_o / splat_o: the tiles, the pair plan, the plain
versions and the wrappers of csrc/percell.cu.

Counterpart of the JAX package's ops/pallas/percell.py, the route of the
public sampler's per-order blend and splat over 3D volumes whose rows are
too large for the slab kernels (ops/cuda/route.py rule):

* **The pair plan** (``make_plan``, ``PairPlan``): every (cell, query)
  pair, a shared grid expanded to N x Q pairs since each cell has its own
  offset lattice, keyed by its cell and the (z row, y row) of its floor
  corner (the z and y floors of the cell's own source coordinate, folded
  as the sampler folds them and clamped to the cell's rows), ordered by
  key, with the first slot of each (cell, key).  Where a cell's D x H
  rows are more keys than the plan's histogram holds, a key takes ``ky``
  y rows (and, past that, ``kz`` z rows: ``key_grid``).  On the card it
  is csrc/percell.cu percell_plan, the counting sort of
  csrc/pair_bins.cuh with no host sync, its order within a key that of
  its atomics; ``plain_plan``, a stable sort of the same keys, is its
  oracle.  The JAX package's per-bin block padding, window DMA chain and
  ``_FP`` front pad serve its VMEM windows and are not carried over.
* **The tiles**: a kernel block owns ``dz`` z rows by ``ty`` y rows of a
  cell and walks the plan's slot ranges of the keys its pairs can have
  (``_walk``).  A blend block (``geometry``) stages its tile's window, z
  rows [z0, z0 + dz] by y rows [y0, y0 + ty] of ``cc`` channels, in
  TILE_BYTES of shared memory, so that two blocks share an SM; the tile
  is the one with the fewest halo rows to stage per owned row.  Where two
  rows of one channel of two planes do not fit, the blend is not staged
  and gathers from the volume.  A splat block (``splat_geometry``)
  accumulates its own rows of ``cc`` channels in SPLAT_BYTES of shared
  memory and writes them once; it walks the pairs of its rows and of the
  row before them on z and y, and its tile is the one that walks the
  fewest pairs per owned pair.
* ``plain_blend_percell`` / ``plain_splat_percell``: plain PyTorch over
  the plan's slot order (ops/generic.py's corner math, each slot with its
  cell's shift); the blend reads each slot's corners from the window of
  the tile that owns its floor, as the kernel does, and writes query
  order.  They are the oracle the kernels are held to.
  ``plain_splat_percell_tiles`` adds, tile by tile, only the slots the
  splat kernel's walk reaches, as a check that the walk misses no pair.
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
from typing import NamedTuple, Optional, Tuple

import torch

from .. import generic
from ..config import SamplerConfig, effective_align
from ..coords import compute_source_coords, multicell_offsets, offset_lattice
from .blend_splat import _check_shapes, _check_tensors, launch_pairs
from .build import BLOCK_SMEM_BYTES, check, load_kernels
from .fused2w import PADDING_IDS, cuda_device

__all__ = ["PairPlan", "SplatTile", "blend", "geometry", "key_grid",
           "make_plan", "plain_blend_percell", "plain_plan",
           "plain_splat_percell", "plain_splat_percell_tiles", "splat",
           "splat_geometry", "supports"]

# the shared memory a blend tile may take, its mbarrier and walk table
# included: two blocks on an SM's 228 KB, each with the 1 KB the card
# reserves a block (a module attribute, so that tests can shrink it)
TILE_BYTES = 113 * 1024
# The splat's tiles, by chip_smoke.py's splat tile sweep (PERF.md section
# 6; module attributes, which tests shrink): one z row of SPLAT_ROWS y
# rows of all channels where they fit SPLAT_BYTES with the walk table
# (four 256-thread blocks an SM, as many as its registers allow); else
# the tile that walks the fewest pairs a pair owned in
# SPLAT_FALLBACK_BYTES, else in BLOCK_SMEM_BYTES (one block an SM).
SPLAT_ROWS = 18
SPLAT_BYTES = 56 * 1024
SPLAT_FALLBACK_BYTES = 37 * 1024
# the mbarrier ahead of a staged window (csrc/percell.cu kBarrierBytes)
BARRIER_BYTES = 16
# the most z rows a tile owns (csrc/percell.cu kMaxTileRows; a module
# attribute, which chip_smoke.py's tile sweep lowers), and the static
# shared memory of a block's walk table (its Walk: a first slot and a
# running count a slot range, kMaxTileRows + 1 ranges)
MAX_TILE_ROWS = 64
WALK_BYTES = 4 * (2 * MAX_TILE_ROWS + 3)
# the most keys a cell may have: the plan's count kernel keeps one int32 a
# key of a cell in a block's shared memory
BIN_MAX_KEYS = BLOCK_SMEM_BYTES // 4


def _keys_of(d: int, h: int, kz: int, ky: int) -> int:
    return -(-d // kz) * -(-h // ky)


def key_grid(d: int, h: int) -> Tuple[int, int]:
    """(kz, ky): the z and y rows a plan key takes over (D, H) rows, a
    key a row wherever a cell's D * H keys fit BIN_MAX_KEYS, else the
    fewest y rows (and then z rows) a key that fit."""
    for ky in range(1, h + 1):
        if d * -(-h // ky) <= BIN_MAX_KEYS:
            return 1, ky
    return -(-d // BIN_MAX_KEYS), h


def _window_bytes(cc: int, d: int, h: int, w: int, dz: int, ty: int) -> int:
    return (BARRIER_BYTES + WALK_BYTES
            + 4 * cc * min(dz + 1, d) * min(ty + 1, h) * w)


@functools.lru_cache(maxsize=256)
def _geometry(c: int, spatial: Tuple[int, int, int], budget: int,
              max_rows: int):
    d, h, w = spatial
    best = None
    for dz in range(1, min(d, max_rows) + 1):
        zrows = min(dz + 1, d)
        # the most y rows a band takes with its halo row, all channels
        ty = (budget - BARRIER_BYTES - WALK_BYTES) // (4 * c * zrows * w) - 1
        if ty < 1:
            break
        ty = min(ty, h)
        # rows staged per row owned
        cost = zrows * min(ty + 1, h) / (min(dz, d) * ty)
        if best is None or cost < best[0]:
            best = (cost, dz, ty)
    return None if best is None else best[1:]


def geometry(c: int, spatial) -> Tuple[int, int]:
    """(dz, ty): the blend's tiles of (D, H, W) cells of ``c`` channels,
    the fewest staged rows per owned row among those whose window of all
    channels fits TILE_BYTES, else of one channel, each of at most
    MAX_TILE_ROWS z rows; where none fits, tiles of one z row and whole
    planes, not staged."""
    for cc in (c, 1):
        tile = _geometry(cc, tuple(spatial), TILE_BYTES, MAX_TILE_ROWS)
        if tile is not None:
            return tile
    return 1, spatial[1]


def channels(c: int, spatial, dz: int, ty: int) -> int:
    """The channels a blend block stages for tiles (dz, ty): the most that
    fit TILE_BYTES, 0 if one does not (the blend then gathers from the
    volume)."""
    d, h, w = spatial
    for cc in range(c, 0, -1):
        if _window_bytes(cc, d, h, w, dz, ty) <= TILE_BYTES:
            return cc
    return 0


class SplatTile(NamedTuple):
    """One percell_splat launch's tiles (csrc/percell.cu): ``dz`` z rows
    by ``ty`` y rows of all W, ``cc`` channels a block, ``threads`` a
    block (the kernel's instantiations: 256, four blocks an SM, and 1024,
    one)."""
    dz: int
    ty: int
    cc: int
    threads: int

    def smem_bytes(self, w: int) -> int:
        """The shared memory a block takes, its walk table included."""
        return WALK_BYTES + 4 * self.cc * self.dz * self.ty * w


@functools.lru_cache(maxsize=256)
def _splat_geometry(c: int, spatial: Tuple[int, int, int], budget: int,
                    max_rows: int):
    """The (dz, ty, cc) in ``budget`` bytes that walks the fewest pairs a
    pair owned: the floor rows before the tile on z and y where the cell
    has them, each channel chunk walking them; None if none fits."""
    d, h, w = spatial
    best = None
    for cc in range(c, 0, -1):
        for dz in range(1, min(d, max_rows) + 1):
            ty = min((budget - WALK_BYTES) // (4 * cc * dz * w), h)
            if ty < 1:
                break
            cost = (-(-c // cc) * (min(dz, d) + (dz < d)) * (ty + (ty < h))
                    / (min(dz, d) * ty))
            key = (cost, -min(dz, d) * ty)
            if best is None or key < best[0]:
                best = (key, min(dz, d), ty, cc)
    return None if best is None else best[1:]


def splat_geometry(c: int, spatial) -> Optional[SplatTile]:
    """The splat's tiles of (D, H, W) cells of ``c`` channels: one z row
    of SPLAT_ROWS y rows (all of them, where fewer) of all channels in
    256-thread blocks, four an SM, where they fit SPLAT_BYTES; else the
    tile that walks the fewest pairs a pair owned in SPLAT_FALLBACK_BYTES
    (so blocks), else in BLOCK_SMEM_BYTES (1024 threads, one block an
    SM).  None where one row of one channel fits no block."""
    d, h, w = spatial
    row = SplatTile(1, min(SPLAT_ROWS, h), c, 256)
    if row.smem_bytes(w) <= SPLAT_BYTES:
        return row
    spatial = tuple(spatial)
    tile = _splat_geometry(c, spatial, SPLAT_FALLBACK_BYTES, MAX_TILE_ROWS)
    if tile is not None:
        return SplatTile(*tile, 256)
    tile = _splat_geometry(c, spatial, BLOCK_SMEM_BYTES, MAX_TILE_ROWS)
    return None if tile is None else SplatTile(*tile, 1024)


@dataclasses.dataclass(frozen=True)
class PairPlan:
    """The (cell, key) order of the N * Q pairs of one grid.

    ``perm`` (P,) int32 is the pair index ``n * Q + q`` of each slot; the
    slots of cell n are ``n * Q`` to ``n * Q + Q - 1``.  ``starts``
    (N * K + 1,) int32 is the first slot of each (cell, key), K keys of
    (kz z rows, ky y rows) a cell in (z key, y key) order, and the pair
    count last."""
    perm: torch.Tensor
    starts: torch.Tensor
    n: int
    q: int
    kz: int
    ky: int


def supports(cfg: SamplerConfig, cells_shape) -> bool:
    """Whether the percell kernels take this config and (N, C, D, H, W)
    shape: 3D (as the JAX package's route), any padding and order, rows
    of which one of one channel fits a splat block."""
    return (cfg.dim == 3 and len(cells_shape) == 5
            and splat_geometry(cells_shape[1], cells_shape[2:]) is not None)


def _floors(grid, cells_shape, cfg: SamplerConfig):
    """(z floors, y floors), each (N, Q) int64: the floors of each pair's
    source coordinates folded as the sampler folds them and clamped to
    the cell's rows, computed in the grid's dtype as ops/generic.py
    computes the corners' floor."""
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

    return floor(2, d), floor(1, h)


def plain_plan(grid: torch.Tensor, cells_shape, cfg: SamplerConfig,
               keys=None) -> PairPlan:
    """The plan of ``grid`` (N or 1, *out, 3) over (N, C, D, H, W) cells
    with keys of ``keys`` = (kz, ky) rows (``key_grid``'s by default), on
    the grid's device: a stable sort of the (cell, key) keys, so the
    pairs of one key keep their query order (the kernel's order within a
    key is its atomics')."""
    n, _, d, h, _ = cells_shape
    kz, ky = key_grid(d, h) if keys is None else keys
    per_cell = _keys_of(d, h, kz, ky)
    q = math.prod(grid.shape[1:-1])
    device = grid.device
    fz, fy = _floors(grid, cells_shape, cfg)
    key = (fz // kz * -(-h // ky) + fy // ky
           + torch.arange(0, n * per_cell, per_cell, device=device)[:, None]
           ).reshape(-1)
    skey, perm = torch.sort(key, stable=True)
    starts = torch.searchsorted(skey, torch.arange(n * per_cell + 1,
                                                   device=device))
    return PairPlan(perm.to(torch.int32), starts.to(torch.int32), n, q, kz,
                    ky)


def make_plan(grid: torch.Tensor, cells_shape, cfg: SamplerConfig,
              keys=None) -> PairPlan:
    """The plan of ``grid`` over (N, C, D, H, W) cells with keys of
    ``keys`` = (kz, ky) rows (``key_grid``'s by default):
    csrc/percell.cu percell_plan on a CUDA grid, ``plain_plan`` on a CPU
    one."""
    if grid.device.type == "cpu":
        return plain_plan(grid, cells_shape, cfg, keys)
    device = cuda_device(grid)
    _check_tensors(grid)
    n, c, d, h, w = cells_shape
    q = _check_shapes(cfg, n, (d, h, w), grid, (0, 0, 0))
    kz, ky = key_grid(d, h) if keys is None else keys
    per_cell = _keys_of(d, h, kz, ky) if kz >= 1 and ky >= 1 else 0
    if (n * max(q, per_cell) >= 2**31 or not 1 <= per_cell <= BIN_MAX_KEYS):
        raise ValueError(f"the percell plan takes 2^31 pairs and "
                         f"{BIN_MAX_KEYS} keys a cell, got {n} x {q} pairs "
                         f"and keys ({kz}, {ky}) of ({d}, {h}) rows")
    lib = load_kernels()
    key = torch.empty(n * q, dtype=torch.int32, device=device)
    rank = torch.empty_like(key)
    perm = torch.empty_like(key)
    starts = torch.zeros(n * per_cell + 1, dtype=torch.int32, device=device)
    sums = torch.empty(lib.percell_scan_scratch(n * per_cell),
                       dtype=torch.int32, device=device)
    step, stop = offset_lattice(n, cfg.multicell)
    with torch.cuda.device(device):
        err = lib.percell_plan(
            grid.data_ptr(), key.data_ptr(), rank.data_ptr(),
            starts.data_ptr(), perm.data_ptr(), sums.data_ptr(), n, d, h, w,
            q, grid.shape[0], kz, ky, PADDING_IDS[cfg.padding_mode],
            int(cfg.align_corners), int(cfg.multicell),
            int(cfg.strict_reference), float(step), float(stop),
            torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, "percell_plan launch")
    make_plan.launches += 1
    return PairPlan(perm, starts, n, q, kz, ky)


def _check_plan(plan: PairPlan, n: int, q: int, spatial) -> None:
    d, h, _ = spatial
    keys = (_keys_of(d, h, plan.kz, plan.ky)
            if plan.kz >= 1 and plan.ky >= 1 else -1)
    if (plan.n != n or plan.q != q or plan.perm.shape != (n * q,)
            or plan.starts.shape != (n * keys + 1,)):
        raise ValueError(f"the pair plan is for {plan.n} cells x {plan.q} "
                         f"queries in keys of ({plan.kz}, {plan.ky}) rows, "
                         f"the call has {n} x {q} over {tuple(spatial)}")


def _tile_rows(d: int, h: int, dz: int, ty: int):
    """Each tile's first z row, first y row and own z and y rows, (T,)
    int64 each, in (z tile, y band) order: csrc/percell.cu TileBlock."""
    z0, y0 = torch.meshgrid(torch.arange(0, d, dz), torch.arange(0, h, ty),
                            indexing="ij")
    z0, y0 = z0.reshape(-1), y0.reshape(-1)
    return z0, y0, (d - z0).clamp(max=dz), (h - y0).clamp(max=ty)


def _walk(plan: PairPlan, spatial, dz: int, ty: int, halo: int):
    """The slots the kernel block of each (cell, tile) walks
    (csrc/percell.cu walk_init): the plan's slot ranges of the keys of
    floors z in [z0 - halo, z0 + rows - 1] x y in [y0 - halo,
    y0 + yrows - 1], clamped to the cell, one range a z key.  Returns
    the walker of each walked slot (cell * T + tile) and the slot, (W,)
    int64 each, on the plan's device."""
    d, h, _ = spatial
    kz, ky = plan.kz, plan.ky
    nyk = -(-h // ky)
    per_cell = _keys_of(d, h, kz, ky)
    device = plan.starts.device
    z0, y0, rows, yrows = (t.to(device) for t in _tile_rows(d, h, dz, ty))
    tiles = z0.numel()
    zlo = (z0 - halo).clamp(min=0) // kz
    nr = (z0 + rows - 1) // kz - zlo + 1
    ylo = (y0 - halo).clamp(min=0) // ky
    yhi = (y0 + yrows - 1) // ky
    tile = torch.repeat_interleave(torch.arange(tiles, device=device), nr)
    zk = zlo[tile] + torch.arange(tile.numel(), device=device) - \
        torch.repeat_interleave(torch.cumsum(nr, 0) - nr, nr)
    cell_base = torch.arange(plan.n, device=device)[:, None] * per_cell
    starts = plan.starts.to(torch.int64)
    first = starts[cell_base + zk * nyk + ylo[tile]].reshape(-1)
    last = starts[cell_base + zk * nyk + yhi[tile] + 1].reshape(-1)
    walker = (torch.arange(plan.n, device=device)[:, None] * tiles
              + tile).reshape(-1)
    lengths = last - first
    run = torch.repeat_interleave(torch.cumsum(lengths, 0) - lengths,
                                  lengths)
    slot = (torch.repeat_interleave(first, lengths)
            + torch.arange(run.numel(), device=device) - run)
    return torch.repeat_interleave(walker, lengths), slot


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
                        orders: Tuple[int, ...], plan: PairPlan, tile=None):
    """generic.blend computed slot by slot in the plan's order, each slot's
    corners read from the window of the blend tile ``tile`` (``geometry``'s
    by default) that owns its floor (z rows [z0, z0 + dz], y rows
    [y0, y0 + ty]) where the kernel stages one (csrc/percell.cu), written
    in query order: (N, C, *out_spatial)."""
    n, c, *spatial = input.shape
    _check_plan(plan, n, math.prod(grid.shape[1:-1]), spatial)
    dz, ty = geometry(c, spatial) if tile is None else tile
    cell, qi, pts, shift = _slots(grid, plan, n, cfg)
    tables = generic.per_axis_tables(pts, spatial, cfg, orders, n,
                                     fwd_quirk=True, offset=shift)
    staged = channels(c, spatial, dz, ty) > 0
    if staged:
        fz, fy = _floors(grid, (n, c, *spatial), cfg)
        z0 = fz[cell, qi] // dz * dz
        y0 = fy[cell, qi] // ty * ty
    total = math.prod(spatial)
    inp = input.reshape(n, c, total)
    vals = torch.zeros((c, cell.numel()), dtype=input.dtype,
                       device=input.device)
    for corner in itertools.product((0, 1), repeat=3):
        idx, wgt, ok = generic.corner_index_weight(tables, corner, spatial, 3)
        if staged:
            y = tables[1][0] + corner[1]
            z = tables[2][0] + corner[2]
            ok = (ok & (z >= z0) & (z <= z0 + dz) & (y >= y0)
                  & (y <= y0 + ty))
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


def plain_splat_percell_tiles(gout, grid, in_spatial: Tuple[int, ...],
                              cfg: SamplerConfig, orders: Tuple[int, ...],
                              plan: PairPlan, tile=None):
    """generic.splat as the splat kernel walks it: each tile of ``tile``
    (a SplatTile or its (dz, ty); ``splat_geometry``'s by default) adds
    the corners in its own rows of only the slots its block walks
    (``_walk``), its cell's (the slot's query as the kernel takes it: its
    pair less the tile's cell times Q): (N, C, *in_spatial)."""
    in_spatial = tuple(in_spatial)
    n, c = gout.shape[:2]
    d, h, _ = in_spatial
    _check_plan(plan, n, math.prod(grid.shape[1:-1]), in_spatial)
    dz, ty = (splat_geometry(c, in_spatial) if tile is None else tile)[:2]
    walker, slot = _walk(plan, in_spatial, dz, ty, 1)
    z0, y0, rows, yrows = (t.to(gout.device)[walker % len(t)]
                           for t in _tile_rows(d, h, dz, ty))
    cell = walker // -(-d // dz) // -(-h // ty)
    qi = plan.perm.to(torch.int64)[slot] - cell * plan.q
    gf = grid.reshape(grid.shape[0], plan.q, 3)
    pts = gf[cell if grid.shape[0] > 1 else 0, qi][None]
    shift = multicell_offsets(n, cfg.multicell, grid.dtype,
                              grid.device)[cell][None]
    tables = generic.per_axis_tables(pts, in_spatial, cfg, orders, n,
                                     offset=shift)
    total = math.prod(in_spatial)
    g = gout.reshape(n, c, plan.q)[cell, :, qi]                # (W, C)
    base = (cell[:, None] * c + torch.arange(c, device=gout.device)) * total
    acc = torch.zeros((n * c * total,), dtype=gout.dtype, device=gout.device)
    for corner in itertools.product((0, 1), repeat=3):
        idx, wgt, ok = generic.corner_index_weight(tables, corner, in_spatial,
                                                   3)
        y = tables[1][0][0] + corner[1] - y0
        z = tables[2][0][0] + corner[2] - z0
        ok = ok[0] & (y >= 0) & (y < yrows) & (z >= 0) & (z < rows)
        contrib = torch.where(ok[:, None], wgt[0][:, None] * g, 0.0)
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
    grid, in ``geometry``'s tiles, through the pair plan of ``grid``;
    kernel on CUDA tensors, plain on CPU ones."""
    if input.device.type == "cpu" and grid.device.type == "cpu":
        return plain_blend_percell(input, grid, cfg, orders, plan)
    device = cuda_device(input, grid, plan.perm, plan.starts)
    _check_tensors(input, grid)
    n, c, *spatial = input.shape
    q = _check_call(cfg, n, spatial, grid, orders, plan)
    dz, ty = geometry(c, spatial)
    cc = channels(c, spatial, dz, ty)
    out = torch.empty((n, c, q), dtype=torch.float32, device=device)
    launch_pairs("percell_blend", (input, grid, plan.perm, plan.starts, out),
                 cfg, n, c, spatial, q, grid.shape[0], orders,
                 effective_align(cfg, orders),
                 extra=(plan.kz, plan.ky, dz, ty, cc or c, int(cc > 0)))
    blend.launches += 1
    return out.view(n, c, *grid.shape[1:-1])


def splat(gout: torch.Tensor, grid: torch.Tensor,
          in_spatial: Tuple[int, ...], cfg: SamplerConfig,
          orders: Tuple[int, ...], plan: PairPlan) -> torch.Tensor:
    """(N, C, *in_spatial): generic.splat, the transpose of blend, through
    the pair plan of ``grid`` in ``splat_geometry``'s tiles; kernel on
    CUDA tensors, plain on CPU ones."""
    if gout.device.type == "cpu" and grid.device.type == "cpu":
        return plain_splat_percell(gout, grid, in_spatial, cfg, orders, plan)
    device = cuda_device(gout, grid, plan.perm, plan.starts)
    _check_tensors(gout, grid)
    n, c = gout.shape[:2]
    in_spatial = tuple(in_spatial)
    q = _check_call(cfg, n, in_spatial, grid, orders, plan)
    if math.prod(gout.shape[2:]) != q:
        raise ValueError(f"gout {tuple(gout.shape)} does not match the grid "
                         f"{tuple(grid.shape)}")
    tile = splat_geometry(c, in_spatial)
    if tile is None:
        raise ValueError(f"percell_splat takes rows of which one of one "
                         f"channel fits a block's shared memory, got "
                         f"{in_spatial}")
    out = torch.empty((n, c, *in_spatial), dtype=torch.float32, device=device)
    launch_pairs("percell_splat", (gout, grid, plan.perm, plan.starts, out),
                 cfg, n, c, in_spatial, q, grid.shape[0], orders,
                 cfg.align_corners,
                 extra=(plan.kz, plan.ky, *tile))
    splat.launches += 1
    return out


blend.launches = 0
splat.launches = 0
make_plan.launches = 0
