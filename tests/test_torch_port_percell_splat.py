"""PyTorch port, the percell splat's tiles: each block of csrc/percell.cu's
percell_splat owns a tile of a cell's rows, adds the pairs of the plan's
slot ranges it walks into shared memory and stores the tile once.  These
tests hold the plain version of that walk (``plain_splat_percell_tiles``)
to the oracle (``plain_splat_percell``), to ops/generic.py and to the JAX
package's Pallas splat in interpret mode, with tiles and keys small
enough that the cells of tests/test_torch_port_percell.py have many, and
points on every tile's first and last rows, on the cell's first and last
rows and past them; and the host side of the kernels' launches (tiles,
keys, the walk's ranges, the C entry points' declarations).

The kernel itself is held to the plain splat on the card by chip_smoke.py.
"""

import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas import percell as jpercell
from cosinesampler_tpu_torch.ops import generic as tgeneric
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.coords import (compute_source_coords,
                                                multicell_offsets)
from cosinesampler_tpu_torch.ops.cuda import build, percell, route
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_percell import C, N_CELL, Q, SHAPE, _data

# splat tiles of 3 z rows by 4 y rows of both channels (a 20 x 16 cell
# has 7 x 4 of them, ragged on z), and blend tiles of 2 x 3 rows
SPLAT_TILE = (3, 4, C)
SPLAT_BUDGET = percell.WALK_BYTES + 4 * C * 3 * 4 * SHAPE[2]
BLEND_BUDGET = 16 + percell.WALK_BYTES + 4 * C * 3 * 4 * SHAPE[2]


@pytest.fixture
def small_tiles(monkeypatch):
    monkeypatch.setattr(percell, "SPLAT_BYTES", SPLAT_BUDGET)
    monkeypatch.setattr(percell, "SPLAT_FALLBACK_BYTES", SPLAT_BUDGET)
    monkeypatch.setattr(percell, "TILE_BYTES", BLEND_BUDGET)
    assert percell.splat_geometry(C, SHAPE) == (*SPLAT_TILE, 256)
    assert percell.geometry(C, SHAPE) == (2, 3)


def _edge_grid(seed, cfg, per_cell, dtype):
    """(N or 1, Q, 1, 3) points whose z and y source coordinates (each
    cell's own shift where the grid is per cell, cell 0's where it is
    shared) fall on the first and last rows of every splat and blend
    tile, on the cell's first and last rows and a row past each, each a
    hair either side and half a row on; x anywhere, past the cell too."""
    rng = np.random.RandomState(seed)
    gb = N_CELL if per_cell else 1
    grid = rng.uniform(-1.3, 1.3, (gb, Q, 1, 3))
    shifts = multicell_offsets(N_CELL, cfg.multicell, torch.float64)
    for axis, steps in ((2, (SPLAT_TILE[0], 2)), (1, (SPLAT_TILE[1], 3))):
        size = SHAPE[2 - axis]
        edges = sorted({e for st in steps for t in range(0, size, st)
                        for e in (t, t + st - 1)} | {-1, 0, size - 1, size})
        rows = np.array([e + h for e in edges for h in (-1e-3, 0, 1e-3, .5)])
        for n in range(gb):
            # the unnormalisation is affine: invert it through two points
            ends, _ = compute_source_coords(
                torch.tensor([-1.0, 1.0], dtype=torch.float64), size,
                "zeros", cfg.align_corners, cfg.multicell, shifts[n])
            lo, hi = float(ends[0]), float(ends[1])
            pick = rows[rng.randint(0, len(rows), Q)]
            grid[n, :, 0, axis] = (pick - lo) / (hi - lo) * 2.0 - 1.0
    return torch.from_numpy(grid.astype(dtype))


def _close_rows(got, want, rtol):
    """Each (cell, channel) row within rtol of its largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    n, c = want.shape[:2]
    for i in range(n):
        for j in range(c):
            scale = float(np.abs(want[i, j]).max())
            np.testing.assert_allclose(got[i, j], want[i, j], rtol=0,
                                       atol=rtol * scale)


SPLAT_CASES = [
    # (config flags, orders walked in f64, the order also held to the
    # Pallas splat in interpret mode, per-cell grid)
    (dict(), ((0, 0, 0), (0, 0, 3)), (0, 0, 0), True),
    (dict(padding_mode="border", align_corners=False),
     ((0, 0, 1), (1, 2, 0)), (1, 2, 0), False),
    (dict(padding_mode="reflection", multicell=False),
     ((0, 0, 2), (0, 0, 0)), (0, 0, 2), True),
    (dict(padding_mode="reflection", strict_reference=True,
          align_corners=False), ((0, 0, 3), (2, 1, 1)), (0, 0, 3), False),
]


@pytest.mark.parametrize("kw,orders_list,interpret_orders,per_cell",
                         SPLAT_CASES)
def test_splat_walk_matches_oracle_and_pallas(small_tiles, kw, orders_list,
                                              interpret_orders, per_cell):
    """The splat as its blocks walk it (each tile only the slot ranges of
    the keys of floors one row before it to its last row, a key a (z row,
    y row)) against plain_splat_percell and generic.splat in f64 at 1e-12
    of each (cell, channel) row's largest value, and in f32 against the
    JAX package's pallas_splat_percell in interpret mode at 1e-5, on
    points on every tile edge, the cell's first and last rows and past
    them; the wrapper on the CPU is the oracle."""
    cfg = TConfig(dim=3, **kw)
    grid = _edge_grid(1, cfg, per_cell, np.float64)
    _, _, g = _data(2, dtype=np.float64)
    g = torch.from_numpy(g)
    plan = percell.make_plan(grid, (N_CELL, C, *SHAPE), cfg)
    assert (plan.kz, plan.ky) == (1, 1)
    for orders in orders_list:
        got = percell.plain_splat_percell_tiles(g, grid, SHAPE, cfg, orders,
                                                plan)
        want = percell.plain_splat_percell(g, grid, SHAPE, cfg, orders, plan)
        _close_rows(got, want, 1e-12)
        _close_rows(got, tgeneric.splat(g, grid, SHAPE, cfg, orders), 1e-12)
        assert torch.equal(percell.splat(g, grid, SHAPE, cfg, orders, plan),
                           want)
    g32, grid32 = g.float(), grid.float()
    plan32 = percell.make_plan(grid32, (N_CELL, C, *SHAPE), cfg)
    got = percell.plain_splat_percell_tiles(g32, grid32, SHAPE, cfg,
                                            interpret_orders, plan32)
    want = jpercell.pallas_splat_percell(
        jnp.asarray(g32.numpy()), jnp.asarray(grid32.numpy()), SHAPE,
        JConfig(dim=3, backend="pallas", **kw), interpret_orders,
        interpret=True)
    _close_rows(got.numpy(), want, 1e-5)


def test_splat_walk_with_coarse_keys(small_tiles):
    """Keys of several rows (where a cell's rows outnumber the plan's
    histogram): the walk takes the ranges of the keys holding its floors,
    pairs of other rows among them, whose corners outside the tile it
    drops; f64 against plain_splat_percell at 1e-12, for keys of 2 x 3
    rows, 3 z rows x all y rows, whole z and a y row, and tiles of whole
    planes and of one row."""
    cfg = TConfig(dim=3, padding_mode="border")
    grid = _edge_grid(3, cfg, True, np.float64)
    _, _, g = _data(4, dtype=np.float64)
    g = torch.from_numpy(g)
    for keys in ((2, 3), (3, SHAPE[1]), (SHAPE[0], 1)):
        plan = percell.make_plan(grid, (N_CELL, C, *SHAPE), cfg, keys)
        want = percell.plain_splat_percell(g, grid, SHAPE, cfg, (0, 1, 1),
                                           plan)
        for tile in (SPLAT_TILE, (SHAPE[0], SHAPE[1], 1), (1, 1, C)):
            got = percell.plain_splat_percell_tiles(g, grid, SHAPE, cfg,
                                                    (0, 1, 1), plan, tile)
            _close_rows(got, want, 1e-12)


def _raw_floors(grid, cfg):
    """(z floors, y floors) (N, Q) of each pair's source coordinates, not
    clamped: its corners' rows are the floor and the next."""
    shifts = multicell_offsets(N_CELL, cfg.multicell, grid.dtype)[:, None]
    out = []
    for axis, size in ((2, SHAPE[0]), (1, SHAPE[1])):
        x, _ = compute_source_coords(
            grid[..., 0, axis], size, cfg.padding_mode, cfg.align_corners,
            cfg.multicell, shifts, strict=cfg.strict_reference)
        out.append(torch.floor(x).to(torch.int64).expand(N_CELL, Q))
    return out


def test_splat_tiles_cover_each_corner_once(small_tiles):
    """The splat's tiles partition each cell (every element in one tile),
    and each in-bounds corner of every pair lies in the rows of exactly
    one tile whose walk holds the pair's slot: counted through the plan's
    slot ranges (_walk), at row keys and coarse keys."""
    cfg = TConfig(dim=3)
    grid = _edge_grid(5, cfg, False, np.float32)
    d, h, _ = SHAPE
    dz, ty, _ = SPLAT_TILE
    z0, y0, rows, yrows = percell._tile_rows(d, h, dz, ty)
    cover = torch.zeros((d, h), dtype=torch.int64)
    for t in range(z0.numel()):
        cover[z0[t]:z0[t] + rows[t], y0[t]:y0[t] + yrows[t]] += 1
    assert torch.equal(cover, torch.ones_like(cover))
    fz, fy = _raw_floors(grid, cfg)
    tiles = z0.numel()
    for keys in ((1, 1), (2, 3)):
        plan = percell.make_plan(grid, (N_CELL, C, *SHAPE), cfg, keys)
        walker, slot = percell._walk(plan, SHAPE, dz, ty, 1)
        pair = plan.perm.to(torch.int64)[slot]
        assert torch.equal(pair // Q, walker // tiles)
        zs, ys = fz.reshape(-1)[pair], fy.reshape(-1)[pair]
        t = walker % tiles
        for up_z in (0, 1):
            for up_y in (0, 1):
                z, y = zs + up_z, ys + up_y
                inside = (z >= z0[t]) & (z < z0[t] + rows[t]) & \
                    (y >= y0[t]) & (y < y0[t] + yrows[t])
                hits = torch.zeros(N_CELL * Q, dtype=torch.int64)
                hits.index_add_(0, pair, inside.to(torch.int64))
                zc, yc = fz.reshape(-1) + up_z, fy.reshape(-1) + up_y
                ok = (zc >= 0) & (zc < d) & (yc >= 0) & (yc < h)
                assert torch.equal(hits, ok.to(torch.int64)), (keys, up_z,
                                                               up_y)


def test_blend_walk_owns_each_slot_once(small_tiles):
    """The blend's walk (each tile the ranges of the keys of its own
    floors) holds every slot, and with coarse keys the owner filter (the
    slot's floor in the tile's rows) passes it in exactly one tile; the
    plain blend over those windows is generic.blend (f64, 1e-12)."""
    cfg = TConfig(dim=3, padding_mode="reflection")
    grid = _edge_grid(6, cfg, True, np.float64)
    cells, _, _ = _data(7, dtype=np.float64)
    cells = torch.from_numpy(cells)
    d, h, _ = SHAPE
    dz, ty = percell.geometry(C, SHAPE)
    z0, y0, rows, yrows = percell._tile_rows(d, h, dz, ty)
    tiles = z0.numel()
    fz, fy = percell._floors(grid, (N_CELL, C, *SHAPE), cfg)
    want = tgeneric.blend(cells, grid, cfg, (1, 0, 1))
    for keys in ((1, 1), (2, 3), (3, SHAPE[1])):
        plan = percell.make_plan(grid, (N_CELL, C, *SHAPE), cfg, keys)
        walker, slot = percell._walk(plan, SHAPE, dz, ty, 0)
        pair = plan.perm.to(torch.int64)[slot]
        t = walker % tiles
        zs, ys = fz.reshape(-1)[pair], fy.reshape(-1)[pair]
        owned = (zs >= z0[t]) & (zs < z0[t] + rows[t]) & \
            (ys >= y0[t]) & (ys < y0[t] + yrows[t])
        count = torch.zeros(N_CELL * Q, dtype=torch.int64)
        count.index_add_(0, pair, owned.to(torch.int64))
        assert torch.equal(count, torch.ones_like(count)), keys
        if keys == (1, 1):
            assert bool(owned.all())
        _close_rows(percell.plain_blend_percell(cells, grid, cfg, (1, 0, 1),
                                                plan), want, 1e-12)


def test_tiles_keys_and_the_rule():
    """key_grid: a key a row while a cell's D * H fit the histogram
    (128^2, 192^2, 32 x 256), else the fewest rows a key (256^2: 2 y
    rows; past BIN_MAX_KEYS z rows, all y rows).  splat_geometry, as
    chip_smoke.py's sweep chose it: one z row of 18 y rows in 256-thread
    blocks, four an SM, where 4 channels of them fit SPLAT_BYTES (128^3,
    192^3, both within SPLAT_BYTES); else the tile that walks the fewest
    pairs a pair owned in SPLAT_FALLBACK_BYTES (32 x 256^2: 3 x 3, each
    tile of that budget walking as many or more); a row too wide for
    that budget takes a block of its own; a cell whose one row of one
    channel fits no block is not taken, and route.rule sends it to
    blend_o."""
    assert percell.key_grid(128, 128) == (1, 1)
    assert percell.key_grid(192, 192) == (1, 1)
    assert percell.key_grid(32, 256) == (1, 1)
    assert percell.key_grid(256, 256) == (1, 2)
    assert percell.key_grid(percell.BIN_MAX_KEYS, 7) == (1, 7)
    kz, ky = percell.key_grid(percell.BIN_MAX_KEYS + 1, 7)
    assert (kz, ky) == (2, 7)
    for d, h in ((128, 128), (256, 256), (60_000, 3), (9, 100_000)):
        kz, ky = percell.key_grid(d, h)
        assert percell._keys_of(d, h, kz, ky) <= percell.BIN_MAX_KEYS
    assert 4 * (percell.SPLAT_BYTES + 1024) <= 228 * 1024
    for spatial, tile in (((128, 128, 128), (1, 18, 4, 256)),
                          ((192, 192, 192), (1, 18, 4, 256)),
                          ((32, 256, 256), (3, 3, 4, 256))):
        got = percell.splat_geometry(4, spatial)
        assert got == tile
        w = spatial[2]
        assert got.smem_bytes(w) <= (percell.SPLAT_BYTES if got.dz == 1
                                     else percell.SPLAT_FALLBACK_BYTES)
    w = 256
    walked = (3 + 1) * (3 + 1) / 9
    for dz in range(1, 32):
        ty = (percell.SPLAT_FALLBACK_BYTES - percell.WALK_BYTES) // (
            16 * dz * w)
        if ty >= 1:
            assert walked <= (dz + 1) * (ty + 1) / (dz * ty)
    assert percell.splat_geometry(4, (8, 4, 50_000)) == (1, 1, 1, 1024)
    cfg = TConfig(dim=3)
    wide = (2, 4, 8, 4, 60_000)
    assert percell.splat_geometry(4, wide[2:]) is None
    assert not percell.supports(cfg, wide)
    assert route.rule(cfg, wide, 1 << 20) == "blend_o"
    assert route.rule(cfg, (8, 4, 8, 4, 50_000), 1 << 20) == "percell"


class _Lib:
    """Stands in for the loaded library: each entry point a namespace that
    build._declare sets argtypes on."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_ctypes_declarations_match_the_c_entry_points():
    """build._declare gives percell_blend, percell_splat, percell_plan and
    percell_scan_scratch the pointer, int and float arguments of their C
    signatures, in order, and the wrappers pass the plan's keys and the
    tile (math, not a launch: the argument lists' lengths)."""
    lib = _Lib()
    build._declare(lib)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    text = (build.CSRC / "percell.cu").read_text()
    for entry in ("percell_blend", "percell_splat", "percell_plan",
                  "percell_scan_scratch"):
        sig = re.search(rf"\nint {entry}\(([^)]*)\)", text).group(1)
        want = ["p" if "void*" in a else "f" if "float" in a else "i"
                for a in sig.split(",")]
        assert [kinds[t] for t in getattr(lib, entry).argtypes] == want, \
            entry
    # launch_pairs passes 5 pointers, 11 shape ints, the extra ints, 5
    # flags, two floats and the stream
    assert len(lib.percell_blend.argtypes) == 5 + 11 + 6 + 5 + 3
    assert len(lib.percell_splat.argtypes) == 5 + 11 + 6 + 5 + 3
