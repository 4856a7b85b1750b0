"""PyTorch port, the tiles of the percell route: the (cell, z tile, y band)
plan of the pairs that the percell kernels walk, held to the JAX package's
coordinate transform with numpy binning; the plain percell versions over
that order, each blend slot read from its tile's window, against the JAX
package's blend and splat; and the launch geometries the percell and
splat_o wrappers compute on the host.

On the CPU ``make_plan`` takes its plain version, a stable sort; the
kernel's counting sort is compared with it on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops import coords as jcoords
from cosinesampler_tpu.ops import generic as jgeneric
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import blend_splat, percell
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_CELL, C, Q = 3, 2, 400
SHAPE = (12, 20, 16)
# tiles of 2 z rows by 4 y rows: a window of 3 x 5 rows of 2 channels
TILE = (2, 4)
SMALL_BUDGET = 16 + 4 * C * 3 * 5 * SHAPE[2]


def _grid(seed, per_cell, lo=-1.3, hi=1.3, y_band=None, z_band=None):
    """(N or 1, Q, 1, 3) f32 points in [lo, hi]; ``y_band`` / ``z_band``
    put every y / z coordinate in that range instead."""
    rng = np.random.RandomState(seed)
    grid = rng.uniform(lo, hi, (N_CELL if per_cell else 1, Q, 1, 3))
    for axis, band in ((1, y_band), (2, z_band)):
        if band is not None:
            grid[..., axis] = rng.uniform(*band, grid.shape[:-1])
    return grid.astype(np.float32)


def _edge_grid(seed, cfg):
    """Shared points whose y and z source coordinates (multicell shift of
    cell 0 included) fall on band and tile edges and a hair either side of
    them, x anywhere."""
    rng = np.random.RandomState(seed)
    size_y, size_z = SHAPE[1], SHAPE[0]
    ys = np.repeat(np.arange(0, size_y + 1, TILE[1]), 3)
    zs = np.repeat(np.arange(0, size_z + 1, TILE[0]), 3)
    eps = np.tile([-1e-3, 0.0, 1e-3], max(len(ys), len(zs)))
    ys = ys + eps[:len(ys)]
    zs = zs + eps[:len(zs)]
    # the inverse of align_corners' unnormalisation (multicell: size - 1)
    to_grid = lambda x, size: x / (0.5 * (size - 2)) - 1.0
    grid = rng.uniform(-1, 1, (1, Q, 1, 3))
    grid[0, :, 0, 1] = to_grid(ys[np.arange(Q) % len(ys)], size_y)
    grid[0, :, 0, 2] = to_grid(zs[np.arange(Q) % len(zs)], size_z)
    assert cfg.align_corners and cfg.multicell
    return grid.astype(np.float32)


def _floors(grid, axis, size, jcfg):
    """Each pair's floor of grid axis ``axis`` (N, Q) on the JAX package's
    compute_source_coords with the cell's own shift, clamped to the
    cell's rows."""
    offsets = jcoords.multicell_offsets(N_CELL, jcfg.multicell, jnp.float32)
    base, _ = jcoords.compute_source_coords(
        jnp.asarray(grid[:, :, 0, axis]), size, jcfg.padding_mode,
        jcfg.align_corners, jcfg.multicell, offsets[:, None],
        strict=jcfg.strict_reference)
    fz = np.nan_to_num(np.floor(np.asarray(base)), nan=0.0)
    return np.clip(np.broadcast_to(fz, (N_CELL, grid.shape[1])), 0,
                   size - 1).astype(np.int64)


PLAN_CASES = [
    # (config flags, grid)
    (dict(), "edges"),
    # every pair in one y band and one z tile: all other bins empty
    (dict(multicell=False), "skewed"),
    (dict(padding_mode="reflection"), "per-cell"),
    (dict(padding_mode="border", align_corners=False), "shared"),
]


@pytest.mark.parametrize("kw,kind", PLAN_CASES)
def test_plain_plan_matches_numpy(kw, kind):
    """Every slot's pair lies in the bin of its (cell, z tile, y band) on
    the JAX package's transform with numpy binning, the pairs of a bin in
    query order (a stable sort); the starts are monotone from 0 to N*Q;
    every pair has one slot, each cell's pairs in that cell's slots.  On
    band edges a pair goes by its floor; a skewed cloud fills one bin a
    cell; reflection and border fold the coordinate first."""
    tcfg, jcfg = TConfig(dim=3, **kw), JConfig(dim=3, **kw)
    grid = {"edges": lambda: _edge_grid(1, tcfg),
            "skewed": lambda: _grid(2, False, y_band=(-0.55, -0.45),
                                    z_band=(0.31, 0.39)),
            "per-cell": lambda: _grid(3, True, -2.5, 2.5),
            "shared": lambda: _grid(4, False, -1.2, 1.2)}[kind]()
    cells_shape = (N_CELL, C, *SHAPE)
    plan = percell.plain_plan(torch.from_numpy(grid), cells_shape, tcfg, TILE)
    perm = plan.perm.numpy().astype(np.int64)
    starts = plan.starts.numpy().astype(np.int64)
    d, h = SHAPE[:2]
    bands = -(-h // TILE[1])
    tiles = -(-d // TILE[0]) * bands
    pairs = N_CELL * Q
    assert plan.perm.dtype == plan.starts.dtype == torch.int32
    assert (plan.n, plan.q, plan.dz, plan.ty) == (N_CELL, Q, *TILE)
    assert starts.shape == (N_CELL * tiles + 1,)
    assert starts[0] == 0 and starts[-1] == pairs
    assert np.all(np.diff(starts) >= 0)
    np.testing.assert_array_equal(np.sort(perm), np.arange(pairs))
    tile = (_floors(grid, 2, d, jcfg) // TILE[0] * bands
            + _floors(grid, 1, h, jcfg) // TILE[1])
    key = (np.arange(N_CELL)[:, None] * tiles + tile).reshape(-1)
    slot_key = np.repeat(np.arange(N_CELL * tiles), np.diff(starts))
    np.testing.assert_array_equal(key[perm], slot_key)
    assert np.all(np.diff(perm)[np.diff(slot_key) == 0] > 0)
    np.testing.assert_array_equal(perm // Q, np.repeat(np.arange(N_CELL), Q))
    if kind == "skewed":
        assert np.count_nonzero(np.diff(starts)) == N_CELL
    if kind == "edges":
        # the edge points land in every band and every z tile
        assert len(np.unique(tile % bands)) == bands
        assert len(np.unique(tile // bands)) == -(-d // TILE[0])
    # make_plan on the CPU is the plain plan
    again = percell.make_plan(torch.from_numpy(grid), cells_shape, tcfg, TILE)
    assert torch.equal(again.perm, plan.perm)
    assert torch.equal(again.starts, plan.starts)


@pytest.mark.parametrize("kw,orders,per_cell", [
    (dict(padding_mode="reflection"), (1, 0, 2), True),
    (dict(padding_mode="border", kernel="smoothstep"), (0, 2, 1), False),
])
def test_plain_percell_over_tiles_matches_jax(monkeypatch, kw, orders,
                                              per_cell):
    """The wrappers on the CPU (the plain versions over the plan), with a
    shared-memory budget of one 2 x 4 tile of both channels so that every
    blend slot reads its corners from its tile's window, against the JAX
    package's blend and splat on the same f32 inputs, points to +-1.6, at
    the percell tolerance of tests/test_torch_port_percell.py (rtol 3e-4,
    an absolute floor of 1e-5 of the largest magnitude)."""
    monkeypatch.setattr(percell, "TILE_BYTES", SMALL_BUDGET)
    assert percell.geometry(C, SHAPE) == TILE
    assert percell.channels(C, SHAPE, *TILE) == C
    rng = np.random.RandomState(5)
    cells = rng.rand(N_CELL, C, *SHAPE).astype(np.float32)
    grid = _grid(6, per_cell, -1.6, 1.6)
    g = rng.randn(N_CELL, C, Q, 1).astype(np.float32)
    tcfg, jcfg = TConfig(dim=3, **kw), JConfig(dim=3, backend="xla", **kw)
    tgrid = torch.from_numpy(grid)
    plan = percell.make_plan(tgrid, cells.shape, tcfg)
    assert (plan.dz, plan.ty) == TILE

    def close(got, want):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-4,
                                   atol=1e-5 * scale)

    close(percell.blend(torch.from_numpy(cells), tgrid, tcfg, orders, plan),
          jgeneric.blend(jnp.asarray(cells), jnp.asarray(grid), jcfg,
                         orders))
    close(percell.splat(torch.from_numpy(g), tgrid, SHAPE, tcfg, orders,
                        plan),
          jgeneric.splat(jnp.asarray(g), jnp.asarray(grid), SHAPE, jcfg,
                         orders))


def test_percell_tiles():
    """geometry: the nested 128^3 volume and the 32 x 256^2 cells at 4
    channels take all of them in tiles whose window of both z rows fits
    TILE_BYTES with the fewest halo rows per owned row; 16 channels take
    smaller tiles; rows too wide for two rows of one channel of two
    planes are not staged (channels 0) and take whole planes; a tile of
    the wrong shape for the cells is refused."""
    for c, spatial, tile in ((4, (128, 128, 128), (6, 7)),
                             (4, (32, 256, 256), (3, 6)),
                             (16, (128, 128, 128), (2, 3))):
        dz, ty = percell.geometry(c, spatial)
        assert (dz, ty) == tile
        assert percell.channels(c, spatial, dz, ty) == c
        d, h, w = spatial
        window = 16 + 4 * c * min(dz + 1, d) * min(ty + 1, h) * w
        assert window <= percell.TILE_BYTES < window + 4 * c * (dz + 1) * w
    assert percell.geometry(1, (4, 4, 8192)) == (1, 4)
    assert percell.channels(1, (4, 4, 8192), 1, 4) == 0
    assert percell.TILE_BYTES * 2 + 2 * 1024 <= 228 * 1024
    grid = torch.zeros((1, 5, 1, 3))
    plan = percell.make_plan(grid, (2, 1, *SHAPE), TConfig(dim=3), TILE)
    with pytest.raises(ValueError, match="pair plan"):
        percell.blend(torch.zeros((2, 1, 12, 20, 17)), grid, TConfig(dim=3),
                      (0, 0, 0), percell.PairPlan(
                          plan.perm, plan.starts[:-1], 2, 5, *TILE))


def test_splat_geometry():
    """splat_o's launch geometry on the H100's 132 SMs: the 2D main path
    (96 x 4 x 16^2, Q = 100 000) takes 8 cells a block, a warp's lanes over
    them, strides 4 floats past a multiple of 32, and 3 waves of 6 blocks
    an SM; the 3D main path's 64 KB cells (50 x 4 x 16^3) one cell a
    block, lanes on queries, 3 blocks an SM; a cell over a block's 227 KB
    global atomics, ~4 blocks an SM of at least 256 queries; and a small
    stack with a few queries fewer lanes and blocks of at least 256
    queries."""
    sg = blend_splat.SplatGeometry
    assert blend_splat.splat_geometry(96, 4, (16, 16), 100_000) == sg(
        8, 8, 1028, 506, 198)
    assert blend_splat.splat_geometry(50, 4, (16, 16, 16), 100_000) == sg(
        1, 1, 16384, 4348, 23)
    assert blend_splat.splat_geometry(2, 4, (32, 32, 32), 4096) == sg(
        0, 1, 131072, 256, 16)
    assert blend_splat.splat_geometry(6, 3, (7, 8, 9), 4099) == sg(
        4, 4, 1540, 242, 17)
    for args in (((96, 4, (16, 16), 100_000)), (50, 4, (16, 16, 16), 100_000),
                 (2, 4, (32, 32, 32), 4096), (6, 3, (7, 8, 9), 4099)):
        g = blend_splat.splat_geometry(*args)
        q = args[3]
        assert g.q_blocks * g.q_per_block >= q > (g.q_blocks - 1) * g.q_per_block
        assert g.cells * g.stride * 4 <= 227 * 1024
        assert g.cells == 0 or g.stride % 32 in ((0, 4) if g.lanes > 1
                                                 else tuple(range(32)))
