"""PyTorch port, the bins of the slab route: the (cell, floor row) order of
the pairs that the slab kernels walk, held to the JAX package's coordinate
transform, the plain slab versions walking them against the JAX
package's slab kernels in interpret mode, and their reuse along an
autograd chain (route.GridPlans).

On the CPU ``make_bins`` takes its plain version, a stable sort; the
kernel's counting sort is compared with it on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops import coords as jcoords
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas import slab as jslab
from cosinesampler_tpu_torch.ops import generic as tgeneric
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import route, slab
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_CELL, C, Q = 3, 2, 150


def _spatial(dim):
    return (20, 9) if dim == 2 else (20, 6, 7)


def _grid(dim, seed, per_cell, lo=-1.4, hi=1.4, z_band=None, q=Q):
    """(N or 1, 1[, 1], q, dim) f32 points in [lo, hi]; ``z_band`` puts
    every leading-axis coordinate in that range instead."""
    rng = np.random.RandomState(seed)
    lead = (1,) * (dim - 1)
    grid = rng.uniform(lo, hi, (N_CELL if per_cell else 1, *lead, q, dim))
    if z_band is not None:
        grid[..., dim - 1] = rng.uniform(*z_band, grid.shape[:-1])
    return grid.astype(np.float32)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _rows_numpy(grid, dim, depth, jcfg, align):
    """Each pair's floor row of the leading axis, (N, Q), on the JAX
    package's compute_source_coords with the cell's own shift, clamped to
    the cell's rows."""
    offsets = jcoords.multicell_offsets(N_CELL, jcfg.multicell, jnp.float32)
    coord = jnp.asarray(grid.reshape(grid.shape[0], -1, dim)[..., dim - 1])
    base, _ = jcoords.compute_source_coords(
        coord, depth, jcfg.padding_mode, align, jcfg.multicell,
        offsets[:, None], strict=jcfg.strict_reference)
    fz = np.nan_to_num(np.floor(np.asarray(base)), nan=0.0)
    return np.clip(np.broadcast_to(fz, (N_CELL, coord.shape[1])), 0,
                   depth - 1).astype(np.int64)


BIN_CASES = [
    # (dim, config flags, align, per-cell grid, z band)
    (2, dict(), True, True, None),
    (2, dict(padding_mode="reflection", multicell=False), False, False,
     None),
    # strict 2D with align off: the order-0 blend bins with align on
    (2, dict(padding_mode="reflection", strict_reference=True,
             align_corners=False), True, True, None),
    (3, dict(padding_mode="border", align_corners=False), False, True, None),
    (3, dict(padding_mode="reflection"), True, False, None),
    (3, dict(multicell=False), True, True, (-0.2, 0.2)),
    # every pair in one row: all other bins empty
    (3, dict(multicell=False), True, False, (0.01, 0.02)),
]


@pytest.mark.parametrize("dim,kw,align,per_cell,band", BIN_CASES)
def test_plain_bins_match_numpy(dim, kw, align, per_cell, band):
    """Every slot's pair lies in the bin of its floor row (the JAX
    package's transform, numpy binning), the pairs of a bin in query order
    (a stable sort); the starts are monotone, begin at 0 and end at N*Q;
    every pair has one slot, each cell's pairs in that cell's slots."""
    depth = _spatial(dim)[0]
    grid = _grid(dim, 7, per_cell, z_band=band)
    cells_shape = (N_CELL, C, *_spatial(dim))
    bins = slab.plain_bins(torch.from_numpy(grid), cells_shape,
                           TConfig(dim=dim, **kw), align)
    perm = bins.perm.numpy().astype(np.int64)
    starts = bins.starts.numpy().astype(np.int64)
    pairs = N_CELL * Q
    assert bins.perm.dtype == bins.starts.dtype == torch.int32
    assert (bins.n, bins.q, bins.depth) == (N_CELL, Q, depth)
    assert starts.shape == (N_CELL * depth + 1,)
    assert starts[0] == 0 and starts[-1] == pairs
    assert np.all(np.diff(starts) >= 0)
    np.testing.assert_array_equal(np.sort(perm), np.arange(pairs))
    rows = _rows_numpy(grid, dim, depth, JConfig(dim=dim, **kw), align)
    key = (np.arange(N_CELL)[:, None] * depth + rows).reshape(-1)
    slot_key = np.repeat(np.arange(N_CELL * depth), np.diff(starts))
    np.testing.assert_array_equal(key[perm], slot_key)
    same = np.diff(slot_key) == 0
    assert np.all(np.diff(perm)[same] > 0)
    np.testing.assert_array_equal(perm // Q, np.repeat(np.arange(N_CELL), Q))
    if band == (0.01, 0.02):
        assert np.count_nonzero(np.diff(starts)) == N_CELL


# --- the plain versions walking the bins vs the Pallas slab kernels ----------

# the JAX package's small budget (tests/test_slab.py); on the port's side
# a budget of two rows of one channel: 1-row slabs everywhere
SMALL_BUDGET = 96 * 1024


@pytest.mark.parametrize("dim,kw,orders", [
    (2, dict(padding_mode="reflection"), (1, 0)),
    (3, dict(padding_mode="border", align_corners=False), (0, 0, 2)),
])
def test_plain_slab_walking_bins_matches_pallas_interpret(monkeypatch, dim,
                                                          kw, orders):
    """The wrappers on the CPU (the plain versions over plain_bins) with a
    shared-memory budget of one row a slab, a cloud whose leading-axis
    points fill a third of the rows (most bins empty), against the JAX
    package's slab kernels (interpret mode, its small budget) at the v1
    family's tolerance (rtol 3e-4, atol 5e-5 of the largest magnitude,
    tests/test_slab.py)."""
    spatial = _spatial(dim)
    row_bytes = 4 * int(np.prod(spatial[1:]))
    monkeypatch.setattr(slab, "SMEM_BYTES", 2 * row_bytes)
    assert slab.geometry(C, spatial, 1) == (1, 1)
    assert slab.geometry(C, spatial, 0) == (1, 2)
    rng = np.random.RandomState(3)
    cells = rng.rand(N_CELL, C, *spatial).astype(np.float32)
    grid = _grid(dim, 4, True, z_band=(-0.3, 0.3))
    gout = rng.standard_normal((N_CELL, C, *grid.shape[1:-1])).astype(
        np.float32)
    tcfg, jcfg = TConfig(dim=dim, **kw), JConfig(dim=dim, **kw)
    bins = slab.plain_bins(torch.from_numpy(grid), cells.shape, tcfg,
                           tcfg.align_corners)
    assert np.count_nonzero(np.diff(bins.starts.numpy()) == 0) > (
        N_CELL * spatial[0] // 2)
    want = jslab.pallas_blend_slab(jnp.asarray(cells), jnp.asarray(grid),
                                   jcfg, orders, budget=SMALL_BUDGET,
                                   interpret=True)
    got = slab.blend(torch.from_numpy(cells), torch.from_numpy(grid), tcfg,
                     orders, bins)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=5e-5 * scale)
    want_s = jslab.pallas_splat_slab(jnp.asarray(gout), jnp.asarray(grid),
                                     spatial, jcfg, orders,
                                     budget=SMALL_BUDGET, interpret=True)
    got_s = slab.splat(torch.from_numpy(gout), torch.from_numpy(grid),
                       spatial, tcfg, orders, bins)
    scale = float(np.abs(np.asarray(want_s)).max())
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=3e-4,
                               atol=5e-5 * scale)


@pytest.mark.parametrize("dz,cc", [(1, 1), (3, 2), (6, 1)])
def test_plain_versions_take_the_given_bins(dz, cc):
    """The plain versions walk the bins they are given: bins in any order
    within a (cell, row) give the same blend bit for bit and the same
    splat (f64, rtol 1e-12), and generic's numbers (rtol 1e-10)."""
    dim, spatial = 3, _spatial(3)
    cfg = TConfig(dim=3, padding_mode="reflection")
    rng = np.random.RandomState(5)
    cells = torch.from_numpy(rng.rand(N_CELL, C, *spatial))
    grid = torch.from_numpy(_grid(dim, 6, True).astype(np.float64))
    gout = torch.from_numpy(rng.standard_normal((N_CELL, C, 1, 1, Q)))
    bins = slab.plain_bins(grid, cells.shape, cfg, True)
    # the same bins with each (cell, row) reversed, as the kernel's
    # atomics may order them
    starts = bins.starts.tolist()
    perm = torch.cat([bins.perm[a:b].flip(0)
                      for a, b in zip(starts[:-1], starts[1:])])
    flipped = slab.SlabBins(perm, bins.starts, N_CELL, Q, spatial[0])
    orders = (0, 1, 0)
    a = slab.plain_blend_slab(cells, grid, cfg, orders, dz, cc, bins)
    b = slab.plain_blend_slab(cells, grid, cfg, orders, dz, cc, flipped)
    assert torch.equal(a, b)
    np.testing.assert_allclose(
        a.numpy(), tgeneric.blend(cells, grid, cfg, orders).numpy(),
        rtol=1e-10, atol=1e-10)
    s = slab.plain_splat_slab(gout, grid, spatial, cfg, orders, dz, cc,
                              flipped)
    np.testing.assert_allclose(
        s.numpy(), slab.plain_splat_slab(gout, grid, spatial, cfg, orders,
                                         dz, cc, bins).numpy(), rtol=1e-12)
    np.testing.assert_allclose(
        s.numpy(), tgeneric.splat(gout, grid, spatial, cfg, orders).numpy(),
        rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="slab bins"):
        slab.plain_blend_slab(cells[:2], grid[:2], cfg, orders, dz, cc, bins)


# --- the bins along an autograd chain -------------------------------------------

def test_grid_plans_build_one_set_of_bins_a_grid(monkeypatch):
    """route.blend / route.splat on the slab route with one GridPlans: one
    set of bins for a blend and a splat of other slab heights on one
    grid, a new one for another grid or the grid changed in place, and
    for a strict 2D order-0 blend (align on) beside the chain's other
    calls (align off), each kept; none where the leading axis is one
    slab."""
    monkeypatch.setattr(route, "pick", lambda *args: "slab")
    spatial = _spatial(3)
    monkeypatch.setattr(slab, "SMEM_BYTES", 4 * 4 * 6 * 7)
    assert slab.geometry(C, spatial, 1) == (1, 2)
    assert slab.geometry(C, spatial, 0) == (2, 2)
    built = []
    make_bins = slab.make_bins
    monkeypatch.setattr(slab, "make_bins",
                        lambda *a: built.append(a[3]) or make_bins(*a))
    rng = np.random.RandomState(9)
    cells = torch.from_numpy(rng.rand(N_CELL, C, *spatial).astype(np.float32))
    grid = torch.from_numpy(_grid(3, 10, False))
    gout = torch.from_numpy(rng.standard_normal(
        (N_CELL, C, 1, 1, Q)).astype(np.float32))
    cfg = TConfig(dim=3)
    plans = route.GridPlans()
    out = route.blend(cells, grid, cfg, (1, 0, 0), plans)
    dx = route.splat(gout, grid, spatial, cfg, (0, 0, 2), plans)
    assert plans.builds == 1 and len(built) == 1
    _close(out.numpy(), tgeneric.blend(cells, grid, cfg, (1, 0, 0)), 1e-5)
    _close(dx.numpy(), tgeneric.splat(gout, grid, spatial, cfg, (0, 0, 2)),
           1e-5)
    other = torch.from_numpy(_grid(3, 11, False))
    route.blend(cells, other, cfg, (0, 0, 0), plans)
    grid[0, 0, 0, :5, 2] = -grid[0, 0, 0, :5, 2]      # in place
    route.splat(gout, grid, spatial, cfg, (0, 0, 0), plans)
    assert plans.builds == 3
    cells2 = torch.from_numpy(rng.rand(N_CELL, C, 20, 9).astype(np.float32))
    grid2 = torch.from_numpy(_grid(2, 12, True))
    gout2 = torch.from_numpy(rng.standard_normal((N_CELL, C, 1, Q)).astype(
        np.float32))
    cfg2 = TConfig(dim=2, strict_reference=True, align_corners=False)
    monkeypatch.setattr(slab, "SMEM_BYTES", 2 * 4 * 9)
    plans2 = route.GridPlans()
    route.blend(cells2, grid2, cfg2, (0, 0), plans2)
    route.splat(gout2, grid2, (20, 9), cfg2, (0, 0), plans2)
    route.blend(cells2, grid2, cfg2, (1, 0), plans2)
    route.blend(cells2, grid2, cfg2, (0, 0), plans2)
    assert plans2.builds == 2 and built[-2:] == [True, False]
    # one slab: no bins
    monkeypatch.setattr(slab, "SMEM_BYTES", 227 * 1024)
    assert not slab.needs_bins(cells.shape, True)
    plans3 = route.GridPlans()
    route.blend(cells, grid, cfg, (0, 0, 0), plans3)
    route.splat(gout, grid, spatial, cfg, (0, 0, 0), plans3)
    assert plans3.builds == 0
