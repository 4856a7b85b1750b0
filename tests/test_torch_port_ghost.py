"""PyTorch port, fused3b's ghost path: the super-brick numbering
(ghost_plan), the plain private bricks and their fold (the oracle of the
ghost CUDA kernel and its fold), and fused3b_bwd_vol's ghost route, held
to the JAX package's ``pallas_fused3b_bwd(..., ghost=True)`` in interpret
mode and to the port's own serialized plain version.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas import fused3b as jfused3b
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused3b

# tests/test_fused3b.py's ghost case: 3 cells x 2 channels over (10, 12, 9)
N_CELL, C, Q, SPATIAL = 3, 2, 160, (10, 12, 9)


def _case(seed, padding, lo=-1.2, hi=1.2):
    """Points, a query-ordered cotangent, the port's plan and the slot
    cotangent, from ``seed`` with NumPy."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(lo, hi, (Q, 3)).astype(np.float32)
    g = rng.randn(7, C, Q).astype(np.float32)
    cfg = TConfig(dim=3, padding_mode=padding)
    plan = fused3b.make_plan(torch.from_numpy(pts), SPATIAL, cfg)
    g_p = torch.zeros((7, C, plan[1].shape[0]), dtype=torch.float32)
    g_p[:, :, plan[0]] = torch.from_numpy(g)
    return pts, g, cfg, plan, g_p


def _close(got, want, rtol):
    """rtol per element with an absolute floor of rtol times the largest
    magnitude, for entries that cancel to ~0."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_plain_ghost_matches_jax_ghost_interpret(padding):
    """plain_fused3b_bwd_ghost_vol against the JAX ghost kernel and its fold
    in interpret mode, at the route's rb and at rb = 1 (where a reflection
    row is reached by three y-bricks): rtol 1e-5, as tests/test_fused3b.py
    holds the JAX ghost path to its serialized kernel, with the absolute
    floor at 1e-5 of the largest magnitude (~400 here: two packages' f32
    partial sums differ by ~1e-4 where the JAX pair shares its
    arithmetic).  In f64 the ghost and serialized plain versions agree at
    rtol 1e-10: only the accumulation differs."""
    pts, g, cfg, plan, g_p = _case(11, padding)
    jcfg = JConfig(dim=3, padding_mode=padding, backend="pallas")
    want = np.asarray(jfused3b.pallas_fused3b_bwd(
        jnp.asarray(g), jnp.asarray(pts), SPATIAL, jcfg, N_CELL,
        interpret=True, ghost=True))
    g64 = g_p.double()
    serial = fused3b.plain_fused3b_bwd_vol(g64, plan, SPATIAL, cfg, N_CELL)
    for rb in (fused3b.GHOST_RB, 1):
        got = fused3b.plain_fused3b_bwd_ghost_vol(g_p, plan, SPATIAL, cfg,
                                                  N_CELL, rb)
        assert got.shape == fused3b.vol_layout(N_CELL, C, SPATIAL)
        assert got.dtype == torch.float32
        _close(fused3b.vol_to_cells(got).numpy(), want, 1e-5)
        got64 = fused3b.plain_fused3b_bwd_ghost_vol(g64, plan, SPATIAL, cfg,
                                                    N_CELL, rb)
        _close(got64.numpy(), serial.numpy(), 1e-10)


def _jax_ghost_plan(plan, rb, gy=2):
    """sbi and visited as JAX's _bwd3b_from_slots computes them
    (fused3b.py:1044-1057), over a JAX brick plan."""
    _, _, z0, y0, hasv, _ = plan
    d, h, _ = SPATIAL
    nby = -(-(h + 2) // gy)
    nbz = d + 2
    bi = jnp.arange(hasv.shape[0], dtype=jnp.int32)
    sbi = (y0 // gy // rb) * nbz + z0
    last_real = sbi[jnp.maximum(jnp.max(bi * hasv), 0)]
    sbi = jnp.where(hasv > 0, sbi, last_real).astype(jnp.int32)
    visited = jnp.zeros((nbz * -(-nby // rb),), jnp.int32).at[sbi].max(
        1, mode="drop")
    return np.asarray(sbi), np.asarray(visited)


@pytest.mark.parametrize("rb", [1, 2, 8])
def test_ghost_plan_matches_jax(rb):
    """ghost_plan's block super-bricks and visited mask equal JAX's on the
    same points, the plan's query-free tail blocks remapped to the last
    real block's super-brick; each super-brick's blocks are the
    consecutive run [first, last]."""
    pts = np.random.RandomState(3).uniform(-1.7, 1.7, (Q, 3)).astype(
        np.float32)
    jplan = jfused3b.make_plan(jnp.asarray(pts), SPATIAL,
                               JConfig(dim=3, backend="pallas"))
    plan = fused3b.make_plan(torch.from_numpy(pts), SPATIAL, TConfig(dim=3))
    sbi, first, last, visited = fused3b.ghost_plan(plan, SPATIAL, rb)
    want_sbi, want_visited = _jax_ghost_plan(jplan, rb)
    hasv = plan[4].numpy()
    assert (hasv == 0).any() and hasv[-1] == 0    # the tail exists
    np.testing.assert_array_equal(sbi.numpy(), want_sbi)
    np.testing.assert_array_equal(visited.numpy(), want_visited)
    assert sbi.dtype == first.dtype == last.dtype == visited.dtype \
        == torch.int32
    for s in np.flatnonzero(visited.numpy()):
        blocks = np.flatnonzero(sbi.numpy() == s)
        assert (int(first[s]), int(last[s])) == (blocks[0], blocks[-1])
        assert len(blocks) == blocks[-1] - blocks[0] + 1
    assert (last.numpy()[visited.numpy() == 0] == -1).all()


def test_fold_selects_unvisited_bricks_out():
    """Unvisited bricks are NaN in the plain version (the kernel leaves
    them uninitialized) and the fold selects them out: the result is
    finite and equals the fold of the same bricks zeroed there."""
    _, _, cfg, plan, g_p = _case(5, "zeros", lo=-0.6, hi=0.6)
    gplan = fused3b.ghost_plan(plan, SPATIAL)
    visited = gplan[3]
    bricks = fused3b.plain_ghost_bricks(g_p, plan, gplan, SPATIAL, cfg,
                                        N_CELL)
    assert (visited == 0).any()
    assert torch.isnan(bricks[visited == 0]).all()
    assert not torch.isnan(bricks[visited > 0]).any()
    got = fused3b.plain_fold_bricks(bricks, visited, SPATIAL, cfg)
    zeroed = torch.where(torch.isnan(bricks), 0.0, bricks)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, fused3b.plain_fold_bricks(zeroed, visited, SPATIAL, cfg),
        rtol=0, atol=0)


def test_bwd_vol_ghost_route_and_budget(monkeypatch):
    """fused3b_bwd_vol takes the ghost path for ghost=True (and for None
    where GHOST_ROUTE says so) where the bricks fit the budget, the
    serialized path otherwise; both give the same cotangent."""
    _, _, cfg, plan, g_p = _case(7, "border")
    calls = []
    real = fused3b.plain_fused3b_bwd_ghost_vol
    monkeypatch.setattr(fused3b, "plain_fused3b_bwd_ghost_vol",
                        lambda *a: calls.append(1) or real(*a))
    serial = fused3b.fused3b_bwd_vol(g_p, plan, SPATIAL, cfg, N_CELL,
                                     ghost=False)
    assert calls == []
    ghost = fused3b.fused3b_bwd_vol(g_p, plan, SPATIAL, cfg, N_CELL,
                                    ghost=True)
    assert calls == [1]
    torch.testing.assert_close(ghost, serial, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(fused3b, "GHOST_ROUTE", True)
    fused3b.fused3b_bwd_vol(g_p, plan, SPATIAL, cfg, N_CELL)
    assert calls == [1, 1]
    shape = fused3b.vol_layout(N_CELL, C, SPATIAL)
    monkeypatch.setattr(fused3b, "GHOST_BUDGET_BYTES", 1024)
    assert not fused3b.ghost_fits(cfg, shape)
    fused3b.fused3b_bwd_vol(g_p, plan, SPATIAL, cfg, N_CELL, ghost=True)
    assert calls == [1, 1]
    assert fused3b.fused3b_bwd_vol.launches == 0
    assert fused3b.fused3b_bwd_ghost_vol.launches == 0


def test_ghost_fits_config5_and_its_c16_fallback():
    """At config 5 (16 x 4 x 128^3) the bricks fit the 6 GiB budget; at 16
    channels they do not (3 z slabs a brick over 2.1 GB of volume), and
    the serialized kernel serves, as JAX's budget sends it there."""
    cfg = TConfig(dim=3)
    assert fused3b.ghost_fits(cfg, (128, 128, 128, 16, 4))
    assert not fused3b.ghost_fits(cfg, (128, 128, 128, 16, 16))
    # one cell of one channel group's brick over a block's shared memory
    assert not fused3b.ghost_fits(cfg, (8, 8, 4096, 1, 8))
