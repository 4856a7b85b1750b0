"""PyTorch port, the small- and mid-cloud 3D fused kernels: fused3d (the
shared-patch v2 pair) and fused3s (the z-sorted v3 pair), their z sort,
the 3D branch of the fused op's route, and the small-cloud 3D trainer.

The plain versions (ops/cuda/fused2w.py's, which both wrappers take on
the CPU) are held to the JAX package's Pallas kernels in interpret mode on
its own test shapes; the device-side z sort to the JAX package's
``_zbin``; the route is a pure function of shapes, tested with shapes
alone.  chip_smoke.py holds the CUDA kernels to the plain versions on the
card.

The tests are split over this file and
tests/test_torch_port_fused3ds_2.py (files of at most 10 tests, which
xdist's loadfile queue, ordered by test count, runs beside
tests/test_sharding.py rather than ahead of it); the helpers stay here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas.fused3d import (pallas_fused3_blend,
                                                  pallas_fused3_bwd)
from cosinesampler_tpu.ops.pallas.fused3s import (_zbin,
                                                  pallas_fused3s_blend,
                                                  pallas_fused3s_bwd)
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused3d, fused3s, route
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = torch.float32
# the JAX package's tests/test_fused3d.py and test_fused3s.py shapes: 5
# cells x 3 channels x 6^3, 120 points in blocks of 64
N, C, S, Q, Q_BLOCK = 5, 3, 6, 120, 64


def _data(seed, lo, hi):
    rng = np.random.RandomState(seed)
    cells = rng.rand(N, C, S, S, S).astype(np.float32)
    pts = rng.uniform(lo, hi, (Q, 3)).astype(np.float32)
    g = rng.standard_normal((7, C, Q)).astype(np.float32)
    return cells, pts, g


def _tick_points(seed):
    """Points on the texel ticks of a 6^3 cell (align_corners, multicell:
    texel k at -1 + 2k / (S - 2)), as the JAX package's
    test_v3s_blend_boundary_queries draws them: every query on a slab
    boundary."""
    ticks = np.linspace(-1.0, 1.0, S - 1)
    rng = np.random.RandomState(seed)
    return np.stack([rng.choice(ticks, Q) for _ in range(3)],
                    axis=1).astype(np.float32)


def _jax_pair(blend, bwd, cells, pts, g, cfg):
    """The JAX blend and bwd in interpret mode, jitted whole: one
    program."""
    @jax.jit
    def run(c, p, gv):
        return (blend(c, p, cfg, q_block=Q_BLOCK, interpret=True),
                bwd(gv, p, (S, S, S), cfg, N, q_block=Q_BLOCK,
                    interpret=True))

    return run(jnp.asarray(cells), jnp.asarray(pts), jnp.asarray(g))


def _check_pair(mod, jblend, jbwd, kw, cells, pts, g):
    """The wrapper pair of ``mod`` on the CPU (its plain versions) against
    the JAX kernels at the JAX tests' tolerance, rtol 3e-4 and atol 1e-4
    (the TPU kernels sum split-bf16 MXU products), the bwd's atol scaled
    by its largest magnitude."""
    want, want_b = _jax_pair(jblend, jbwd, cells, pts, g,
                             JConfig(dim=3, backend="pallas", **kw))
    tc, tp, tg = (torch.from_numpy(a) for a in (cells, pts, g))
    got = mod.fused_blend(tc, tp, TConfig(dim=3, **kw))
    got_b = mod.fused_bwd(tg, tp, (S, S, S), TConfig(dim=3, **kw), N)
    assert got.shape == (7, C, Q) and got.dtype == F32
    assert got_b.shape == (N, C, S, S, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=3e-4,
                               atol=1e-4 * float(np.abs(want_b).max()))


FUSED3D_CASES = [
    # (config flags, points range): off-volume points to +-1.7 (JAX's
    # test_v3_blend_oob_queries), and reflection's 4-wide patch (64
    # one-hot panels: the slowest interpret program here)
    (dict(), 1.7),
    (dict(padding_mode="reflection", kernel="linear", multicell=False), 1.4),
]


@pytest.mark.parametrize("kw,span", FUSED3D_CASES,
                         ids=["zeros-oob", "reflection-linear-no-multicell"])
def test_plain_fused3d_pair_matches_pallas_fused3_interpret(kw, span):
    """fused3d's plain pair against pallas_fused3_blend / pallas_fused3_bwd
    in interpret mode: zeros with points off the volume, and
    reflection."""
    cells, pts, g = _data(1, -span, span)
    _check_pair(fused3d, pallas_fused3_blend, pallas_fused3_bwd, kw, cells,
                pts, g)


FUSED3S_CASES = [
    # off-volume points to +-1.7: the clamped edge bins (JAX's zmask)
    (dict(), False),
    # every query on a slab boundary (JAX's boundary test), in border
    # padding, the other mode the kernels take
    (dict(padding_mode="border", kernel="smoothstep"), True),
]


@pytest.mark.parametrize("kw,ticks", FUSED3S_CASES,
                         ids=["zeros-oob", "border-slab-boundaries"])
def test_plain_fused3s_pair_matches_pallas_fused3s_interpret(kw, ticks):
    """fused3s's plain pair against pallas_fused3s_blend /
    pallas_fused3s_bwd in interpret mode (q_block 64, so bins span several
    blocks): off-volume points, and queries on slab boundaries."""
    cells, pts, g = _data(2, -1.7, 1.7)
    if ticks:
        pts = _tick_points(3)
    _check_pair(fused3s, pallas_fused3s_blend, pallas_fused3s_bwd, kw, cells,
                pts, g)


@pytest.mark.parametrize("kw,d,q,q_block", [
    (dict(), 6, 1000, 32),
    (dict(padding_mode="border", align_corners=False), 6, 1000, 32),
    (dict(multicell=False), 16, 4099, 128),
    (dict(), 9, 0, 128),
], ids=["zeros", "border-align-false", "16-slabs-no-multicell", "empty"])
def test_zsort_order_and_table_match_jax_zbin(kw, d, q, q_block):
    """zsort's order is the stable sort by the clamped key, the JAX
    package's slot order; its blocks that hold queries are JAX's non-empty
    padded blocks in order (bin and count), their first slots run through
    the order without gaps, and the blocks past them are empty."""
    pts = np.random.RandomState(4).uniform(-1.7, 1.7, (q, 3)).astype(
        np.float32)
    positions, _, zfloor_block, valid, _ = _zbin(
        jnp.asarray(pts), d, JConfig(dim=3, **kw), q_block)
    perm, table = fused3s.zsort(torch.from_numpy(pts), d, TConfig(dim=3, **kw),
                                q_block)
    assert perm.dtype == torch.int32 and table.dtype == torch.int32
    assert table.shape == (-(-q // q_block) + d - fused3s.Z_LO, 3)
    np.testing.assert_array_equal(
        perm.numpy(), np.argsort(np.asarray(positions), kind="stable"))
    counts = np.asarray(valid).reshape(-1, q_block).sum(axis=1)
    want = [(int(z), int(k)) for z, k in zip(np.asarray(zfloor_block), counts)
            if k]
    t = table.numpy()
    live = t[t[:, 2] > 0]
    assert [(int(b) + fused3s.Z_LO, int(k)) for b, _, k in live] == want
    np.testing.assert_array_equal(live[:, 1],
                                  np.cumsum(live[:, 2]) - live[:, 2])
    assert (t[len(live):, 2] == 0).all() and live[:, 2].sum() == q
    # the key: floor of the folded shared z base, clamped to [-2, D - 1]
    key = np.clip(np.floor(fused3s.bin_base(
        torch.from_numpy(pts[:, 2]), d, TConfig(dim=3, **kw)).numpy()),
        fused3s.Z_LO, d - 1)
    assert (np.diff(key[perm.numpy()]) >= 0).all()


# --- the route -----------------------------------------------------------

def test_fused_rule_3d_at_the_jax_dispatch_shapes():
    """route.fused_rule's 3D branch, shapes alone: fused3d up to
    FUSED3D_MAX_Q_PER_CELL queries a cell and FUSED3D_MAX_Q queries, on
    cells of any size (the
    reference's 50 x 4 x 16^3 at JAX's dispatch points 120 and 200, every
    padding; 8 cells, 16 x 4 x 32^3 and JAX's fused3s shape 2 x 2 x 32^3
    at 2048, where fused3d won on the card); fused3s in zeros and border
    at FUSED3S_MIN_Q queries or more over stacks of
    FUSED3S_MIN_STACK_BYTES or more with FUSED3S_MIN_CHANNELS channels
    and FUSED3S_MIN_PLANES (cell, channel) planes or more (config 5's
    16 x 4 x 128^3 with fresh points), each bound checked on both sides
    at the sweep's points; fused3w otherwise; above 8 channels the v1
    pair for stacks the L2 holds (tests/test_torch_port_wide.py holds
    that rule)."""
    rule = route.fused_rule
    cfg = TConfig(dim=3)
    refl = TConfig(dim=3, padding_mode="reflection")
    ref = (50, 4, 16, 16, 16)
    for q in (120, 200):
        for padding in ("zeros", "border", "reflection"):
            assert rule(TConfig(dim=3, padding_mode=padding), ref,
                        q) == "fused3d"
    assert rule(cfg, ref, route.FUSED3D_MAX_Q) == "fused3d"
    assert rule(cfg, ref, route.FUSED3D_MAX_Q + 1) == "fused3w"
    per_cell = route.FUSED3D_MAX_Q_PER_CELL
    assert rule(cfg, (4, 4, 16, 16, 16), 4 * per_cell) == "fused3d"
    assert rule(cfg, (4, 4, 16, 16, 16), 4 * per_cell + 1) == "fused3w"
    assert rule(cfg, (8, 4, 16, 16, 16), 1024) == "fused3d"
    assert rule(cfg, (8, 4, 16, 16, 16), 16384) == "fused3w"
    assert rule(cfg, ref, 100_000) == "fused3w"
    # cells of any size: nothing is staged in shared memory
    assert rule(cfg, (16, 4, 32, 32, 32), 1024) == "fused3d"
    assert rule(cfg, (16, 4, 128, 128, 128), 5120) == "fused3d"
    assert rule(cfg, (16, 4, 128, 128, 128), route.FUSED3D_MAX_Q + 1) == \
        "fused3w"
    assert rule(cfg, (2, 2, 32, 32, 32), 2048) == "fused3d"
    big = (16, 4, 128, 128, 128)
    for padding in ("zeros", "border"):
        assert rule(TConfig(dim=3, padding_mode=padding), big,
                    route.FUSED3S_MIN_Q) == "fused3s"
    assert rule(cfg, big, 1_000_000) == "fused3s"
    assert rule(cfg, big, route.FUSED3S_MIN_Q - 1) == "fused3w"
    assert rule(refl, big, 1_000_000) == "fused3w"
    # each fused3s bound at the sweep's points on its two sides
    assert route.FUSED3S_MIN_STACK_BYTES == 4 * 16 * 4 * 64**3
    for shape, want in [((16, 4, 64, 64, 64), "fused3s"),
                        ((8, 4, 80, 80, 80), "fused3w"),
                        ((16, 4, 96, 96, 96), "fused3s"),
                        ((16, 3, 96, 96, 96), "fused3w"),
                        ((16, 2, 96, 96, 96), "fused3w"),
                        ((6, 4, 128, 128, 128), "fused3w"),
                        ((4, 4, 128, 128, 128), "fused3w")]:
        assert rule(cfg, shape, route.FUSED3S_MIN_Q) == want, shape
        assert rule(cfg, shape, 100_000) == "fused3w", shape
    assert route.FUSED3S_MIN_PLANES == 64
    assert rule(cfg, big, 65_536) == "fused3w"
    assert rule(cfg, big, 262_144) == "fused3w"
    assert rule(cfg, big, 393_216) == "fused3s"
    assert rule(cfg, (16, 4, 64, 64, 64), 393_216) == "fused3s"
    assert rule(cfg, (50, 16, 16, 16, 16), 200) == "fused"
    assert rule(cfg, ref, 200, "cuda", torch.float64) == "plain"


def test_supports_what_a_block_stages():
    """fused3d stages nothing in a block (fused3w's gather and scatter in
    blocks of a few queries), so it takes 3D cells of any size and every
    padding, 2D ones never; fused3s takes zeros and border at any size
    (it reads the cells in place)."""
    cfg = TConfig(dim=3)
    assert fused3d.supports(cfg, (50, 4, 16, 16, 16))
    assert fused3d.supports(TConfig(dim=3, padding_mode="reflection"),
                            (50, 16, 16, 16, 16))
    assert fused3d.supports(cfg, (2, 4, 32, 32, 32))
    assert fused3d.supports(cfg, (16, 16, 128, 128, 128))
    assert not fused3d.supports(TConfig(dim=2), (50, 4, 16, 16))
    assert fused3s.supports(cfg, (16, 4, 128, 128, 128))
    assert fused3s.supports(TConfig(dim=3, padding_mode="border"),
                            (2, 2, 32, 32, 32))
    assert not fused3s.supports(TConfig(dim=3, padding_mode="reflection"),
                                (2, 2, 32, 32, 32))
    assert not fused3s.supports(TConfig(dim=2), (50, 4, 16, 16))


# --- the small-cloud 3D trainer ------------------------------------------

SMALL3 = dict(dim=3, n_cells=6, cell_dim=4, cell_size=8, hidden=8,
              pde="helmholtz")
