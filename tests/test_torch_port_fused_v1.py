"""PyTorch port, the channel-looped v1 fused kernels (C > 8, 2D and 3D),
the small-cloud fused2d kernels, the routes of the calls no kernel takes,
and exact mode under any global matmul precision.

The plain versions of both kernel pairs are held to the JAX package's
Pallas kernels in interpret mode; the slice at C = 12 to
``jax.value_and_grad(pinn.loss_fused)``; the routes are pure functions of
shapes, dtypes and device type, tested here with shapes alone.  On the
CPU the kernel wrappers take their plain versions; chip_smoke.py holds the
CUDA kernels to those on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas.fused import (pallas_fused_blend,
                                                pallas_fused_bwd)
from cosinesampler_tpu.ops.pallas.fused2d import (pallas_fused2_blend,
                                                  pallas_fused2_bwd)
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.models import train as ttrain
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops import generic
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused as fused_v1
from cosinesampler_tpu_torch.ops.cuda import fused2d, fused2w, fused3w, route
from cosinesampler_tpu_torch.utils import pointgen as tpointgen
from cosinesampler_tpu_torch.utils.convert import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32, F64 = torch.float32, torch.float64
# Q off every block size: JAX's 2048 (2D) and 256 (3D) fused blocks, the
# fused2d kernel's 256
Q = 300


def _data(dim, n, c, spatial, seed, lo=-1.4, hi=1.4, q=Q):
    rng = np.random.RandomState(seed)
    cells = rng.rand(n, c, *spatial).astype(np.float32)
    pts = rng.uniform(lo, hi, (q, dim)).astype(np.float32)
    g = rng.standard_normal((1 + 2 * dim, c, q)).astype(np.float32)
    return cells, pts, g


def _close(got, want, rtol):
    """rtol per element with an absolute floor of rtol times the largest
    magnitude, for entries that cancel to ~0 in f32."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _jax_pair(blend, bwd, cells, pts, g, cfg, n):
    """The JAX blend and bwd, jitted whole: one interpret-mode program."""
    spatial = tuple(cells.shape[2:])

    @jax.jit
    def run(c, p, gv):
        return blend(c, p, cfg, interpret=True), bwd(
            gv, p, spatial, cfg, n, interpret=True)

    return run(jnp.asarray(cells), jnp.asarray(pts), jnp.asarray(g))


# (dim, channels, padding mode): C off the 8-channel group width, every
# padding in 2D and 3D
V1_CASES = [(2, 9, "zeros"), (2, 12, "border"), (2, 9, "reflection"),
            (3, 12, "zeros"), (3, 9, "border"), (3, 12, "reflection")]


@pytest.mark.parametrize("dim,c,padding", V1_CASES,
                         ids=[f"{d}d-c{c}-{p}" for d, c, p in V1_CASES])
def test_plain_v1_pair_matches_pallas_fused_interpret(dim, c, padding):
    """The v1 plain pair against pallas_fused_blend / pallas_fused_bwd in
    interpret mode, points to +-1.4 (out-of-range corners), Q = 300: at the
    JAX package's own tolerance for them (tests/test_fused.py: rtol 3e-4,
    atol 1e-4; the TPU kernels use polynomial trig and split-bf16 MXU
    sums), the bwd's atol scaled by its largest magnitude."""
    spatial = (6, 7) if dim == 2 else (4, 5, 6)
    n = 3
    cells, pts, g = _data(dim, n, c, spatial, seed=c + dim)
    jcfg = JConfig(dim=dim, padding_mode=padding, backend="pallas")
    tcfg = TConfig(dim=dim, padding_mode=padding)
    want, want_b = _jax_pair(pallas_fused_blend, pallas_fused_bwd, cells, pts,
                             g, jcfg, n)
    tc, tp, tg = (torch.from_numpy(a) for a in (cells, pts, g))
    got = fused_v1.fused_blend(tc, tp, tcfg)
    got_b = fused_v1.fused_bwd(tg, tp, spatial, tcfg, n)
    assert got.shape == (1 + 2 * dim, c, Q) and got.dtype == F32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=3e-4,
                               atol=1e-4 * float(np.abs(want_b).max()))


@pytest.mark.parametrize("padding,kernel,multicell", [
    ("zeros", "cosine", True), ("border", "smoothstep", False),
    ("reflection", "linear", True)])
def test_plain_fused2d_pair_matches_pallas_fused2_interpret(padding, kernel,
                                                            multicell):
    """The fused2d plain pair against pallas_fused2_blend /
    pallas_fused2_bwd in interpret mode on each padding mode of the JAX
    kernels (zeros, border, reflection), points to +-1.4, Q = 300 (two of
    the JAX kernel's 256-query blocks): rtol 3e-4, atol 1e-4 as the JAX
    package's tests/test_fused2d.py holds them."""
    n, c = 6, 4
    cells, pts, g = _data(2, n, c, (8, 8), seed=7)
    kw = dict(dim=2, padding_mode=padding, kernel=kernel, multicell=multicell)
    want, want_b = _jax_pair(pallas_fused2_blend, pallas_fused2_bwd, cells,
                             pts, g, JConfig(backend="pallas", **kw), n)
    tc, tp, tg = (torch.from_numpy(a) for a in (cells, pts, g))
    got = fused2d.fused_blend(tc, tp, TConfig(**kw))
    got_b = fused2d.fused_bwd(tg, tp, (8, 8), TConfig(**kw), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=3e-4,
                               atol=1e-4 * float(np.abs(want_b).max()))


# --- the slice at C = 12 -------------------------------------------------------

SLICE = {2: dict(n_cells=6, cell_dim=12, cell_size=8, hidden=16),
         3: dict(dim=3, n_cells=3, cell_dim=12, cell_size=6, hidden=8,
                 pde="helmholtz")}


@pytest.mark.parametrize("dim", [2, 3], ids=["2d-allen-cahn",
                                             "3d-helmholtz"])
def test_wide_slice_loss_and_grads_match_jax(dim):
    """pinn.loss_fused at C = 12 through the rule's route (fused2w's and
    fused3w's channel groups at these sizes), against
    jax.value_and_grad(pinn.loss_fused) on the same weights and points:
    loss rtol 1e-5, every leaf rtol 1e-4 (the reference's dloss/dcells
    bar)."""
    jcfg, tcfg = jpinn.PINNConfig(**SLICE[dim]), tpinn.PINNConfig(**SLICE[dim])
    np_params = {k: v.detach().numpy() for k, v in tpinn.init_params(
        torch.Generator().manual_seed(dim), tcfg, "cpu").items()}
    pts = tpointgen.PointGenerator(200, dim, seed=dim,
                                   force_numpy=True).batch(0)
    want_loss, want = jax.jit(jax.value_and_grad(jpinn.loss_fused),
                              static_argnums=2)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
        jcfg)
    assert route.fused_rule(tcfg.sampler, np_params["cells"].shape, 200,
                            "cuda") == f"fused{dim}w"
    before = fused_v1.fused_bwd.launches
    params = params_from_numpy(np_params, "cpu")
    loss = tpinn.loss_fused(params, torch.from_numpy(pts), tcfg)
    loss.backward()
    assert fused_v1.fused_bwd.launches == before     # the CPU takes plain
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for k, p in params.items():
        _close(p.grad.numpy(), want[k], 1e-4)


def test_wide_trainer_two_steps_on_cpu():
    """Two trainer steps at C = 12 on the CPU: finite, falling losses, equal
    to two make_train_step steps on the trainer's weights and points."""
    model = tpinn.PINNConfig(**SLICE[2])
    cfg = ttrain.TrainConfig(model=model, batch_points=256, steps=2, lr=1e-2,
                             seed=3, device="cpu", log_every=1)
    _, metrics = ttrain.train(cfg)
    losses = [m["loss"] for m in metrics]
    params = tpinn.init_params(torch.Generator().manual_seed(3), model, "cpu")
    step = tpinn.make_train_step(
        model, torch.optim.Adam(params.values(), lr=1e-2), fused=True)
    with tpointgen.PointGenerator(256, 2, seed=3) as gen:
        want = [float(step(params, torch.from_numpy(gen.batch(i))))
                for i in range(2)]
    np.testing.assert_allclose(losses, want, rtol=1e-6)
    assert all(np.isfinite(losses)) and params["cells"].shape[1] == 12


# --- the routes -----------------------------------------------------------------

def test_fused_rule_follows_the_jax_order():
    """route.fused_rule as a pure function of shapes, dtypes and device
    type: plain for what no CUDA kernel takes; above 8 channels the v1
    kernels, but fused3w's channel groups for small 3D clouds; the 3D
    kernels in 3D (fused3d for these small clouds;
    tests/test_torch_port_fused3ds.py holds the 3D branch), fused2d for
    small 2D clouds whose channel group fits shared memory, fused2w
    otherwise; off the card the same kernel routes."""
    cfg2, cfg3 = TConfig(dim=2), TConfig(dim=3)
    max_q, pairs = route.FUSED2D_MAX_Q, route.FUSED2D_MAX_PAIRS
    rule = route.fused_rule
    assert rule(cfg2, (96, 4, 16, 16), 100_000) == "fused2w"
    # the sweep's points (PERF.md section 4), each to its faster kernel
    # but 32 x 6144, where fused2d won by 4% at the pair count at which it
    # lost by 27% at 8 cells
    for n, q, want in [(96, 2047, "fused2d"), (96, 2731, "fused2d"),
                       (96, 3072, "fused2d"), (96, 3584, "fused2d"),
                       (96, 4096, "fused2w"), (32, 4096, "fused2d"),
                       (32, 6144, "fused2w"), (32, 7168, "fused2w"),
                       (32, 8192, "fused2w"), (8, 8192, "fused2d"),
                       (8, 16384, "fused2d"), (8, 24576, "fused2w"),
                       (8, 32768, "fused2w")]:
        assert rule(cfg2, (n, 4, 16, 16), q) == want, (n, q)
    assert rule(cfg2, (96, 4, 16, 16), max_q) == "fused2d"
    assert rule(cfg2, (96, 4, 16, 16), max_q + 1) == "fused2w"
    assert rule(cfg2, (8, 4, 16, 16), pairs // 8) == "fused2d"
    assert rule(cfg2, (8, 4, 16, 16), pairs // 8 + 1) == "fused2w"
    assert rule(cfg3, (50, 4, 16, 16, 16), 100) == "fused3d"
    for shape in ((96, 16, 16, 16), (50, 16, 16, 16, 16)):
        cfg = cfg2 if len(shape) == 4 else cfg3
        assert rule(cfg, shape, 100_000) == "fused"
        assert rule(cfg, shape, 100) == ("fused" if cfg is cfg2
                                         else "fused3w")
    assert rule(cfg2, (96, 9, 16, 16), 100_000) == "fused2w"
    # a 4 x 256^2 cell (1 MB) is over a block's shared memory
    assert rule(cfg2, (2, 4, 256, 256), 100) == "fused2w"
    for what, args in [
            ("f64", (cfg2, (96, 4, 16, 16), 100_000, "cuda", F64)),
            ("f64 at C > 8", (cfg3, (8, 16, 8, 8, 8), 100, "cuda", F64)),
            ("strict, align off",
             (TConfig(dim=2, strict_reference=True, align_corners=False),
              (96, 4, 16, 16), 100_000, "cuda", F32)),
            ("2^31 cells", (cfg2, (2, 4, 16384, 16384), 100, "cuda", F32)),
            ("2^31 rows", (cfg2, (8, 64, 16, 16), 2**31 // 320 + 1, "cuda",
                           F32))]:
        assert rule(*args) == "plain", what
    # strict 3D with align off takes the kernels (no mixed rows in 3D)
    assert rule(TConfig(dim=3, strict_reference=True, align_corners=False),
                (8, 4, 8, 8, 8), 100, "cuda", F32) == "fused3d"
    # off the card the wrappers decide: the CPU takes the plain versions
    assert rule(cfg2, (96, 4, 16, 16), 100_000, "cpu", F64) == "fused2w"
    assert rule(cfg3, (8, 16, 8, 8, 8), 100, "cpu", F64) == "fused3w"
    assert rule(cfg3, (8, 16, 8, 8, 8), 100_000, "cpu", F64) == "fused"
    assert rule(cfg2, (96, 4, 16, 16), 100_000, "mixed", F64) == "fused2w"


def test_sampler_rule_sends_what_no_kernel_takes_to_plain():
    """route.sampler_rule: f64 and over-2^31 CUDA calls take the plain
    route; the other CUDA calls take route.rule; off the card blend_o,
    whose wrapper decides."""
    cfg2, cfg3 = TConfig(dim=2), TConfig(dim=3)
    sr = route.sampler_rule
    assert sr(cfg2, (96, 4, 16, 16), (1, 1, 100_000, 2)) == "blend_o"
    assert sr(cfg3, (16, 4, 128, 128, 128), (1, 1, 1, 100_000, 3)) == \
        "slab"
    assert sr(cfg2, (96, 4, 16, 16), (1, 1, 100_000, 2), "cuda", F64) == \
        "plain"
    assert sr(cfg2, (2, 4, 16384, 16384), (1, 1, 4096, 2)) == "plain"
    # N * C * Q output elements over the limit
    assert sr(cfg2, (2**12, 4, 4, 4), (1, 1, 2**17, 2)) == "plain"
    assert sr(cfg2, (96, 4, 16, 16), (1, 1, 100_000, 2), "cpu", F64) == \
        "blend_o"
    assert sr(cfg2, (96, 4, 16, 16), (1, 1, 100_000, 2), "mixed", F32) == \
        "blend_o"


@pytest.mark.parametrize("name", ["fused2w", "fused2d", "fused3w", "fused",
                                  "plain"])
def test_fused_op_dispatches_to_the_rule_route(monkeypatch, name):
    """sample_features_with_derivs runs the blend and the cells transpose
    of the route route.fused_rule gives (the bwd mirrors the blend); the
    plain route counts its two calls in route.run_plain.launches."""
    seen = []
    mods = {"fused2w": fused2w, "fused2d": fused2d, "fused3w": fused3w,
            "fused": fused_v1}
    for tag, mod in mods.items():
        for fn_name in ("fused_blend", "fused_bwd"):
            fn = getattr(mod, fn_name)

            def spy(*args, _fn=fn, _tag=(tag, fn_name)):
                seen.append(_tag)
                return _fn(*args)
            monkeypatch.setattr(mod, fn_name, spy)
    monkeypatch.setattr(route, "fused_rule", lambda *args: name)
    cells, pts, g = _data(2, 3, 4, (6, 7), seed=11, q=40)
    tc = torch.tensor(cells, requires_grad=True)
    before = route.run_plain.launches
    out = tfused.sample_features_with_derivs(tc, torch.from_numpy(pts),
                                             TConfig(dim=2))
    (out * torch.from_numpy(g)).sum().backward()
    if name == "plain":
        assert seen == [] and route.run_plain.launches == before + 2
    else:
        assert seen == [(name, "fused_blend"), (name, "fused_bwd")]
        assert route.run_plain.launches == before
    want = fused2w.plain_fused_bwd(torch.from_numpy(g), torch.from_numpy(pts),
                                   (6, 7), TConfig(dim=2), 3)
    torch.testing.assert_close(tc.grad, want, rtol=0, atol=0)


def test_plain_route_of_the_sampler_counts_and_matches(monkeypatch):
    """route.blend / route.splat on the plain route: the plain versions on
    the call's own device, one count each."""
    monkeypatch.setattr(route, "pick", lambda *args: "plain")
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.rand(3, 2, 5, 6))
    grid = torch.from_numpy(rng.uniform(-1, 1, (1, 4, 7, 2)))
    cfg = TConfig(dim=2)
    before = route.run_plain.launches
    out = route.blend(x, grid, cfg, (1, 0))
    back = route.splat(out, grid, (5, 6), cfg, (1, 0))
    assert route.run_plain.launches == before + 2
    torch.testing.assert_close(out, generic.blend(x, grid, cfg,
                                                          (1, 0)))
    torch.testing.assert_close(back, generic.splat(out, grid, (5, 6),
                                                           cfg, (1, 0)))


def test_fused2d_supports_what_a_block_stages():
    assert fused2d.supports(TConfig(dim=2), (96, 4, 16, 16))
    assert fused2d.supports(TConfig(dim=2), (96, 16, 16, 16))
    assert fused2d.supports(TConfig(dim=2), (3, 4, 64, 64))
    assert not fused2d.supports(TConfig(dim=2), (2, 4, 256, 256))
    assert not fused2d.supports(TConfig(dim=3), (2, 4, 8, 8, 8))


@pytest.mark.parametrize("mod", [fused_v1, fused2d], ids=["v1", "fused2d"])
def test_new_wrappers_take_plain_on_cpu_and_raise_off_it(mod):
    """On the CPU the wrappers are their plain versions and count no
    launch; a tensor on another device (meta here) raises."""
    cells, pts, g = (torch.from_numpy(a) for a in _data(2, 3, 9, (6, 7), 13))
    cfg = TConfig(dim=2, padding_mode="border")
    before = (mod.fused_blend.launches, mod.fused_bwd.launches)
    torch.testing.assert_close(mod.fused_blend(cells, pts, cfg),
                               mod.plain_fused_blend(cells, pts, cfg),
                               rtol=0, atol=0)
    torch.testing.assert_close(mod.fused_bwd(g, pts, (6, 7), cfg, 3),
                               mod.plain_fused_bwd(g, pts, (6, 7), cfg, 3),
                               rtol=0, atol=0)
    assert (mod.fused_blend.launches, mod.fused_bwd.launches) == before
    meta = dict(dtype=F32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mod.fused_blend(torch.empty((3, 9, 6, 7), **meta),
                        torch.empty((Q, 2), **meta), cfg)


# --- exact mode -----------------------------------------------------------------

_MATMULS = {"mm", "bmm", "addmm", "addbmm", "baddbmm", "matmul", "mv",
            "addmv", "dot", "vdot", "linear"}


class _RecordMatmuls(TorchDispatchMode):
    """The dtypes of the tensors each matmul-family aten op gets, forward
    and backward."""

    def __init__(self):
        super().__init__()
        self.dtypes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in _MATMULS:
            self.dtypes.update(a.dtype for a in args
                               if isinstance(a, torch.Tensor))
        return func(*args, **(kwargs or {}))


def _loss_and_grads(loss, cfg, params, pts):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    with _RecordMatmuls() as rec:
        lval = getattr(tpinn, loss)(leaves, pts, cfg)
        lval.backward()
    return (float(lval.detach()), {k: v.grad for k, v in leaves.items()},
            rec.dtypes)


@pytest.mark.parametrize("loss", ["loss_fused", "loss", "loss_fused_slots"])
def test_exact_mode_takes_f64_matmuls_where_tf32_would_serve(monkeypatch,
                                                             loss):
    """C2: where an f32 matmul would run in TF32 (pinn._tf32: a CUDA
    tensor under torch.set_float32_matmul_precision("high")), every matmul
    of the MLP and its derivative ladder, forward and backward, nested
    autograd included, runs in f64; the loss and gradients equal the f32
    ones to f32 rounding (rtol 1e-6).  Without TF32 the matmuls stay f32."""
    cfg = tpinn.PINNConfig(n_cells=3, cell_dim=4, cell_size=6, hidden=8)
    params = tpinn.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    pts = torch.from_numpy(tpointgen.PointGenerator(
        64, 2, seed=0, force_numpy=True).batch(0))
    want_loss, want, dtypes = _loss_and_grads(loss, cfg, params, pts)
    assert dtypes == {F32}
    monkeypatch.setattr(tpinn, "_tf32", lambda t: True)
    got_loss, got, dtypes = _loss_and_grads(loss, cfg, params, pts)
    assert dtypes == {F64}
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for k in want:
        assert got[k].dtype == F32
        _close(got[k].numpy(), want[k].numpy(), 1e-6)


def test_tf32_reads_the_global_setting_on_the_card_only():
    """pinn._tf32 follows torch's effective TF32 flag for CUDA tensors and
    is False for CPU ones, whose matmuls TF32 never serves."""
    cpu = torch.zeros(1)
    meta = torch.empty(1, device="meta")
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32
        assert not tpinn._tf32(cpu) and not tpinn._tf32(meta)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_ladder_matches_jax_in_f64():
    """The ladder (einsum contractions through pinn._contract) against the
    JAX package's unrolled-FMA ladder with its nested jvps, f64: u, u_x,
    u_xx to 1e-12."""
    rng = np.random.RandomState(14)
    for dim in (2, 3):
        c, hidden, q = 5, 7, 33
        feats = rng.standard_normal((1 + 2 * dim, c, q))
        params = {"w1": rng.standard_normal((c, hidden)),
                  "b1": rng.standard_normal((hidden,)),
                  "w2": rng.standard_normal((hidden, 1)),
                  "b2": rng.standard_normal((1,))}
        # tests/conftest.py enables x64
        want = jax.tree_util.tree_map(np.asarray, jpinn._mlp_derivs(
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(feats), dim))
        got = tpinn._mlp_derivs({k: torch.from_numpy(v)
                                 for k, v in params.items()},
                                torch.from_numpy(feats), dim)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-12,
                                   atol=1e-12)
        for k in (1, 2):
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                           atol=1e-12)
