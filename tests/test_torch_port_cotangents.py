"""PyTorch port, the cotangents nothing reads: BlendO / SplatO
(ops/sampler.py) launch no kernel for a cotangent the backward pass drops,
as JAX's dead-code elimination drops it, and the nested train step
backpropagates to its params only.  The torch behaviour the skip rests on
is pinned here, and the nested 2D step is held to the JAX package with
its launches counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd.graph import _get_grad_fn_or_grad_acc

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.ops import sampler
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.utils import pointgen as tpointgen
from cosinesampler_tpu_torch.utils.convert import params_from_numpy


class _Probe(torch.autograd.Function):
    """a * b, whose backward records what the engine tells it."""

    seen = []

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        ctx.set_materialize_grads(False)
        return a * b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        runs = []
        for t in (a, b):
            try:
                runs.append(torch._C._will_engine_execute_node(
                    _get_grad_fn_or_grad_acc(t)))
            except RuntimeError:
                runs.append("raises")
        _Probe.seen.append((g is None, runs, sampler._engine_runs(a),
                            sampler._engine_runs(b)))
        if g is None:
            return None, None
        return g * b, g * a


class _Drop(torch.autograd.Function):
    """The identity, whose backward gives its input no cotangent."""

    @staticmethod
    def forward(ctx, t):
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return None


def test_torch_engine_behaviour_the_skip_relies_on():
    """torch._C._will_engine_execute_node inside a backward: False for a
    leaf outside torch.autograd.grad's inputs, True for a non-leaf on the
    path to them and for every node under .backward(); it raises for a
    leaf that autograd.grad captures (which _engine_runs takes as True);
    .backward(inputs=...) leaves the other leaves out.  With
    materialize_grads off, a cotangent no one produced arrives as None."""
    x = torch.randn(3, requires_grad=True)
    y = torch.randn(3, requires_grad=True)
    _Probe.seen.clear()
    torch.autograd.grad(_Probe.apply(x, y).sum(), x)
    torch.autograd.grad(_Probe.apply(x * 1.0, y).sum(), x)
    _Probe.apply(x, y).sum().backward()
    _Probe.apply(x, y).sum().backward(inputs=[y])
    assert _Probe.seen == [
        (False, ["raises", False], True, False),
        (False, [True, False], True, False),
        (False, [True, True], True, True),
        (False, [False, True], False, True)]
    # an output whose cotangent nothing produced (the node after it
    # returns None): None, not zeros
    _Probe.seen.clear()
    (_Drop.apply(_Probe.apply(x, y)) + x).sum().backward()
    assert [seen[0] for seen in _Probe.seen] == [True]


def _count(monkeypatch):
    """Count the sampler's kernel-route calls (route.blend / route.splat,
    or their plain versions for CPU tensors)."""
    counts = {"blend": 0, "splat": 0}
    blend, splat = sampler._blend, sampler._splat

    def count_blend(*args):
        counts["blend"] += 1
        return blend(*args)

    def count_splat(*args):
        counts["splat"] += 1
        return splat(*args)
    monkeypatch.setattr(sampler, "_blend", count_blend)
    monkeypatch.setattr(sampler, "_splat", count_splat)
    return counts


KW = dict(n_cells=8, cell_size=16, hidden=16)
KW3 = dict(dim=3, n_cells=4, cell_size=6, hidden=8, pde="helmholtz")


@pytest.mark.parametrize("dim", [2, 3], ids=["2d-allen-cahn",
                                             "3d-helmholtz"])
def test_nested_step_launches_fall_and_match_jax(dim, monkeypatch):
    """One nested train step (make_train_step, fused=False): 9 blends and
    9 splats in 2D where every cotangent was computed before (27 and 13:
    the cells' splats under the autograd.grad calls, and the points'
    cotangents of loss.backward(), which nothing reads); 40 and 40 in 3D
    (160 and 53).  Its loss and every gradient leaf match
    jax.value_and_grad(pinn.loss) at rtol 1e-5 / 1e-4."""
    kw = KW if dim == 2 else KW3
    jcfg, tcfg = jpinn.PINNConfig(**kw), tpinn.PINNConfig(**kw)
    np_params = {k: np.asarray(v) for k, v in jpinn.init_params(
        jax.random.PRNGKey(5), jcfg).items()}
    pts = tpointgen.PointGenerator(256, dim, seed=5,
                                   force_numpy=True).batch(0)
    value_and_grad = jax.value_and_grad(jpinn.loss)
    if dim == 2:
        value_and_grad = jax.jit(value_and_grad, static_argnums=2)
    want_loss, want = value_and_grad(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
        jcfg)
    params = params_from_numpy(np_params, "cpu")
    # lr 0: the step leaves the params where JAX's gradient was taken
    step = tpinn.make_train_step(
        tcfg, torch.optim.SGD(params.values(), lr=0.0))
    counts = _count(monkeypatch)
    loss = step(params, torch.from_numpy(pts))
    assert counts == ({"blend": 9, "splat": 9} if dim == 2
                      else {"blend": 40, "splat": 40})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for k, p in params.items():
        want_k = np.asarray(want[k])
        np.testing.assert_allclose(
            p.grad.numpy(), want_k, rtol=1e-4,
            atol=1e-4 * float(np.abs(want_k).max()))


def test_points_gradient_skips_the_cells_splat(monkeypatch):
    """torch.autograd.grad(u.sum(), points) of a sample whose cells require
    grad launches no splat (the cells' cotangent is dropped), and the
    points' gradient is the one computed with the cells frozen."""
    rng = np.random.RandomState(0)
    cfg = TConfig(dim=2)
    cells = torch.tensor(rng.rand(3, 2, 6, 7), dtype=torch.float32)
    grid = torch.tensor(rng.uniform(-1, 1, (1, 1, 40, 2)),
                        dtype=torch.float32)
    counts = _count(monkeypatch)
    pts = grid.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(
        sampler.sample(cells.clone().requires_grad_(True), pts, cfg).sum(),
        pts)
    assert counts == {"blend": 3, "splat": 0}
    pts = grid.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(sampler.sample(cells, pts, cfg).sum(), pts)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
