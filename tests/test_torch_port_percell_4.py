"""PyTorch port, the binned per-cell route: part 4 of the tests of
tests/test_torch_port_percell.py, which holds their helpers. The tests
are split into files of at most 10, which xdist's loadfile queue
(ordered by test count) runs beside tests/test_sharding.py rather than
ahead of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import blend_splat, percell, route, slab
from cosinesampler_tpu_torch.utils.convert import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_percell import (C, KW3, SHAPE, _close, _data, chain_jax,
                                     chain_torch, nested_reference)


@pytest.mark.parametrize("name", ["blend_o", "percell", "slab"])
def test_router_dispatches_to_the_picked_route(monkeypatch, name):
    """route.blend / route.splat call the wrapper of the route pick gives,
    with the chain's plan for percell."""
    calls = []

    def record(tag):
        return lambda *args, **kw: calls.append((tag, args, kw))

    monkeypatch.setattr(route, "pick", lambda *args: name)
    for mod, tag in ((blend_splat, "blend_o"), (percell, "percell"),
                     (slab, "slab")):
        monkeypatch.setattr(mod, "blend", record(tag))
        monkeypatch.setattr(mod, "splat", record(tag))
    cells, grid, g = (torch.from_numpy(a) for a in _data(6))
    cfg = TConfig(dim=3)
    plans = route.GridPlans()
    route.blend(cells, grid, cfg, (0, 0, 0), plans)
    route.splat(g, grid, SHAPE, cfg, (1, 0, 0), plans)
    assert [tag for tag, _, _ in calls] == [name, name]
    if name == "percell":
        assert plans.builds == 1
        assert calls[0][1][-1] is calls[1][1][-1]   # one plan for both


@pytest.mark.parametrize("name", ["percell", "slab"])
def test_nested_slice_through_forced_route_matches_jax(monkeypatch, name,
                                                       nested_reference):
    """The nested 3D Helmholtz loss (third-order dloss/dcells) with every
    sampler launch routed to ``name`` (the plain versions on the CPU; slab
    with a small shared-memory budget, so 6 slabs of 2 channels in the
    blend), against jax.value_and_grad: loss at rtol 1e-5, every gradient
    leaf at rtol 1e-4.  One nested step builds one percell plan or one
    set of slab bins."""
    np_params, pts, want_loss, want_grads = nested_reference
    monkeypatch.setattr(route, "pick", lambda *args: name)
    monkeypatch.setattr(slab, "SMEM_BYTES", 600)
    assert slab.geometry(4, (6, 6, 6), 1) == (1, 2)
    builds = {"percell": [], "slab": []}
    make_plan, make_bins = percell.make_plan, slab.make_bins
    monkeypatch.setattr(percell, "make_plan", lambda *a, **k: builds[
        "percell"].append(1) or make_plan(*a, **k))
    monkeypatch.setattr(slab, "make_bins", lambda *a, **k: builds[
        "slab"].append(1) or make_bins(*a, **k))
    params = params_from_numpy(np_params, "cpu")
    loss = tpinn.loss(params, torch.from_numpy(pts), tpinn.PINNConfig(**KW3))
    loss.backward()
    assert {k: len(v) for k, v in builds.items()} == {
        "percell": int(name == "percell"), "slab": int(name == "slab")}
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert set(params) == set(want_grads)
    for k, p in params.items():
        _close(p.grad.numpy(), want_grads[k], 1e-4)


@pytest.mark.parametrize("name", ["percell", "slab"])
def test_per_cell_chain_through_forced_route_matches_jax(monkeypatch, name):
    """The per-cell surface's u_z -> u_zz -> u_zz_cell chain (per-cell
    grids) with every launch routed to ``name`` (slab on 1-row slabs of
    one channel) against nested jax.grad of the JAX package's
    generic.blend, f64, at rtol 1e-9."""
    monkeypatch.setattr(route, "pick", lambda *args: name)
    monkeypatch.setattr(slab, "SMEM_BYTES", 4000)
    assert slab.geometry(C, SHAPE, 1) == (1, 1)
    cells, grid, _ = _data(7, True, -1.1, 1.1, np.float64)
    grid = grid[:, :96, :, None]                 # (N, 96, 1, 1, 3)
    w = np.random.RandomState(8).rand(C)
    kw = dict(padding_mode="reflection")
    want = chain_jax(jnp.asarray(cells), jnp.asarray(grid), jnp.asarray(w),
                     JConfig(dim=3, backend="xla", **kw), 2)
    got = chain_torch(cells, grid, w, TConfig(dim=3, **kw), 2)
    for a, b, what in zip(got, want, ("u_z", "u_zz", "u_zz_cell")):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10, err_msg=what)
