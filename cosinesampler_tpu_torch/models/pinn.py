"""PIXEL-style PINN: multicell feature grids + tiny MLP + PDE residual.

Counterpart of the JAX package's models/pinn.py, in two forms of one loss:

* the fused path (``loss_fused``): sample the cell ensemble's value,
  jacobian and diagonal Hessian in one fused pass (ops/fused.py) and push
  them through the tanh MLP in closed form;
* the nested-autograd path (``loss``), the reference's own recipe: sample
  u through the public sampler (ops/sampler.py) and take u_y, u_xx (or the
  Laplacian) with ``torch.autograd.grad(..., create_graph=True)``, so the
  loss's gradient reaches the cells at third order.

Both train on the PDE residual, with gradients to the cells and the MLP by
autograd.  The megakernel step (``value_and_grad_mega``) computes the fused
loss's value and gradient in one kernel launch instead (ops/cuda/mega2w.py).
The vol-resident step (``loss_fused_slots_vol``) keeps ``cells`` in the
bricked 3D kernels' layout across steps (ops/cuda/fused3b.py).

Parameters are a plain dict of leaf tensors with the JAX package's names
and layouts (``cells`` (N, C, *S), ``w1`` (C, hidden), ``b1`` (hidden,),
``w2`` (hidden, 1), ``b2`` (1,)), so utils/convert.py moves weights between
the two packages unchanged.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.config import SamplerConfig
from ..ops.fused import (make_fused_mega, make_fused_vol,
                         sample_features_padded, sample_features_with_derivs)
from ..ops.sampler import sample


@dataclasses.dataclass(frozen=True)
class PINNConfig:
    dim: int = 2
    n_cells: int = 96
    cell_dim: int = 4            # feature channels
    cell_size: int = 16
    hidden: int = 16
    kernel: str = "cosine"
    padding_mode: str = "zeros"
    align_corners: bool = True
    multicell: bool = True
    backend: str = "auto"        # "xla": the plain PyTorch sampler
    precision: str = "exact"
    pde: str = "allen_cahn"      # allen_cahn (2D) | helmholtz (3D)

    @property
    def sampler(self) -> SamplerConfig:
        return SamplerConfig(
            dim=self.dim, kernel=self.kernel, padding_mode=self.padding_mode,
            align_corners=self.align_corners, multicell=self.multicell,
            backend=self.backend, precision=self.precision,
        )


def init_params(generator: torch.Generator, cfg: PINNConfig, device,
                dtype=torch.float32):
    """Cell grids ~ U[0, 1] and a Glorot-normal MLP, as leaf tensors that
    require grad.  Drawn on the generator's device (the CPU for a default
    ``torch.Generator``), so one seed gives one set of weights on every
    device."""
    spatial = (cfg.cell_size,) * cfg.dim
    kw = dict(dtype=dtype, device=generator.device)
    cells = torch.rand((cfg.n_cells, cfg.cell_dim, *spatial),
                       generator=generator, **kw)
    s1 = math.sqrt(2.0 / (cfg.cell_dim + cfg.hidden))
    s2 = math.sqrt(2.0 / (cfg.hidden + 1))
    w1 = torch.randn((cfg.cell_dim, cfg.hidden), generator=generator,
                     **kw) * s1
    w2 = torch.randn((cfg.hidden, 1), generator=generator, **kw) * s2
    params = {
        "cells": cells,
        "w1": w1,
        "b1": torch.zeros((cfg.hidden,), **kw),
        "w2": w2,
        "b2": torch.zeros((1,), **kw),
    }
    return {k: v.to(device).requires_grad_(True) for k, v in params.items()}


def _tf32(t: torch.Tensor) -> bool:
    """Whether an f32 matmul on ``t``'s device would run in TF32: on the
    card, under torch.set_float32_matmul_precision("high") or "medium" (or
    torch.backends.cuda.matmul.allow_tf32 = True, or its newer
    fp32_precision = "tf32"); torch's own reading of whichever API set it."""
    return t.is_cuda and torch.backends.cuda.matmul.allow_tf32


def _contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum(eq, a, b), exact f32 whatever the global matmul
    precision: where TF32 would serve an f32 matmul (``_tf32``), the
    contraction runs in f64 and is rounded back, and so does its autograd
    backward, whose matmuls see f64 tensors.  TF32 moves the residual far
    past the f32 tolerance; the JAX package's ladder avoids the TPU's bf16
    matmul passes the same way, by not letting the setting reach it."""
    if _tf32(b):
        return torch.einsum(eq, a.double(), b.double()).to(b.dtype)
    return torch.einsum(eq, a, b)


def _mlp(params, feats):
    """(Q, C) features -> (Q,) u, exact f32 (see _contract)."""
    h = torch.tanh(_contract("qc,ch->qh", feats, params["w1"])
                   + params["b1"])
    return _contract("qh,hk->qk", h, params["w2"])[..., 0] + params["b2"]


def field(params, pts, cfg: PINNConfig):
    """u(points): sample the cells, sum the ensemble, apply the MLP.

    pts: (Q, dim) in [-1, 1].  Returns (Q,).  The grid is the shared-query
    grid of batch 1, which the sampler broadcasts across the cells.
    """
    cells = params["cells"]
    n = cells.shape[0]
    q = pts.shape[0]
    grid = pts.reshape((1,) * cfg.dim + tuple(pts.shape))
    out = sample(cells, grid, cfg.sampler)             # (N, C, ..., Q)
    feats = out.reshape(n, cfg.cell_dim, q).sum(dim=0)  # (C, Q)
    return _mlp(params, feats.T)


def _with_grad(pts):
    return pts if pts.requires_grad else pts.detach().requires_grad_(True)


def spatial_derivative(params, pts, cfg: PINNConfig, axis: int,
                       order: int = 1):
    """d^order u / d(axis)^order per point, by nested grad-of-sum.

    Valid because u(q) depends only on pts[q], so the gradient of the sum
    is the per-point derivative.  The result keeps its graph
    (``create_graph=True``) for the next order and for the loss.
    """
    if order == 0:
        return field(params, pts, cfg)
    pts = _with_grad(pts)
    inner = spatial_derivative(params, pts, cfg, axis, order - 1)
    (grad,) = torch.autograd.grad(inner.sum(), pts, create_graph=True)
    return grad[:, axis]


def residual(params, pts, cfg: PINNConfig):
    """PDE residual at the collocation points, by nested autograd.

    The JAX package evaluates ``field`` anew for each derivative; here u is
    built once and every derivative comes from its graph, which is the
    same function with fewer sampler launches.
    """
    pts = _with_grad(pts)
    u = field(params, pts, cfg)
    (du,) = torch.autograd.grad(u.sum(), pts, create_graph=True)

    def second(ax):
        (g,) = torch.autograd.grad(du[:, ax].sum(), pts, create_graph=True)
        return g[:, ax]

    if cfg.pde == "allen_cahn":
        # f = 2 u_y + 5 u^3 - 5 u - 1e-4 u_xx
        return 2.0 * du[:, 1] + 5.0 * u**3 - 5.0 * u - 1e-4 * second(0)
    if cfg.pde == "helmholtz":
        # f = u_xx + u_yy (+ u_zz) + u
        return sum(second(ax) for ax in range(cfg.dim)) + u
    raise ValueError(f"unknown pde {cfg.pde!r}")


def loss(params, pts, cfg: PINNConfig):
    return torch.mean(residual(params, pts, cfg) ** 2)


def _mlp_derivs(params, feats, dim):
    """u, [u_x..], [u_xx..] of the tanh MLP over value/jac/diag-Hessian rows.

    Closed form of the JAX package's nested jvp ladder, channels first:
    with pre = W1^T f + b1 and h = tanh(pre),
        u_x  = w2 . (tanh'(pre) * W1^T f_x)
        u_xx = w2 . (tanh''(pre) * (W1^T f_x)^2 + tanh'(pre) * W1^T f_xx)
    where tanh' = 1 - h^2 and tanh'' = -2 h tanh'.  Exact f32 whatever
    the global matmul precision (see _contract).
    """
    w1 = params["w1"]                      # (C, hidden)
    w2 = params["w2"][:, 0]                # (hidden,)

    def lin(z):                            # (C, Q) -> (hidden, Q)
        return _contract("ch,cq->hq", w1, z)

    h = torch.tanh(lin(feats[0]) + params["b1"][:, None])
    d1 = 1.0 - h * h
    d2 = -2.0 * h * d1
    u = _contract("h,hq->q", w2, h) + params["b2"][0]
    u_d, u_dd = [], []
    for ax in range(dim):
        a = lin(feats[1 + ax])
        b = lin(feats[1 + dim + ax])
        u_d.append(_contract("h,hq->q", w2, d1 * a))
        u_dd.append(_contract("h,hq->q", w2, d2 * a * a + d1 * b))
    return u, u_d, u_dd


def _residual_from_fields(u, u_d, u_dd, cfg: PINNConfig):
    if cfg.pde == "allen_cahn":
        # f = 2 u_y + 5 u^3 - 5 u - 1e-4 u_xx
        return 2.0 * u_d[1] + 5.0 * u**3 - 5.0 * u - 1e-4 * u_dd[0]
    if cfg.pde == "helmholtz":
        # f = u_xx + u_yy (+ u_zz) + u
        return sum(u_dd) + u
    raise ValueError(f"unknown pde {cfg.pde!r}")


def field_and_grads(params, pts, cfg: PINNConfig):
    """u, [u_x, u_y(, u_z)], [u_xx, u_yy(, u_zz)] from one fused pass."""
    feats = sample_features_with_derivs(params["cells"], pts, cfg.sampler)
    return _mlp_derivs(params, feats, cfg.dim)


def residual_fused(params, pts, cfg: PINNConfig):
    """PDE residual via the fused value/derivative pass."""
    u, u_d, u_dd = field_and_grads(params, pts, cfg)
    return _residual_from_fields(u, u_d, u_dd, cfg)


def loss_fused(params, pts, cfg: PINNConfig):
    return torch.mean(residual_fused(params, pts, cfg) ** 2)


def _slot_loss(params, feats, occ, q, cfg: PINNConfig):
    u, u_d, u_dd = _mlp_derivs(params, feats, cfg.dim)
    f = _residual_from_fields(u, u_d, u_dd, cfg)
    return torch.sum(f * f * occ) / q


def loss_fused_slots(params, pts, cfg: PINNConfig, plan=None):
    """loss_fused computed in the sampler's slot layout, masked by ``occ``:
    the identity layout without a plan, the brick plan's with one
    (ops/fused.py sample_features_padded)."""
    feats, occ, _ = sample_features_padded(params["cells"], pts, cfg.sampler,
                                           plan=plan)
    return _slot_loss(params, feats, occ, pts.shape[0], cfg)


def _fused_vol_for(cfg: PINNConfig, n_queries: int):
    """The kernel-layout fused op of this trainer shape, or raise."""
    ops = make_fused_vol(cfg.sampler, cfg.n_cells, cfg.cell_dim,
                         (cfg.cell_size,) * cfg.dim, n_queries)
    if ops is None:
        raise ValueError(
            "vol_resident training requires a config and shape that the "
            "bricked 3D kernels take (ops/cuda/fused3b.py supports: 3D, at "
            "least 2 queries per bin, not backend='xla'); this one does "
            "not")
    return ops


def vol_converters(cfg: PINNConfig, n_queries: int):
    """(to_vol, from_vol): the cells' conversions to and from the kernel
    layout of this trainer shape."""
    _, to_vol, from_vol = _fused_vol_for(cfg, n_queries)
    return to_vol, from_vol


def _convert_cells(params, convert):
    cells = params["cells"]
    return {**params, "cells": convert(cells.detach()).requires_grad_(
        cells.requires_grad)}


def params_to_vol(params, cfg: PINNConfig, n_queries: int):
    """``params`` with ``cells`` in the kernel layout, a leaf again (once,
    before the vol-resident loop and before the optimizer is built)."""
    return _convert_cells(params, vol_converters(cfg, n_queries)[0])


def params_from_vol(params, cfg: PINNConfig, n_queries: int):
    """The inverse of params_to_vol: ``cells`` back in (N, C, *S)."""
    return _convert_cells(params, vol_converters(cfg, n_queries)[1])


def loss_fused_slots_vol(params, pts, cfg: PINNConfig, plan):
    """loss_fused_slots with ``params['cells']`` in the kernel layout and
    a plan of ops.fused.make_vol_plan: the same loss, without the per-step
    relayout of the cells and of their gradient."""
    fused_vol, _, _ = _fused_vol_for(cfg, pts.shape[0])
    feats, occ, _ = fused_vol(params["cells"], pts, plan)
    return _slot_loss(params, feats, occ, pts.shape[0], cfg)


def _cells_shape(cfg: PINNConfig):
    return (cfg.n_cells, cfg.cell_dim, *(cfg.cell_size,) * cfg.dim)


def mega_available(cfg: PINNConfig, n_queries: int) -> bool:
    """True when the one-launch megakernel step serves this trainer shape."""
    return make_fused_mega(cfg.sampler, _cells_shape(cfg), n_queries,
                           cfg.pde, cfg.hidden) is not None


def value_and_grad_mega(params, pts, cfg: PINNConfig, plan=None):
    """(loss, grads) of loss_fused_slots from one mega2w launch (the fused
    blend, the MLP and residual backward and the cotangent splat), with
    grads a dict of params' keys.  Where the kernel does not serve
    (mega_available is False, or ``backend="xla"``) it is torch.autograd
    of loss_fused_slots, the JAX package's semantics.  CPU tensors take the
    plain version of the kernel.  Both results are detached."""
    if plan is not None:
        raise ValueError("the megakernel takes no bin plan (the port's "
                         "plans are 3D brick plans); pass plan=None")
    run = make_fused_mega(cfg.sampler, _cells_shape(cfg), pts.shape[0],
                          cfg.pde, cfg.hidden)
    if run is None:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        lval = loss_fused_slots(leaves, pts, cfg)
        grads = torch.autograd.grad(lval, list(leaves.values()))
        return lval.detach(), dict(zip(leaves, grads))
    return run(params["cells"], {k: params[k] for k in ("w1", "b1", "w2",
                                                        "b2")}, pts)


def make_train_step(cfg: PINNConfig, optimizer: torch.optim.Optimizer,
                    fused: bool = False, slot_resident: bool = False,
                    planned: bool = False, vol_resident: bool = False,
                    megakernel: bool = False):
    """A step ``(params, pts[, plan]) -> loss`` that updates ``params`` in
    place through ``optimizer`` (built over ``params.values()``).

    ``fused`` uses loss_fused, ``slot_resident`` loss_fused_slots,
    ``planned`` loss_fused_slots with a plan argument (make_sample_plan's
    brick plan, or None), and none of them ``loss``, the nested-autograd
    residual.  ``vol_resident`` returns ``step(params, pts, plan)`` over
    loss_fused_slots_vol: ``params['cells']`` in the kernel layout
    (params_to_vol, before the optimizer is built, so that its state is
    born in that layout) and a plan of ops.fused.make_vol_plan.
    ``megakernel`` returns ``step(params, pts, plan=None)``: the gradient
    of loss_fused_slots from value_and_grad_mega, set as each ``p.grad``
    before ``optimizer.step()``.  The returned loss is detached and stays on
    the device.
    """
    if megakernel:
        def mega_step(params, pts, plan=None):
            lval, grads = value_and_grad_mega(params, pts, cfg, plan)
            for k, p in params.items():
                p.grad = grads[k]
            optimizer.step()
            return lval
        return mega_step

    def run(params, loss_fn):
        optimizer.zero_grad(set_to_none=True)
        lval = loss_fn(params)
        # the params only: the nested loss's points are a leaf that requires
        # grad, and a cotangent nothing reads launches no kernel
        # (ops/sampler.py)
        lval.backward(inputs=list(params.values()))
        optimizer.step()
        return lval.detach()

    if vol_resident:
        def vol_step(params, pts, plan):
            return run(params,
                       lambda p: loss_fused_slots_vol(p, pts, cfg, plan))
        return vol_step

    if planned:
        def step(params, pts, plan):
            return run(params, lambda p: loss_fused_slots(p, pts, cfg, plan))
        return step

    loss_fn = (loss_fused_slots if slot_resident
               else loss_fused if fused else loss)

    def step(params, pts):
        return run(params, lambda p: loss_fn(p, pts, cfg))

    return step
