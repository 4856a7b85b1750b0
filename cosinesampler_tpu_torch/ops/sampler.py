"""Exact any-order autograd for the sampler: two mutually recursive
``torch.autograd.Function``s.

Counterpart of the JAX package's ops/sampler.py.  The family ``blend_o``
(gather-and-weigh at per-axis derivative orders ``o``) and its
input-transpose ``splat_o`` is closed under differentiation:

    BlendO  backward:  input_bar = splat_o(g)
                       grid_bar[.., ax] = sum_C g * blend_{o+e_ax}(input)
    SplatO  backward:  gout_bar = blend_o(cot)
                       grid_bar[.., ax] = sum_C gout * blend_{o+e_ax}(cot)

Both backwards call ``.apply`` of the pair, so each is itself
differentiable and nested ``torch.autograd.grad(..., create_graph=True)``
is exact at every order, the third-order cell gradient of a PINN loss
included.  Each family member is one kernel launch, blend_o / splat_o,
percell or slab as ops/cuda/route.py routes it, or, under
``backend="xla"`` and for CPU tensors, one plain ops/generic.py call.
Every member of one chain works on one grid and passes one
``route.GridPlans`` along, so percell's pair plan is built once a chain.

A backward computes only the cotangents the engine will use, as JAX's
dead-code elimination and the reference's skip of a zero cotangent
(modules_2d.py:87-89) do.  ``ctx.needs_input_grad`` is fixed when the
forward runs, so each backward asks the running backward pass instead
(``_engine_runs``): under ``torch.autograd.grad(u.sum(), points)`` the
cells' splat is not launched.  The forwards turn off
``materialize_grads``, so a cotangent nothing produced arrives as None
instead of zeros, and the backward then returns None for every input
instead of launching kernels on zeros.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torch.autograd.graph import _get_grad_fn_or_grad_acc

from . import generic
from .config import SamplerConfig
from .cuda import route


def _blend(input, grid, cfg: SamplerConfig, orders, plans):
    """``"xla"``: the plain version; ``"auto"``/``"pallas"``: the routed
    kernel wrapper, which takes the plain version only for CPU tensors."""
    if cfg.backend == "xla":
        return generic.blend(input, grid, cfg, orders)
    return route.blend(input, grid, cfg, orders, plans)


def _splat(gout, grid, in_spatial, cfg: SamplerConfig, orders, plans):
    if cfg.backend == "xla":
        return generic.splat(gout, grid, in_spatial, cfg, orders)
    return route.splat(gout, grid, in_spatial, cfg, orders, plans)


def _engine_runs(t: torch.Tensor) -> bool:
    """Whether the running backward pass executes the node that receives
    ``t``'s cotangent.  ``torch._C._will_engine_execute_node`` answers for
    every node but a leaf that ``torch.autograd.grad`` captures, for which
    it raises: the pass executes that one (it is what the pass returns)."""
    if not t.requires_grad:
        return False
    try:
        return torch._C._will_engine_execute_node(
            _get_grad_fn_or_grad_acc(t))
    except RuntimeError:
        return True


def bump_orders(orders: Tuple[int, ...], axis: int) -> Tuple[int, ...]:
    return tuple(o + (1 if i == axis else 0) for i, o in enumerate(orders))


def _grid_cotangent(weight, source, grid, cfg: SamplerConfig, orders,
                    plans):
    """grid_bar[..., ax] = sum_C weight * blend_{o+e_ax}(source), summed
    over the cells for a shared (batch-1) grid."""
    lanes = [(weight * BlendO.apply(source, grid, cfg,
                                    bump_orders(orders, ax), plans)
              ).sum(dim=1)
             for ax in range(cfg.dim)]
    grid_bar = torch.stack(lanes, dim=-1).to(grid.dtype)
    if grid.shape[0] == 1 and grid_bar.shape[0] != 1:
        grid_bar = grid_bar.sum(dim=0, keepdim=True)   # shared queries
    return grid_bar


class BlendO(torch.autograd.Function):
    """(input (N, C, *S), grid (N or 1, *out, d)) -> (N, C, *out).

    ``plans``: the chain's route.GridPlans; a call without one starts a
    chain."""

    @staticmethod
    def forward(ctx, input, grid, cfg: SamplerConfig,
                orders: Tuple[int, ...], plans=None):
        plans = route.GridPlans() if plans is None else plans
        ctx.save_for_backward(input, grid)
        ctx.cfg, ctx.orders, ctx.plans = cfg, orders, plans
        ctx.set_materialize_grads(False)
        return _blend(input, grid, cfg, orders, plans)

    @staticmethod
    def backward(ctx, g):
        input, grid = ctx.saved_tensors
        cfg, orders, plans = ctx.cfg, ctx.orders, ctx.plans
        input_bar = grid_bar = None
        if g is None:
            return input_bar, grid_bar, None, None, None
        g = g.contiguous()
        if ctx.needs_input_grad[0] and _engine_runs(input):
            input_bar = SplatO.apply(g, grid, tuple(input.shape[2:]), cfg,
                                     orders, plans).to(input.dtype)
        if ctx.needs_input_grad[1] and _engine_runs(grid):
            grid_bar = _grid_cotangent(g, input, grid, cfg, orders, plans)
        return input_bar, grid_bar, None, None, None


class SplatO(torch.autograd.Function):
    """(gout (N, C, *out), grid (N or 1, *out, d)) -> (N, C, *in_spatial)."""

    @staticmethod
    def forward(ctx, gout, grid, in_spatial: Tuple[int, ...],
                cfg: SamplerConfig, orders: Tuple[int, ...], plans=None):
        plans = route.GridPlans() if plans is None else plans
        ctx.save_for_backward(gout, grid)
        ctx.cfg, ctx.orders, ctx.plans = cfg, orders, plans
        ctx.set_materialize_grads(False)
        return _splat(gout, grid, in_spatial, cfg, orders, plans)

    @staticmethod
    def backward(ctx, cot):
        gout, grid = ctx.saved_tensors
        cfg, orders, plans = ctx.cfg, ctx.orders, ctx.plans
        gout_bar = grid_bar = None
        if cot is None:
            return gout_bar, grid_bar, None, None, None, None
        cot = cot.contiguous()
        if ctx.needs_input_grad[0] and _engine_runs(gout):
            gout_bar = BlendO.apply(cot, grid, cfg, orders,
                                    plans).to(gout.dtype)
        if ctx.needs_input_grad[1] and _engine_runs(grid):
            grid_bar = _grid_cotangent(gout, cot, grid, cfg, orders, plans)
        return gout_bar, grid_bar, None, None, None, None


def differentiable_blend(cfg: SamplerConfig, orders: Tuple[int, ...]):
    """``blend_o`` for one (config, orders): (input, grid) -> output."""
    return lambda input, grid: BlendO.apply(input, grid, cfg, tuple(orders))


def differentiable_splat(cfg: SamplerConfig, orders: Tuple[int, ...],
                         in_spatial: Tuple[int, ...]):
    """``splat_o``, the transpose of blend_o w.r.t. the input:
    (gout, grid) -> (N, C, *in_spatial)."""
    return lambda gout, grid: SplatO.apply(gout, grid, tuple(in_spatial),
                                           cfg, tuple(orders))


def _validate(input, grid, cfg: SamplerConfig):
    d = cfg.dim
    if input.ndim != d + 2:
        raise ValueError(
            f"input must be (N, C{', D' if d == 3 else ''}, H, W): got "
            f"{tuple(input.shape)}"
        )
    if grid.ndim != d + 2 or grid.shape[-1] != d:
        raise ValueError(
            f"grid must be (N, {'D_out, ' if d == 3 else ''}H_out, W_out, {d}): "
            f"got {tuple(grid.shape)}"
        )
    if grid.shape[0] not in (1, input.shape[0]):
        raise ValueError(
            f"input and grid must share the cell/batch dim (or grid batch 1 "
            f"for shared queries): {input.shape[0]} vs {grid.shape[0]}"
        )


def sample(input, grid, cfg: SamplerConfig):
    """Differentiable-to-any-order grid sample: (N, C, *out_spatial).

    The semantic equivalent of the reference's CosineSampler2d/3d.apply.
    """
    _validate(input, grid, cfg)
    return BlendO.apply(input, grid, cfg, (0,) * cfg.dim)
