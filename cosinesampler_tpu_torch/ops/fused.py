"""Fused multicell sampling with first and pure second derivatives.

Counterpart of the JAX package's ops/fused.py:

    sample_features_with_derivs(cells, points, cfg)
        -> (1 + 2*dim, C, Q):  [value, jac_x.., hess_xx..]

summed over the multicell ensemble, with derivatives with respect to the
normalized coordinates.  The op is one ``torch.autograd.Function``: its
forward is the fused blend kernel and its backward the fused transpose
kernel (ops/cuda/fused2w.py in 2D, ops/cuda/fused3w.py in 3D), or their
plain versions for CPU tensors and under ``backend="xla"``.

``make_fused_mega`` is the hook of the one-launch train-step gradient
(ops/cuda/mega2w.py) that models/pinn.py's megakernel step calls.

The points cotangent, when the points require grad, is the JAX package's
``_points_cotangent``: order-bumped ``blend_o`` launches through the
recursive autograd pair (ops/sampler.py), so it is differentiable in turn.
"""

from __future__ import annotations

import torch

from .config import SamplerConfig
from .cuda import fused2w, fused3w, mega2w
from .cuda.fused2w import all_orders, plain_fused_blend, plain_fused_bwd
from .sampler import BlendO, bump_orders

__all__ = ["make_fused_mega", "make_sample_plan", "plain_fused_blend",
           "plain_fused_bwd", "sample_features_padded",
           "sample_features_with_derivs"]

# the kernel wrappers of each dim
_KERNELS = {2: fused2w, 3: fused3w}


def _points_cotangent(cells, points, g, cfg: SamplerConfig):
    """(Q, d) points cotangent of the (1+2d, C, Q) cotangent ``g``: for
    each axis, the order-bumped blend of every output row, summed over the
    cells, weighed by that row of ``g`` and summed over the channels."""
    n, c = cells.shape[:2]
    q, dim = points.shape
    grid = points.reshape((1,) * dim + (q, dim))
    lanes = []
    for ax in range(dim):
        acc = 0.0
        for row, o in enumerate(all_orders(dim)):
            term = BlendO.apply(cells, grid, cfg, bump_orders(o, ax))
            acc = acc + (g[row] * term.reshape(n, c, q).sum(dim=0)).sum(dim=0)
        lanes.append(acc)
    return torch.stack(lanes, dim=-1).to(points.dtype)


class _FusedSample(torch.autograd.Function):
    """(cells, points) -> (1+2d, C, Q)."""

    @staticmethod
    def forward(ctx, cells, points, cfg: SamplerConfig):
        ctx.save_for_backward(cells, points)
        ctx.cfg = cfg
        if cfg.backend == "xla":
            return plain_fused_blend(cells, points, cfg)
        return _KERNELS[cfg.dim].fused_blend(cells, points, cfg)

    @staticmethod
    def backward(ctx, g):
        cells, points = ctx.saved_tensors
        cfg = ctx.cfg
        n, _, *spatial = cells.shape
        g = g.contiguous()
        dcells = dpoints = None
        if ctx.needs_input_grad[0]:
            if cfg.backend == "xla":
                dcells = plain_fused_bwd(g, points, tuple(spatial), cfg, n)
            else:
                dcells = _KERNELS[cfg.dim].fused_bwd(g, points,
                                                     tuple(spatial), cfg, n)
            dcells = dcells.to(cells.dtype)
        if ctx.needs_input_grad[1]:
            dpoints = _points_cotangent(cells, points, g, cfg)
        return dcells, dpoints, None


def _check_points(points, cfg: SamplerConfig):
    if points.dim() != 2 or points.shape[-1] != cfg.dim:
        raise ValueError(
            f"points must be (Q, {cfg.dim}): got {tuple(points.shape)}")


def sample_features_with_derivs(cells, points, cfg: SamplerConfig):
    """(1+2*dim, C, Q): multicell-summed value, jacobian, diagonal Hessian.

    ``points``: (Q, dim) normalized coords shared by all cells.
    """
    _check_points(points, cfg)
    return _FusedSample.apply(cells, points, cfg)


def make_sample_plan(points, cells_shape, cfg: SamplerConfig):
    """The bin plan for a fixed point set: None, since the CUDA kernels
    gather directly and need no bins (see ROADMAP queue B)."""
    del cells_shape
    if points.dim() != 2 or points.shape[-1] != cfg.dim:
        raise ValueError(
            f"points must be (Q, {cfg.dim}): got {tuple(points.shape)}")
    return None


def sample_features_padded(cells, points, cfg: SamplerConfig, plan=None):
    """Slot-resident sample_features_with_derivs with the identity slot plan.

    Returns (out_p, occ, positions) as the JAX package does: here QP == Q,
    ``occ`` is all ones and ``positions`` is arange(Q), which is what the
    JAX package returns when no binned kernel routes.
    """
    if plan is not None:
        raise ValueError("the port builds no bin plans (make_sample_plan "
                         "returns None); pass plan=None")
    out = sample_features_with_derivs(cells, points, cfg)
    q = points.shape[0]
    occ = torch.ones((q,), dtype=torch.float32, device=points.device)
    positions = torch.arange(q, dtype=torch.int64, device=points.device)
    return out, occ, positions



def make_fused_mega(cfg: SamplerConfig, cells_shape, n_queries: int,
                    pde: str, hidden: int):
    """The one-launch train-step gradient (ops/cuda/mega2w.py), or None
    when it does not serve this config and shape: a callable
    ``(cells, mlp_params, points, plan=None) -> (loss, grads)`` whose grads
    dict matches pinn.init_params.  ``backend="xla"`` takes no kernel.
    ``n_queries`` is the JAX signature's; the kernel takes any Q."""
    del n_queries
    if cfg.backend == "xla" or not mega2w.supports(cfg, tuple(cells_shape),
                                                   pde, hidden):
        return None

    def run(cells, mlp_params, points, plan=None):
        if plan is not None:
            raise ValueError("the port builds no bin plans (make_sample_plan "
                             "returns None); pass plan=None")
        return mega2w.mega2w_step(cells, mlp_params["w1"], mlp_params["b1"],
                                  mlp_params["w2"], mlp_params["b2"], points,
                                  cfg, pde)

    return run
