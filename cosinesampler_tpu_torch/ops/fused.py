"""Fused multicell sampling with first and pure second derivatives.

Counterpart of the JAX package's ops/fused.py:

    sample_features_with_derivs(cells, points, cfg)
        -> (1 + 2*dim, C, Q):  [value, jac_x.., hess_xx..]

summed over the multicell ensemble, with derivatives with respect to the
normalized coordinates.  The op is one ``torch.autograd.Function``: its
forward is a fused blend kernel and its backward the matching transpose
kernel, on the route ops/cuda/route.py ``fused_rule`` gives the call, in
the JAX package's order: the plain version on the card for what no kernel
takes (f64, strict reference in 2D with align_corners off, tensors over
32-bit indexing, the precisions "bf16" and "fast"); fused2d
(ops/cuda/fused2d.py) for small 2D clouds and fused2w
(ops/cuda/fused2w.py) for the others; in 3D fused3d
(ops/cuda/fused3d.py) for small clouds, fused3s (ops/cuda/fused3s.py)
for many points over large stacks and fused3w (ops/cuda/fused3w.py) for
the others, up to 8 channels; above 8, fused2w's / fused3w's channel
groups or the channel-looped v1 kernels (ops/cuda/fused.py), as
measured.  The wrappers take their plain versions for
CPU tensors; ``backend="xla"`` takes them everywhere.

``make_fused_mega`` is the hook of the one-launch train-step gradient
(ops/cuda/mega2w.py) that models/pinn.py's megakernel step calls.

The slot-resident forms: ``sample_features_padded`` returns the rows in a
bin-slot layout with its occupancy mask and each query's slot.  Without a
plan the layout is the identity.  With a brick plan (``make_sample_plan``
/ ``make_vol_plan``, ops/cuda/fused3b.py) it is the planned op: the cells
are permuted into the bricked kernels' layout on every call and sampled
through ``fused3b_blend_vol``.  ``make_fused_vol`` gives the same op over a
volume kept in that layout (the vol-resident trainer).  A CUDA call at a
precision the kernels do not compute takes the plain route there too
(ops/cuda/route.py ``vol_rule``), in the same slot and volume layouts.

The points cotangent, when the points require grad, is the JAX package's
``_points_cotangent``: order-bumped ``blend_o`` launches through the
recursive autograd pair (ops/sampler.py), so it is differentiable in turn.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .config import SamplerConfig
from .cuda import fused as fused_v1
from .cuda import (fused2d, fused2w, fused3b, fused3d, fused3s, fused3w,
                   mega2w, route)
from .cuda.fused2w import all_orders, plain_fused_blend, plain_fused_bwd
from .sampler import BlendO, bump_orders

__all__ = ["make_fused_mega", "make_fused_vol", "make_sample_plan",
           "make_vol_plan", "plain_fused_blend", "plain_fused_bwd",
           "sample_features_padded", "sample_features_with_derivs",
           "trim_plan"]

# the kernel wrappers of each route of route.fused_rule but "plain"
_KERNELS = {"fused2w": fused2w, "fused2d": fused2d, "fused3w": fused3w,
            "fused3d": fused3d, "fused3s": fused3s, "fused": fused_v1}


def _route(cfg: SamplerConfig, cells_shape, first, points) -> str:
    """route.pick_fused for one call; "xla" under ``backend="xla"``."""
    if cfg.backend == "xla":
        return "xla"
    return route.pick_fused(cfg, tuple(cells_shape), first, points)


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
        # the bwd takes the blend's route
        ctx.route = _route(cfg, cells.shape, cells, points)
        ctx.extra = ()
        if ctx.route == "xla":
            return plain_fused_blend(cells, points, cfg)
        if ctx.route == "plain":
            return route.run_plain(plain_fused_blend, cells, points, cfg)
        if ctx.route == "fused3s" and points.is_cuda:
            # one z sort serves the blend and its transpose
            ctx.extra = (fused3s.zsort(points, cells.shape[2], cfg),)
        return _KERNELS[ctx.route].fused_blend(cells, points, cfg,
                                               *ctx.extra)

    @staticmethod
    def backward(ctx, g):
        cells, points = ctx.saved_tensors
        cfg = ctx.cfg
        n, _, *spatial = cells.shape
        spatial = tuple(spatial)
        g = g.contiguous()
        dcells = dpoints = None
        if ctx.needs_input_grad[0]:
            if ctx.route == "xla":
                dcells = plain_fused_bwd(g, points, spatial, cfg, n)
            elif ctx.route == "plain":
                dcells = route.run_plain(plain_fused_bwd, g, points, spatial,
                                         cfg, n)
            else:
                dcells = _KERNELS[ctx.route].fused_bwd(g, points, spatial,
                                                       cfg, n, *ctx.extra)
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


class _FusedVol(torch.autograd.Function):
    """(vol, points) -> (7, C, QP) in the slot order of ``plan``, over a
    kernel-layout (D, H, W, N, C) volume."""

    @staticmethod
    def forward(ctx, vol, points, plan, cfg: SamplerConfig):
        ctx.save_for_backward(vol, points)
        ctx.plan, ctx.cfg = plan, cfg
        # the bwd takes the blend's route
        ctx.plain = route.vol_rule(cfg, vol.device.type) == "plain"
        if ctx.plain:
            return route.run_plain(fused3b.plain_fused3b_blend_vol, vol,
                                   plan, cfg)
        return fused3b.fused3b_blend_vol(vol, plan, cfg)

    @staticmethod
    def backward(ctx, g_p):
        vol, points = ctx.saved_tensors
        plan, cfg = ctx.plan, ctx.cfg
        d, h, w, n, c = vol.shape
        g_p = g_p.contiguous()
        dvol = dpoints = None
        if ctx.needs_input_grad[0]:
            bwd = (functools.partial(route.run_plain,
                                     fused3b.plain_fused3b_bwd_vol)
                   if ctx.plain else fused3b.fused3b_bwd_vol)
            dvol = bwd(g_p, plan, (d, h, w), cfg, n).to(vol.dtype)
        if ctx.needs_input_grad[1]:
            # the slot cotangent gathered back to query order
            g_q = g_p.reshape(-1, g_p.shape[-1])[:, plan[0]].reshape(
                g_p.shape[0], c, points.shape[0])
            dpoints = _points_cotangent(fused3b.vol_to_cells(vol), points,
                                        g_q, cfg)
        return dvol, dpoints, None, None


def _check_plan(plan, points):
    if len(plan) != 6:
        raise ValueError(
            "a bin plan is the 6-tuple (positions, occ, z0, y0, hasv, pts_p) "
            f"of make_sample_plan / make_vol_plan; got {len(plan)} arrays")
    if plan[0].shape[0] != points.shape[0]:
        raise ValueError(
            f"plan was built for {plan[0].shape[0]} points; "
            f"got {points.shape[0]} (plans are point-set-specific)")


def make_fused_vol(cfg: SamplerConfig, n_cells: int, channels: int,
                   in_spatial: Tuple[int, ...], n_queries: int):
    """The kernel-layout (vol-resident) fused op, or None where the bricked
    kernels do not take the config and shape (fused3b.supports: 2D, fewer
    than 2 queries per bin) or under ``backend="xla"``.

    Returns ``(fused_vol, to_vol, from_vol)``: ``to_vol`` / ``from_vol``
    convert between the (N, C, D, H, W) cells and the (D, H, W, N, C)
    kernel layout (a permutation, no pad slots), and ``fused_vol(vol,
    points, plan) -> (out_p, occ, positions)`` is the slot-resident fused
    op over the kernel layout for a plan of make_vol_plan.  Its backward
    gives the volume cotangent in the kernel layout and, where the points
    require grad, their cotangent.  An optimizer can run on the volume
    itself.
    """
    shape = (n_cells, channels, *in_spatial)
    if cfg.backend == "xla" or not fused3b.supports(cfg, shape, n_queries):
        return None

    def fused_vol(vol, points, plan):
        _check_points(points, cfg)
        _check_plan(plan, points)
        return _FusedVol.apply(vol, points, plan, cfg), plan[1], plan[0]

    return fused_vol, fused3b.cells_to_vol, fused3b.vol_to_cells


def trim_plan(plan, block_bucket: Optional[int] = None):
    """Cut a bin plan to its used block prefix.

    The plan's slot count is a static bound, every bin padded to whole
    blocks (cdiv(Q, q_block) + nbins blocks); real blocks come first and
    the tail blocks hold no query.  The used length rounds up to
    ``block_bucket`` blocks (default 1/16 of the bound), so that a plan
    for another point set of the same size usually gets the same shapes
    (the JAX package's trim_plan, whose jitted kernels compile per shape).
    """
    if plan is None:
        return None
    occ, hasv = plan[1], plan[-2]
    nb_total = hasv.shape[0]
    real = torch.nonzero(hasv)
    nb = int(real.max()) + 1 if real.numel() else 1
    bucket = block_bucket or max(1, nb_total // 16)
    nb = min(-(-nb // bucket) * bucket, nb_total)
    if nb == nb_total:
        return plan
    qp = occ.shape[0]
    qp_used = nb * (qp // nb_total)
    return tuple([plan[0]] + [a[:qp_used] if a.shape[0] == qp else a[:nb]
                              for a in plan[1:]])


def make_vol_plan(points, cells_shape, cfg: SamplerConfig):
    """The trimmed brick plan (fused3b.make_plan) of a fixed point set for
    (N, C, D, H, W) cells: the plan of make_fused_vol's op, for every
    shape the bricked kernels take."""
    if points.dim() != 2 or points.shape[-1] != 3:
        raise ValueError(
            f"points must be (Q, 3): got {tuple(points.shape)}")
    return trim_plan(fused3b.make_plan(points, tuple(cells_shape[2:]), cfg))


def make_sample_plan(points, cells_shape, cfg: SamplerConfig):
    """The bin plan for a fixed point set, or None.

    Every 3D shape the bricked kernels take gets its brick plan
    (make_vol_plan); with it, sample_features_padded samples through
    fused3b, whose sorted gathers beat the query-ordered fused3w at every
    size measured, and the v1 pair at C = 16 (PERF.md section 4).  Every
    other shape gets None and the unplanned kernels, which gather in
    query order.
    """
    _check_points(points, cfg)
    n, c = cells_shape[:2]
    if make_fused_vol(cfg, n, c, tuple(cells_shape[2:]),
                      points.shape[0]) is None:
        return None
    return make_vol_plan(points, cells_shape, cfg)


def sample_features_padded(cells, points, cfg: SamplerConfig, plan=None):
    """Slot-resident sample_features_with_derivs: (out_p, occ, positions).

    ``out_p`` is (1+2d, C, QP) in slot order with ``out_p[:, :, positions]``
    equal to sample_features_with_derivs and zeros in pad slots, ``occ``
    the (QP,) real-slot mask and ``positions`` the (Q,) slot of each
    query.  Without a plan the layout is the identity (QP == Q, ``occ``
    all ones, ``positions`` arange(Q)).  With a plan from make_sample_plan
    it is the planned op: the cells go to the kernel layout on every call
    and through fused3b (make_fused_vol).  Where no bricked kernel takes
    the config (``backend="xla"``), the query-ordered rows are placed in
    the plan's slots, as the JAX package does.
    """
    _check_points(points, cfg)
    if plan is None:
        out = sample_features_with_derivs(cells, points, cfg)
        q = points.shape[0]
        occ = torch.ones((q,), dtype=torch.float32, device=points.device)
        positions = torch.arange(q, dtype=torch.int64, device=points.device)
        return out, occ, positions
    _check_plan(plan, points)
    n, c, *spatial = cells.shape
    ops = make_fused_vol(cfg, n, c, tuple(spatial), points.shape[0])
    if ops is None:
        positions, occ = plan[0], plan[1]
        out = sample_features_with_derivs(cells, points, cfg)
        out_p = out.new_zeros((*out.shape[:2], occ.shape[0]))
        out_p[:, :, positions] = out
        return out_p, occ, positions
    fused_vol, to_vol, _ = ops
    return fused_vol(to_vol(cells), points, plan)


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
            raise ValueError("the megakernel takes no bin plan (the port's "
                             "plans are 3D brick plans); pass plan=None")
        return mega2w.mega2w_step(cells, mlp_params["w1"], mlp_params["b1"],
                                  mlp_params["w2"], mlp_params["b2"], points,
                                  cfg, pde)

    return run
