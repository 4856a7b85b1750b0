"""Plain PyTorch blend/splat: the oracle the CUDA kernels are held to.

Counterpart of the JAX package's ops/generic.py.

* ``blend(input, grid, cfg, orders)`` gathers the 2^d corners of every query
  and weighs them by the interpolant's derivative of order ``orders[i]``
  along grid axis i (the chain multiplier ``mult**k`` folded in).  Zeros
  padding drops out-of-bounds corners.  A grid with batch 1 is a query
  cloud shared by all cells.
* ``splat(gout, grid, in_spatial, cfg, orders)`` is its exact transpose
  with respect to ``input``: the same corner weights scattered with
  ``index_add_``.

Grid coordinate axis i addresses input spatial axis d-1-i (x -> W, y -> H,
z -> D), as in torch.grid_sample.
"""

from __future__ import annotations

import itertools
import math
from typing import Tuple

import torch

from .config import SamplerConfig, effective_align
from .coords import compute_source_coords, multicell_offsets
from .interpolants import corner_weights


def _per_axis_tables(grid_flat, spatial, cfg: SamplerConfig, orders, n_cells,
                     fwd_quirk=False):
    """Per-grid-axis (corner floor index, corner weights, axis size)."""
    d = cfg.dim
    offset = multicell_offsets(n_cells, cfg.multicell, grid_flat.dtype,
                               grid_flat.device)[:, None]
    # the strict-mode 2D forward align hardcode applies to the order-0
    # gather only; the splat honours the real flag
    align = effective_align(cfg, orders) if fwd_quirk else cfg.align_corners
    tables = []
    for i in range(d):
        size = spatial[d - 1 - i]
        x, mult = compute_source_coords(
            grid_flat[..., i], size, cfg.padding_mode, align,
            cfg.multicell, offset, strict=cfg.strict_reference)
        fx = torch.floor(x)
        w0, w1 = corner_weights(cfg.kernel, x - fx, orders[i])
        if orders[i] > 0:
            scale = mult ** orders[i]
            w0 = w0 * scale
            w1 = w1 * scale
        tables.append((fx.to(torch.int64), (w0, w1), size))
    return tables


def _corner_index_weight(tables, corner, spatial, d):
    """Flat input index, blended weight and in-bounds mask for one corner."""
    idx = wgt = ok = None
    for i, p in enumerate(corner):
        fx, (w0, w1), size = tables[i]
        ci = fx + p
        axis = d - 1 - i
        term = ci * math.prod(spatial[axis + 1:])
        good = (ci >= 0) & (ci < size)
        w = w1 if p else w0
        idx = term if idx is None else idx + term
        wgt = w if wgt is None else wgt * w
        ok = good if ok is None else ok & good
    return idx, wgt, ok


def blend(input, grid, cfg: SamplerConfig, orders: Tuple[int, ...]):
    """Gather-and-weigh; output (N, C, *out_spatial)."""
    d = cfg.dim
    n, c = input.shape[:2]
    spatial = tuple(input.shape[2:])
    out_spatial = tuple(grid.shape[1:-1])
    q = math.prod(out_spatial)
    gf = grid.reshape(grid.shape[0], q, d)
    tables = _per_axis_tables(gf, spatial, cfg, orders, n, fwd_quirk=True)
    inp = input.reshape(n, c, -1)
    total = math.prod(spatial)
    out = torch.zeros((n, c, q), dtype=input.dtype, device=input.device)
    for corner in itertools.product((0, 1), repeat=d):
        idx, wgt, ok = _corner_index_weight(tables, corner, spatial, d)
        safe = idx.clamp(0, total - 1).expand(n, q)
        vals = torch.gather(inp, 2, safe[:, None, :].expand(n, c, q))
        out = out + torch.where(ok[:, None, :], wgt[:, None, :] * vals, 0.0)
    return out.reshape(n, c, *out_spatial)


def splat(gout, grid, in_spatial: Tuple[int, ...], cfg: SamplerConfig,
          orders: Tuple[int, ...]):
    """Linear transpose of ``blend`` w.r.t. ``input``; (N, C, *in_spatial)."""
    d = cfg.dim
    in_spatial = tuple(in_spatial)
    n, c = gout.shape[:2]
    q = math.prod(gout.shape[2:])
    gf = grid.reshape(grid.shape[0], q, d)
    gq = gout.reshape(n, c, q)
    tables = _per_axis_tables(gf, in_spatial, cfg, orders, n)
    total = math.prod(in_spatial)
    # flat destination (cell, channel, texel) of every corner contribution
    base = (torch.arange(n * c, device=gout.device) * total).reshape(n, c, 1)
    acc = torch.zeros((n * c * total,), dtype=gout.dtype, device=gout.device)
    for corner in itertools.product((0, 1), repeat=d):
        idx, wgt, ok = _corner_index_weight(tables, corner, in_spatial, d)
        safe = idx.clamp(0, total - 1).expand(n, q)
        contrib = torch.where(ok[:, None, :], wgt[:, None, :] * gq, 0.0)
        acc.index_add_(0, (base + safe[:, None, :]).reshape(-1),
                       contrib.reshape(-1))
    return acc.reshape(n, c, *in_spatial)
