"""The v1 fused value/jacobian/diag-Hessian blend and its cells transpose,
in 2D and 3D at any channel count.

Counterpart of the JAX package's ops/pallas/fused.py (``pallas_fused_blend``
/ ``pallas_fused_bwd``): (N, C, *S) cells at (Q, d) shared points ->
(1+2d, C, Q) rows value, d/dx_i, d2/dx_i2 summed over the cells, and the
exact transpose.  The fused op routes here above 8 channels where these
beat fused2w's / fused3w's channel groups (ops/cuda/route.py
``fused_rule``).

* The plain versions are ops/cuda/fused2w.py's ``plain_fused_blend`` /
  ``plain_fused_bwd``, which take any dim and channel count (the JAX
  package's ``xla_fused_blend`` / ``xla_fused_bwd``); they are the oracle
  the kernels are held to.
* ``fused_blend`` / ``fused_bwd`` wrap the hand-written CUDA kernels in
  csrc/fused.cu, with the launch layouts of ops/cuda/v1.py, through the
  launchers fused2w_blend / fused3w_blend and fused2w_bwd / fused3w_bwd
  share.  The blend gathers from a texel-major (*S, N, C) copy of the
  cells (or the cells in place, planar) with a few lanes a query
  (csrc/texel_gather.cuh), each query's rows going to a (Q, 1+2d, C)
  temporary that a tiled transpose writes out as (1+2d, C, Q).  The bwd
  adds into a zeroed texel-major scratch with a warp's lanes over
  (query, cell) (csrc/texel_scatter.cuh), which the tiled transpose
  writes out as (N, C, *S).  The wrapper allocates the temporaries.  A
  tensor on the CPU takes the plain version; a CUDA tensor launches the
  kernel on the current stream, or raises for what the kernel does not
  take.  Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SamplerConfig
from .fused2w import (gather_blend, launch, plain_fused_blend,
                      plain_fused_bwd)
from .fused3b import vol_layout
from .scatter import ScatterGeometry
from .v1 import BlendGeometry, blend_geometry, bwd_geometry

__all__ = ["fused_blend", "fused_bwd", "launch_blend", "launch_bwd",
           "plain_fused_blend", "plain_fused_bwd"]


def launch_blend(cells: torch.Tensor, points: torch.Tensor,
                 cfg: SamplerConfig, geom: BlendGeometry) -> torch.Tensor:
    """fused_blend's kernels with the launch layout ``geom``
    (ops/cuda/v1.py), on the card; not counted."""
    return gather_blend(f"fused_v1_blend{cells.dim() - 2}", cells, points,
                        cfg, geom)


def launch_bwd(g: torch.Tensor, points: torch.Tensor,
               in_spatial: Tuple[int, ...], cfg: SamplerConfig, n_cells: int,
               geom: ScatterGeometry) -> torch.Tensor:
    """fused_bwd's kernels with the scatter layout ``geom``
    (ops/cuda/v1.py), on the card; not counted."""
    dim = len(in_spatial)
    if (dim not in (2, 3) or cfg.dim != dim or g.dim() != 3
            or g.shape[0] != 1 + 2 * dim
            or points.shape != (g.shape[2], dim)):
        raise ValueError(f"the v1 bwd takes a {cfg.dim}D config, g "
                         f"({1 + 2 * dim}, C, Q), points (Q, {dim}) and "
                         f"{dim} sizes; got {tuple(g.shape)}, "
                         f"{tuple(points.shape)} and {tuple(in_spatial)}")
    c = g.shape[1]
    scratch = torch.zeros(vol_layout(n_cells, c, in_spatial),
                          dtype=torch.float32, device=g.device)
    out = torch.empty((n_cells, c, *in_spatial), dtype=torch.float32,
                      device=g.device)
    launch(f"fused_v1_bwd{dim}", g, points, (scratch, out), cfg, n_cells, c,
           tuple(in_spatial), geom.args())
    return out


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig) -> torch.Tensor:
    """(1+2d, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, *S)
    cells at (Q, d) points, any C; kernel on CUDA tensors, plain on CPU
    ones."""
    if cells.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_blend(cells, points, cfg)
    n, c, *spatial = cells.shape
    out = launch_blend(cells, points, cfg,
                       blend_geometry(len(spatial), n, c, points.shape[0],
                                      spatial))
    fused_blend.launches += 1
    return out


def fused_bwd(g: torch.Tensor, points: torch.Tensor,
              in_spatial: Tuple[int, ...], cfg: SamplerConfig,
              n_cells: int) -> torch.Tensor:
    """(N, C, *in_spatial) cells cotangent of fused_blend for the
    (1+2d, C, Q) cotangent ``g``; kernel on CUDA tensors, plain on CPU
    ones."""
    if g.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_bwd(g, points, tuple(in_spatial), cfg, n_cells)
    dcells = launch_bwd(g, points, tuple(in_spatial), cfg, n_cells,
                        bwd_geometry(len(in_spatial), n_cells, g.shape[1]))
    fused_bwd.launches += 1
    return dcells


fused_blend.launches = 0
fused_bwd.launches = 0
