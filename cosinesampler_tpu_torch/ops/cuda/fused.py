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
  csrc/fused.cu.  A tensor on the CPU takes the plain version; a CUDA
  tensor launches the kernel on the current stream, or raises for what the
  kernel does not take.  Each wrapper counts its launches in its
  ``launches`` attribute.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SamplerConfig
from .fused2w import (kernel_blend, kernel_bwd, plain_fused_blend,
                      plain_fused_bwd)

__all__ = ["fused_blend", "fused_bwd", "plain_fused_blend", "plain_fused_bwd"]


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig) -> torch.Tensor:
    """(1+2d, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, *S)
    cells at (Q, d) points, any C; kernel on CUDA tensors, plain on CPU
    ones."""
    if cells.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_blend(cells, points, cfg)
    out = kernel_blend(f"fused_v1_blend{cfg.dim}", cfg.dim, cells, points,
                       cfg)
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
    dcells = kernel_bwd(f"fused_v1_bwd{cfg.dim}", cfg.dim, g, points,
                        tuple(in_spatial), cfg, n_cells)
    fused_bwd.launches += 1
    return dcells


fused_blend.launches = 0
fused_bwd.launches = 0
