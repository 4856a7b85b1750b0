"""Fused 3D value/jacobian/diag-Hessian blend and its cells transpose.

Counterpart of the JAX package's ops/pallas/fused3w.py: (N, C, D, H, W)
cells at (Q, 3) shared points -> (7, C, Q) rows value, d/dx, d/dy, d/dz,
d2/dx2, d2/dy2, d2/dz2 summed over the cells, and the exact transpose.

* The plain versions are ops/cuda/fused2w.py's ``plain_fused_blend`` /
  ``plain_fused_bwd``, which take any dim; they are the oracle the kernels
  are held to.
* ``fused_blend`` / ``fused_bwd`` wrap the hand-written CUDA kernels in
  csrc/fused3w.cu.  A tensor on the CPU takes the plain version; a CUDA
  tensor launches the kernel on the current stream, or raises for what the
  kernel does not take.  Each wrapper counts its launches in its
  ``launches`` attribute.  The blend is fused2w_blend's gather over a
  texel-major copy of the cells with the layout of ops/cuda/v1.py
  ``blend_geometry``; the bwd's launch layout and its planar bound are
  fused2w_bwd's (ops/cuda/fused2w.py ``bwd_geometry``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SamplerConfig
from .fused2w import blend, bwd, plain_fused_blend, plain_fused_bwd

__all__ = ["fused_blend", "fused_bwd", "plain_fused_blend", "plain_fused_bwd"]


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig) -> torch.Tensor:
    """(7, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, D, H, W)
    cells at (Q, 3) points; kernel on CUDA tensors, plain on CPU ones."""
    if cells.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_blend(cells, points, cfg)
    out = blend(cells, points, cfg)
    fused_blend.launches += 1
    return out


def fused_bwd(g: torch.Tensor, points: torch.Tensor,
              in_spatial: Tuple[int, ...], cfg: SamplerConfig,
              n_cells: int) -> torch.Tensor:
    """(N, C, D, H, W) cells cotangent of fused_blend for the (7, C, Q)
    cotangent ``g``; kernel on CUDA tensors, plain on CPU ones."""
    if g.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_bwd(g, points, tuple(in_spatial), cfg, n_cells)
    dcells = bwd(g, points, tuple(in_spatial), cfg, n_cells)
    fused_bwd.launches += 1
    return dcells


fused_blend.launches = 0
fused_bwd.launches = 0
