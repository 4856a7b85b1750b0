"""The small-cloud fused 3D blend and its cells transpose.

Counterpart of the JAX package's ops/pallas/fused3d.py
(``pallas_fused3_blend`` / ``pallas_fused3_bwd``), the JAX route of the 3D
fused op for stacks within VMEM at point clouds too small for its other
generations: (N, C, D, H, W) cells at (Q, 3) shared points -> (7, C, Q)
rows value, d/dx, d/dy, d/dz, d2/dx2, d2/dy2, d2/dz2 summed over the
cells, and the exact transpose.  On the card the fused op routes here by
a measured rule (ops/cuda/route.py ``fused_rule``, PERF.md section 4).

* The plain versions are ops/cuda/fused2w.py's ``plain_fused_blend`` /
  ``plain_fused_bwd``, the same function; they are the oracle the kernels
  are held to.
* ``fused_blend`` / ``fused_bwd`` wrap the hand-written CUDA kernels in
  csrc/fused3d.cu (their body is csrc/staged_cells.cuh, shared with
  fused2d), which serve each block's queries from a chunk of cells staged
  in shared memory.  A tensor on the CPU takes the plain version; a CUDA
  tensor launches the kernel on the current stream, or raises for what
  the kernel does not take (``supports``).  Each wrapper counts its
  launches in its ``launches`` attribute.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import SamplerConfig
from .build import BLOCK_SMEM_BYTES
from .fused2d import group_width
from .fused2w import (kernel_blend, kernel_bwd, plain_fused_blend,
                      plain_fused_bwd)

__all__ = ["fused_blend", "fused_bwd", "plain_fused_blend", "plain_fused_bwd",
           "supports"]


def supports(cfg: SamplerConfig, cells_shape) -> bool:
    """3D cells whose channel group of one cell fits a block's shared
    memory (4 x 16^3 is 64 KB; 4 x 32^3, 512 KB, does not), the rule
    csrc/staged_cells.cuh ``make_plan`` checks against the device's
    limit.  Every padding mode."""
    if cfg.dim != 3 or len(cells_shape) != 5:
        return False
    return (4 * group_width(cells_shape[1]) * math.prod(cells_shape[2:])
            <= BLOCK_SMEM_BYTES)


def _check(cfg: SamplerConfig, cells_shape) -> None:
    if not supports(cfg, cells_shape):
        raise ValueError(
            f"fused3d takes 3D cells whose channel group fits "
            f"{BLOCK_SMEM_BYTES} bytes of shared memory; got dim {cfg.dim} "
            f"and cells {tuple(cells_shape)}")


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig) -> torch.Tensor:
    """(7, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, D, H, W)
    cells at (Q, 3) points; kernel on CUDA tensors, plain on CPU ones."""
    if cells.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_blend(cells, points, cfg)
    _check(cfg, tuple(cells.shape))
    out = kernel_blend("fused3d_blend", 3, cells, points, cfg)
    fused_blend.launches += 1
    return out


def fused_bwd(g: torch.Tensor, points: torch.Tensor,
              in_spatial: Tuple[int, ...], cfg: SamplerConfig,
              n_cells: int) -> torch.Tensor:
    """(N, C, D, H, W) cells cotangent of fused_blend for the (7, C, Q)
    cotangent ``g``; kernel on CUDA tensors, plain on CPU ones."""
    if g.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_bwd(g, points, tuple(in_spatial), cfg, n_cells)
    _check(cfg, (n_cells, *g.shape[1:2], *in_spatial))
    dcells = kernel_bwd("fused3d_bwd", 3, g, points, tuple(in_spatial), cfg,
                        n_cells)
    fused_bwd.launches += 1
    return dcells


fused_blend.launches = 0
fused_bwd.launches = 0
