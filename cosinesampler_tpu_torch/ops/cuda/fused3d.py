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
  csrc/fused3d.cu: fused3w's gather and scatter (csrc/texel_gather.cuh,
  csrc/texel_scatter.cuh, through csrc/fused.cu's launchers) in blocks of
  a few queries, a warp's lanes over one query's cells, so that a cloud
  of a few hundred points fills the card where fused3w's blocks of 128
  queries fill a few SMs.  ``geometry`` is the host's layout of both
  launches, ops/cuda/small_cloud.py's rule (shared with fused2d) with
  this module's measured planar bounds (``RULE``); chip_smoke.py's
  ``fused3d_layout_sweep_phase`` times it against ``blend_alternatives``
  / ``bwd_alternatives``.  A tensor on the CPU takes the plain version; a
  CUDA tensor launches the kernel on the current stream, or raises for
  what the kernel does not take (``supports``).  Each wrapper counts its
  launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SamplerConfig
from . import fused2w
from .fused2w import gather_blend, plain_fused_blend, plain_fused_bwd
from .small_cloud import (CELL_LANES, THREADS, BlendLayout, BwdLayout,
                          Geometry, Rule)

__all__ = ["CELL_LANES", "RULE", "THREADS", "BlendLayout", "BwdLayout",
           "Geometry", "blend_alternatives", "bwd_alternatives",
           "fused_blend", "fused_bwd", "geometry", "launch_blend",
           "launch_bwd", "plain_fused_blend", "plain_fused_bwd", "supports"]

# the blend reads the cells in place (planar) where it reads fewer cell
# values (N x Q x C) than PLANAR_POINTS_PER_TEXEL times the stack's plus
# PLANAR_VALUES, the texel-major copy otherwise; the bwd adds into the
# cotangent in place where it adds fewer (N x Q x C, each at 8 corners)
# than BWD_PLANAR_POINTS_PER_TEXEL times the stack's plus
# BWD_PLANAR_VALUES, into the zeroed texel-major scratch and the tiled
# transpose otherwise.  By device ms on the H100 80GB HBM3 at 700 W
# (chip_smoke.py fused3d_layout_sweep_phase, PERF.md section 6): the
# copy's and the scratch's passes over the stack cost little in the L2,
# where a warp's 32 lanes reading or adding one query's cells in 32
# planes take a sector each; at path (c) (50 x 4 x 16^3, 1 024 points,
# 205 k values) the blend tied (0.0123 against 0.0119 ms: planar, a
# launch fewer) and the bwd's scratch won (0.0118 against 0.0245); on
# 16 x 4 x 32^3 the copy lost at 2 048 points (0.0098 against 0.0122)
# and won at 4 096 (0.0129 against 0.0196); over the L2 (16 x 4 x 128^3)
# in place won up to 32 768 points (blend; the copy from 65 536) and
# 16 384 (bwd; the scratch from 32 768).  With the host in, its 60-130 us
# to enqueue a call hide these, and the faster read flips between calls.
PLANAR_POINTS_PER_TEXEL = 1 / 64
PLANAR_VALUES = 3 << 16
BWD_PLANAR_POINTS_PER_TEXEL = 1 / 128
BWD_PLANAR_VALUES = 1 << 16
RULE = Rule(PLANAR_POINTS_PER_TEXEL, PLANAR_VALUES,
            BWD_PLANAR_POINTS_PER_TEXEL, BWD_PLANAR_VALUES)
blend_layout = RULE.blend_layout
bwd_layout = RULE.bwd_layout
geometry = RULE.geometry
blend_alternatives = RULE.blend_alternatives
bwd_alternatives = RULE.bwd_alternatives


def supports(cfg: SamplerConfig, cells_shape) -> bool:
    """3D cells (N, C, D, H, W), every padding mode; any size and channel
    count (the 32-bit indexing aside, which the launch checks)."""
    return cfg.dim == 3 and len(cells_shape) == 5


def _check(cfg: SamplerConfig, cells_shape) -> None:
    if not supports(cfg, cells_shape):
        raise ValueError(
            f"fused3d takes a 3D config and cells (N, C, D, H, W); got dim "
            f"{cfg.dim} and cells {tuple(cells_shape)}")


def launch_blend(cells: torch.Tensor, points: torch.Tensor,
                 cfg: SamplerConfig, lay: BlendLayout) -> torch.Tensor:
    """fused3d_blend with the layout ``lay``, on the card; not counted."""
    _check(cfg, tuple(cells.shape))
    return gather_blend("fused3d_blend", cells, points, cfg, lay)


def launch_bwd(g: torch.Tensor, points: torch.Tensor,
               in_spatial: Tuple[int, ...], cfg: SamplerConfig, n_cells: int,
               lay: BwdLayout) -> torch.Tensor:
    """fused3d_bwd with the layout ``lay``, on the card; not counted."""
    _check(cfg, (n_cells, *g.shape[1:2], *in_spatial))
    return fused2w.launch_bwd(g, points, tuple(in_spatial), cfg, n_cells,
                              lay, entry="fused3d_bwd")


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig) -> torch.Tensor:
    """(7, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, D, H, W)
    cells at (Q, 3) points; kernel on CUDA tensors, plain on CPU ones."""
    if cells.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_blend(cells, points, cfg)
    n, c, *spatial = cells.shape
    out = launch_blend(cells, points, cfg,
                       blend_layout(n, c, points.shape[0], spatial))
    fused_blend.launches += 1
    return out


def fused_bwd(g: torch.Tensor, points: torch.Tensor,
              in_spatial: Tuple[int, ...], cfg: SamplerConfig,
              n_cells: int) -> torch.Tensor:
    """(N, C, D, H, W) cells cotangent of fused_blend for the (7, C, Q)
    cotangent ``g``; kernel on CUDA tensors, plain on CPU ones."""
    if g.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_bwd(g, points, tuple(in_spatial), cfg, n_cells)
    dcells = launch_bwd(
        g, points, in_spatial, cfg, n_cells,
        bwd_layout(n_cells, g.shape[1], points.shape[0], in_spatial))
    fused_bwd.launches += 1
    return dcells


fused_blend.launches = 0
fused_bwd.launches = 0
