"""Fused 2D value/jacobian/diag-Hessian blend and its cells transpose.

Counterpart of the JAX package's ops/pallas/fused2w.py.  Each op has two
versions in this module:

* ``plain_fused_blend`` / ``plain_fused_bwd``: plain PyTorch, one
  generic.blend / generic.splat per output row (the JAX package's
  ``xla_fused_blend`` / ``xla_fused_bwd``), any dim and dtype.  They are
  the oracle the kernels are held to.
* ``fused_blend`` / ``fused_bwd``: the wrappers of the hand-written CUDA
  kernels in csrc/fused2w.cu.  A tensor on the CPU takes the plain
  version; a CUDA tensor launches the kernel on the current stream, or
  raises for what the kernel does not take.  Each wrapper counts its
  launches in its ``launches`` attribute.
* The blend, fused2w_blend here and fused3w_blend in ops/cuda/fused3w.py,
  is csrc/texel_gather.cuh's gather over blocks of 128 queries in order
  from a texel-major (*S, N, C) copy of the cells made by a tiled
  transpose, or below a measured number of points a texel from the cells
  in place (planar), with the launch layout of ops/cuda/v1.py
  ``blend_geometry``, the v1 blend's launcher, its lanes storing the
  rows directly; ``gather_blend`` allocates the copy for all three
  blends.
  chip_smoke.py's ``w_blend_layout_sweep_phase`` times the rule against
  ``v1.blend_alternatives``.
* The bwd, fused2w_bwd here and fused3w_bwd in ops/cuda/fused3w.py, is
  csrc/texel_scatter.cuh's scatter over blocks of 128 queries in order
  into a zeroed texel-major (*S, N, C) scratch, which a tiled transpose
  writes out as (N, C, *S), or below ``PLANAR_POINTS_PER_TEXEL`` points
  a texel straight into the zeroed cotangent (planar), with the launch
  layout of ``bwd_geometry``; ``launch_bwd`` allocates the scratch.
  chip_smoke.py's ``w_bwd_layout_sweep_phase`` times the rule against
  ``bwd_alternatives``.

The launch helpers (``launch``, ``gather_blend``, ``launch_bwd``,
``sampler_args``) serve the 3D wrappers (ops/cuda/fused3w.py), the
small-cloud wrappers (ops/cuda/fused2d.py, ops/cuda/fused3d.py), the v1
wrappers (ops/cuda/fused.py) and mega2w too.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import generic
from ..config import SamplerConfig
from ..coords import offset_lattice
from .build import check, load_kernels
from .scatter import THREADS, ScatterGeometry, scatter_alternatives
from .v1 import BlendGeometry, blend_geometry
from .v1 import bwd_geometry as bwd_lanes

KERNEL_IDS = {"cosine": 0, "linear": 1, "smoothstep": 2}
PADDING_IDS = {"zeros": 0, "border": 1, "reflection": 2}
# points per texel of a cell below which fused2w_bwd / fused3w_bwd add
# into the cells cotangent in place (planar) rather than through the
# texel-major scratch, by dimension (chip_smoke.py
# w_bwd_layout_sweep_phase, C = 4, PERF.md section 6): over the L2, on
# 16 x 4 x 128^3 planar won up to 16 384 points (0.0078 a texel; 0.53
# against 0.62 ms) and lost from 20 480 on (0.0098; 0.67 against 0.63);
# on 16 x 4 x 1024^2 it won up to 16 384 (0.0156; 0.27 against 0.31),
# tied at 20 480 and 24 576 (0.0195, 0.0234) and lost from 28 672 on
# (0.0273; 0.42 against 0.33).  In the L2 the scratch costs a few µs:
# on the main paths' stacks planar lost from 0.0625 a texel on, on the
# large cells (2 x 4 x 128^2, 2 x 4 x 32^3, calls of 0.05-0.15 ms with
# the host's share) the faster destination changed from call to call,
# which the bound gives up.
PLANAR_POINTS_PER_TEXEL = {2: 0.02, 3: 0.009}


def all_orders(dim: int):
    """Output row order: value, jac_x.., hess_xx.. (1 + 2*dim rows)."""
    value = (0,) * dim
    jac = [tuple(1 if i == ax else 0 for i in range(dim)) for ax in range(dim)]
    hess = [tuple(2 if i == ax else 0 for i in range(dim)) for ax in range(dim)]
    return [value] + jac + hess


def _points_to_grid(points):
    """(Q, d) shared points -> (1, 1.., Q, d) grid broadcast over the cells."""
    q, dim = points.shape
    return points.reshape((1,) * dim + (q, dim))


def plain_fused_blend(cells, points, cfg: SamplerConfig):
    """(1+2d, C, Q): one generic.blend per row, summed over the cells."""
    n, c = cells.shape[:2]
    q = points.shape[0]
    grid = _points_to_grid(points)
    return torch.stack([
        generic.blend(cells, grid, cfg, o).reshape(n, c, q).sum(dim=0)
        for o in all_orders(cfg.dim)])


def plain_fused_bwd(g, points, in_spatial: Tuple[int, ...],
                    cfg: SamplerConfig, n_cells: int):
    """(N, C, *in_spatial) cells cotangent: one generic.splat per row."""
    c, q = g.shape[1:]
    grid = _points_to_grid(points)
    total = None
    for row, o in enumerate(all_orders(cfg.dim)):
        gb = g[row][None].expand(n_cells, c, q)
        part = generic.splat(gb, grid, in_spatial, cfg, o)
        total = part if total is None else total + part
    return total


def check_kernel_inputs(cfg: SamplerConfig, *tensors: torch.Tensor) -> None:
    """Raise for what the fused and mega2w CUDA kernels do not take
    (device and shapes aside)."""
    if cfg.precision in ("bf16", "fast"):
        raise NotImplementedError(
            f"precision={cfg.precision!r} has no CUDA kernel yet; the "
            "kernels compute in f32 ('exact' / 'highest')")
    if cfg.strict_reference and cfg.dim == 2 and not cfg.align_corners:
        raise NotImplementedError(
            "strict_reference with align_corners=False mixes per-row "
            "alignment, which the single-pass kernels cannot; use "
            "backend='xla'")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError("tensor too large for the kernels' 32-bit indexing")


def cuda_device(*tensors: torch.Tensor) -> torch.device:
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            "tensors must all be on the CPU (plain version) or all on one "
            f"CUDA device, got {[str(t.device) for t in tensors]}")
    return device


def sampler_args(cfg: SamplerConfig, n: int, device: torch.device):
    """The config flags, the offset lattice and the stream: the trailing
    arguments of every fused and mega2w C entry point."""
    step, stop = offset_lattice(n, cfg.multicell)
    return (KERNEL_IDS[cfg.kernel], PADDING_IDS[cfg.padding_mode],
            int(cfg.align_corners), int(cfg.multicell),
            int(cfg.strict_reference), float(step), float(stop),
            torch.cuda.current_stream(device).cuda_stream)


def launch(entry: str, first: torch.Tensor, points: torch.Tensor, outs,
           cfg: SamplerConfig, n: int, c: int, spatial: Tuple[int, ...],
           layout=()) -> None:
    """Launch the C entry point ``entry`` on ``first`` (cells or g), the
    points and the tensors ``outs`` (temporaries, then the output), with
    N, C, the sizes, Q, the launch layout's integers ``layout`` and the
    sampler arguments."""
    cuda_device(first, points, *outs)
    check_kernel_inputs(cfg, first, points, *outs)
    if n * c * math.prod(spatial) >= 2**31:
        raise ValueError("cell stack too large for the kernels' 32-bit "
                         "indexing")
    lib = load_kernels()
    with torch.cuda.device(first.device):
        err = getattr(lib, entry)(
            first.data_ptr(), points.data_ptr(),
            *(t.data_ptr() for t in outs), n, c, *spatial, points.shape[0],
            *layout, *sampler_args(cfg, n, first.device))
    check(lib, err, f"{entry} launch")


def _check_bwd_args(entry: str, dim: int, g: torch.Tensor,
                    points: torch.Tensor, in_spatial: Tuple[int, ...],
                    cfg: SamplerConfig) -> torch.device:
    """The device of a fused transpose kernel's CUDA inputs; raises for
    what ``entry`` of dimension ``dim`` does not take."""
    device = cuda_device(g, points)
    check_kernel_inputs(cfg, g, points)
    if (cfg.dim != dim or g.dim() != 3 or g.shape[0] != 1 + 2 * dim
            or points.dim() != 2 or points.shape != (g.shape[2], dim)
            or len(in_spatial) != dim):
        raise ValueError(
            f"{entry} takes a {dim}D config, g ({1 + 2 * dim}, C, Q), "
            f"points (Q, {dim}) and {dim} spatial sizes; got dim {cfg.dim}, "
            f"{tuple(g.shape)}, {tuple(points.shape)} and "
            f"{tuple(in_spatial)}")
    return device


class BwdGeometry(NamedTuple):
    """One fused2w_bwd / fused3w_bwd launch: the scatter's ``lanes``
    (scatter.py's ScatterGeometry: width, block groups, lane groups,
    lanes, threads) into the texel-major scratch or, where ``planar``,
    into the cells cotangent in place."""
    lanes: ScatterGeometry
    planar: bool = False

    def args(self):
        """The layout as the C entry points take it: width, block groups,
        lane groups, lanes, threads, planar."""
        return (*self.lanes.args(), int(self.planar))


def bwd_geometry(dim: int, n: int, c: int, q: int, spatial) -> BwdGeometry:
    """The bwd's layout for N cells of C channels over ``spatial`` at Q
    points in query order: bwd_lanes's, planar below
    PLANAR_POINTS_PER_TEXEL[dim] points a texel of a cell (where the
    scratch, zeroed and transposed whatever Q, costs more than the
    sectors its records save)."""
    return BwdGeometry(bwd_lanes(dim, n, c),
                       q < PLANAR_POINTS_PER_TEXEL[dim] * math.prod(spatial))


def bwd_alternatives(dim: int, n: int, c: int, q: int, spatial):
    """The layouts chip_smoke.py's sweep times against bwd_geometry's, by
    name: the rule through the other destination (planar or the scratch,
    whichever it does not take), the rule with the other block size, and
    each of scatter.scatter_alternatives for dense blocks; layouts equal
    to the rule's are left out."""
    rule = bwd_geometry(dim, n, c, q, spatial)
    other = "texel-major scratch" if rule.planar else "planar"
    threads = 3 * THREADS - rule.lanes.threads
    alts = {"rule": rule, other: rule._replace(planar=not rule.planar),
            f"{threads} threads": rule._replace(
                lanes=rule.lanes._replace(threads=threads))}
    for name, lanes in scatter_alternatives(n, c, dense=True,
                                            dim=dim).items():
        alts[f"scatter: {name}"] = BwdGeometry(lanes, rule.planar)
    out = {}
    for name, geom in alts.items():
        if name == "rule" or geom not in out.values():
            out[name] = geom
    return out


def launch_bwd(g: torch.Tensor, points: torch.Tensor,
               in_spatial: Tuple[int, ...], cfg: SamplerConfig, n_cells: int,
               geom: BwdGeometry, entry: Optional[str] = None) -> torch.Tensor:
    """fused2w_bwd / fused3w_bwd (by the dimension of ``in_spatial``), or
    the scatter bwd ``entry`` (fused2d_bwd, fused3d_bwd), with the launch
    layout ``geom`` (its ``planar`` and ``args()``), on the card; not
    counted.  The wrapper allocates the zeroed texel-major scratch, or
    where planar zeroes the cotangent instead."""
    dim = len(in_spatial)
    entry = entry or f"fused{dim}w_bwd"
    device = _check_bwd_args(entry, dim, g, points, in_spatial, cfg)
    c = g.shape[1]
    shape = (n_cells, c, *in_spatial)
    if geom.planar:
        scratch = dcells = torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    else:
        scratch = torch.zeros((*in_spatial, n_cells, c), dtype=torch.float32,
                              device=device)
        dcells = torch.empty(shape, dtype=torch.float32, device=device)
    launch(entry, g, points, (scratch, dcells), cfg, n_cells, c,
           tuple(in_spatial), geom.args())
    return dcells


def gather_blend(entry: str, cells: torch.Tensor, points: torch.Tensor,
                 cfg: SamplerConfig, geom: BlendGeometry) -> torch.Tensor:
    """(1+2d, C, Q) from the gather blend ``entry`` (fused2w_blend,
    fused3w_blend, fused_v1_blend2 / 3, fused2d_blend, fused3d_blend:
    csrc/fused.cu fused_gather_blend) with the launch layout ``geom``
    (ops/cuda/v1.py, ops/cuda/small_cloud.py: its ``planar`` and
    ``args()``), on CUDA tensors; not counted.  The wrapper allocates the
    texel-major (*S, N, C) copy, where the layout is not planar."""
    n, c, *spatial = cells.shape
    dim, q = len(spatial), points.shape[0]
    if dim not in (2, 3) or cfg.dim != dim or points.shape[1:] != (dim,):
        raise ValueError(f"{entry} takes a {cfg.dim}D config, cells (N, C, "
                         f"*S) and points (Q, {cfg.dim}); got "
                         f"{tuple(cells.shape)} and {tuple(points.shape)}")
    vol = (cells if geom.planar else
           torch.empty((*spatial, n, c), dtype=torch.float32,
                       device=cells.device))
    out = torch.empty((1 + 2 * dim, c, q), dtype=torch.float32,
                      device=cells.device)
    launch(entry, cells, points, (vol, out), cfg, n, c, tuple(spatial),
           geom.args())
    return out


def launch_blend(cells: torch.Tensor, points: torch.Tensor,
                 cfg: SamplerConfig, geom: BlendGeometry) -> torch.Tensor:
    """fused2w_blend / fused3w_blend (by the dimension of the cells) with
    the launch layout ``geom``, on the card; not counted."""
    return gather_blend(f"fused{cells.dim() - 2}w_blend", cells, points,
                        cfg, geom)


def blend(cells: torch.Tensor, points: torch.Tensor,
          cfg: SamplerConfig) -> torch.Tensor:
    """launch_blend with v1.blend_geometry's layout, on the card; not
    counted."""
    n, c, *spatial = cells.shape
    return launch_blend(cells, points, cfg,
                        blend_geometry(len(spatial), n, c, points.shape[0],
                                       spatial))


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig) -> torch.Tensor:
    """(5, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, H, W)
    cells at (Q, 2) points; kernel on CUDA tensors, plain on CPU ones."""
    if cells.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_blend(cells, points, cfg)
    out = blend(cells, points, cfg)
    fused_blend.launches += 1
    return out


def fused_bwd(g: torch.Tensor, points: torch.Tensor,
              in_spatial: Tuple[int, ...], cfg: SamplerConfig,
              n_cells: int) -> torch.Tensor:
    """(N, C, H, W) cells cotangent of fused_blend for the (5, C, Q)
    cotangent ``g``; kernel on CUDA tensors, plain on CPU ones."""
    if g.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_bwd(g, points, tuple(in_spatial), cfg, n_cells)
    dcells = bwd(g, points, tuple(in_spatial), cfg, n_cells)
    fused_bwd.launches += 1
    return dcells


def bwd(g: torch.Tensor, points: torch.Tensor, in_spatial: Tuple[int, ...],
        cfg: SamplerConfig, n_cells: int) -> torch.Tensor:
    """launch_bwd with bwd_geometry's layout (fused2w_bwd or fused3w_bwd
    by the dimension of ``in_spatial``), on the card; not counted."""
    return launch_bwd(g, points, in_spatial, cfg, n_cells,
                      bwd_geometry(len(in_spatial), n_cells, g.shape[1],
                                   points.shape[0], in_spatial))


fused_blend.launches = 0
fused_bwd.launches = 0
