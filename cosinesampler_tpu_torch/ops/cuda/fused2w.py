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

The launch helpers (``kernel_blend``, ``kernel_bwd``, ``sampler_args``)
serve the 3D wrappers (ops/cuda/fused3w.py), the small-cloud wrappers
(ops/cuda/fused2d.py), the v1 wrappers (ops/cuda/fused.py) and mega2w
too.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import generic
from ..config import SamplerConfig
from ..coords import offset_lattice
from .build import check, load_kernels

KERNEL_IDS = {"cosine": 0, "linear": 1, "smoothstep": 2}
PADDING_IDS = {"zeros": 0, "border": 1, "reflection": 2}


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


def _launch(entry: str, first: torch.Tensor, points: torch.Tensor,
            out: torch.Tensor, cfg: SamplerConfig, n: int, c: int,
            spatial: Tuple[int, ...], q: int, capped: bool) -> None:
    lib = load_kernels()
    if capped and c > lib.fused2w_max_channels():
        raise NotImplementedError(
            f"the CUDA kernels take at most {lib.fused2w_max_channels()} "
            f"channels, got {c}")
    if n * c * math.prod(spatial) >= 2**31:
        raise ValueError("cell stack too large for the kernels' 32-bit "
                         "indexing")
    with torch.cuda.device(out.device):
        err = getattr(lib, entry)(first.data_ptr(), points.data_ptr(),
                                  out.data_ptr(), n, c, *spatial, q,
                                  *sampler_args(cfg, n, out.device))
    check(lib, err, f"{entry} launch")


def kernel_blend(entry: str, dim: int, cells: torch.Tensor,
                 points: torch.Tensor, cfg: SamplerConfig,
                 capped: bool = True) -> torch.Tensor:
    """(1+2d, C, Q) from the fused blend kernel ``entry`` of dimension
    ``dim`` (fused2w_blend, fused3w_blend, fused2d_blend) on CUDA tensors;
    ``capped``: the kernel takes at most fused2w_max_channels channels."""
    device = cuda_device(cells, points)
    check_kernel_inputs(cfg, cells, points)
    if (cfg.dim != dim or cells.dim() != 2 + dim or points.dim() != 2
            or points.shape[1] != dim):
        raise ValueError(
            f"{entry} takes a {dim}D config, cells (N, C, *S) and points "
            f"(Q, {dim}); got dim {cfg.dim}, {tuple(cells.shape)} and "
            f"{tuple(points.shape)}")
    n, c, *spatial = cells.shape
    q = points.shape[0]
    out = torch.empty((1 + 2 * dim, c, q), dtype=torch.float32, device=device)
    _launch(entry, cells, points, out, cfg, n, c, tuple(spatial), q, capped)
    return out


def kernel_bwd(entry: str, dim: int, g: torch.Tensor, points: torch.Tensor,
               in_spatial: Tuple[int, ...], cfg: SamplerConfig,
               n_cells: int, capped: bool = True) -> torch.Tensor:
    """(N, C, *in_spatial) from the fused transpose kernel ``entry`` of
    dimension ``dim`` (fused2w_bwd, fused3w_bwd, fused2d_bwd) on CUDA
    tensors; ``capped`` as for kernel_blend."""
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
    c, q = g.shape[1:]
    dcells = torch.zeros((n_cells, c, *in_spatial), dtype=torch.float32,
                         device=device)
    _launch(entry, g, points, dcells, cfg, n_cells, c, tuple(in_spatial), q,
            capped)
    return dcells


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig) -> torch.Tensor:
    """(5, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, H, W)
    cells at (Q, 2) points; kernel on CUDA tensors, plain on CPU ones."""
    if cells.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_blend(cells, points, cfg)
    out = kernel_blend("fused2w_blend", 2, cells, points, cfg)
    fused_blend.launches += 1
    return out


def fused_bwd(g: torch.Tensor, points: torch.Tensor,
              in_spatial: Tuple[int, ...], cfg: SamplerConfig,
              n_cells: int) -> torch.Tensor:
    """(N, C, H, W) cells cotangent of fused_blend for the (5, C, Q)
    cotangent ``g``; kernel on CUDA tensors, plain on CPU ones."""
    if g.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_bwd(g, points, tuple(in_spatial), cfg, n_cells)
    dcells = kernel_bwd("fused2w_bwd", 2, g, points, tuple(in_spatial), cfg,
                        n_cells)
    fused_bwd.launches += 1
    return dcells


fused_blend.launches = 0
fused_bwd.launches = 0
