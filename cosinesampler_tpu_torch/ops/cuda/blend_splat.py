"""The blend_o / splat_o pair: gather-and-weigh at any per-axis derivative
order, and its transpose with respect to the input, in 2D and 3D.

Counterpart of the JAX package's ops/pallas/kernels.py.  Each op has two
versions in this module:

* ``plain_blend`` / ``plain_splat``: plain PyTorch, ops/generic.py, any
  dtype.  They are the oracle the kernels are held to.
* ``blend`` / ``splat``: the wrappers of the hand-written CUDA kernels in
  csrc/blend_splat.cu.  Tensors on the CPU take the plain version; CUDA
  tensors launch the kernel on the current stream, or raise for what the
  kernel does not take.  Each wrapper counts its launches in its
  ``launches`` attribute.

The kernels compute in f32 whatever ``cfg.precision`` says, as the JAX
package's v1 kernels do (HIGHEST-precision contractions).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import SamplerConfig, effective_align
from ..coords import offset_lattice
from ..generic import blend as plain_blend
from ..generic import splat as plain_splat
from .build import check, load_kernels
from .fused2w import KERNEL_IDS, PADDING_IDS, cuda_device

__all__ = ["blend", "plain_blend", "plain_splat", "splat"]


def _check_tensors(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(
                f"the CUDA blend_o/splat_o kernels take float32, got "
                f"{t.dtype}; backend='xla' computes other dtypes")
        if not t.is_contiguous():
            raise ValueError("the CUDA blend_o/splat_o kernels take "
                             "contiguous tensors")
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError("tensor too large for the kernels' 32-bit indexing")


def _check_shapes(cfg: SamplerConfig, n: int, spatial, grid, orders) -> int:
    """The query count Q of a grid that fits (N, C, *spatial) cells."""
    d = cfg.dim
    if (len(spatial) != d or grid.dim() != d + 2 or grid.shape[-1] != d
            or grid.shape[0] not in (1, n) or len(orders) != d
            or min(orders) < 0):
        raise ValueError(
            f"expected {d}D cells (N, C, *S), a grid (N or 1, ..., {d}) and "
            f"{d} orders >= 0, got spatial {tuple(spatial)}, grid "
            f"{tuple(grid.shape)} and orders {tuple(orders)}")
    return math.prod(grid.shape[1:-1])


def _launch(entry, first: torch.Tensor, grid: torch.Tensor,
            out: torch.Tensor, cfg: SamplerConfig, n: int, c: int, spatial,
            q: int, orders, align: bool) -> None:
    lib = load_kernels()
    if n * c * max(q, math.prod(spatial)) >= 2**31:
        raise ValueError("cells or queries too many for the kernels' 32-bit "
                         "indexing")
    d, h, w = (1, *spatial) if cfg.dim == 2 else spatial
    ox, oy, oz = (*orders, 0) if cfg.dim == 2 else orders
    step, stop = offset_lattice(n, cfg.multicell)
    device = out.device
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            first.data_ptr(), grid.data_ptr(), out.data_ptr(), cfg.dim, n, c,
            d, h, w, q, grid.shape[0], ox, oy, oz, KERNEL_IDS[cfg.kernel],
            PADDING_IDS[cfg.padding_mode], int(align), int(cfg.multicell),
            int(cfg.strict_reference), float(step), float(stop),
            torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, f"{entry} launch")


def blend(input: torch.Tensor, grid: torch.Tensor, cfg: SamplerConfig,
          orders: Tuple[int, ...]) -> torch.Tensor:
    """(N, C, *out_spatial): generic.blend of (N, C, *S) cells at the grid
    (N or 1, *out_spatial, d); kernel on CUDA tensors, plain on CPU ones."""
    if input.device.type == "cpu" and grid.device.type == "cpu":
        return plain_blend(input, grid, cfg, orders)
    device = cuda_device(input, grid)
    _check_tensors(input, grid)
    n, c, *spatial = input.shape
    q = _check_shapes(cfg, n, spatial, grid, orders)
    out = torch.empty((n, c, *grid.shape[1:-1]),
                      dtype=torch.promote_types(input.dtype, grid.dtype),
                      device=device)
    # the strict-mode 2D align quirk applies to the order-0 gather only
    _launch("blend_o", input, grid, out, cfg, n, c, spatial, q, orders,
            effective_align(cfg, orders))
    blend.launches += 1
    return out


def splat(gout: torch.Tensor, grid: torch.Tensor,
          in_spatial: Tuple[int, ...], cfg: SamplerConfig,
          orders: Tuple[int, ...]) -> torch.Tensor:
    """(N, C, *in_spatial): generic.splat, the transpose of blend with
    respect to the input; kernel on CUDA tensors, plain on CPU ones."""
    if gout.device.type == "cpu" and grid.device.type == "cpu":
        return plain_splat(gout, grid, tuple(in_spatial), cfg, orders)
    device = cuda_device(gout, grid)
    _check_tensors(gout, grid)
    n, c = gout.shape[:2]
    q = _check_shapes(cfg, n, in_spatial, grid, orders)
    if math.prod(gout.shape[2:]) != q:
        raise ValueError(f"gout {tuple(gout.shape)} does not match the grid "
                         f"{tuple(grid.shape)}")
    out = torch.zeros((n, c, *in_spatial),
                      dtype=torch.promote_types(gout.dtype, grid.dtype),
                      device=device)
    _launch("splat_o", gout, grid, out, cfg, n, c, tuple(in_spatial), q,
            orders, cfg.align_corners)
    splat.launches += 1
    return out


blend.launches = 0
splat.launches = 0
