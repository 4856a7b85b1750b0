"""Public API: cosine_sampler_2d / cosine_sampler_3d and the ``.apply`` shims.

Counterpart of the JAX package's ops/api.py, with the same signatures:
functional equivalents of the reference's ``CosineSampler2d.apply`` /
``CosineSampler3d.apply``, differentiable to any order through
``torch.autograd.grad(..., create_graph=True)`` (ops/sampler.py).
``backend="auto"`` launches the CUDA kernels for CUDA tensors and takes
the plain PyTorch version for CPU tensors; ``"xla"`` is always the plain
version.
"""

from __future__ import annotations

from .config import SamplerConfig
from .sampler import sample


def cosine_sampler_2d(input, grid, padding_mode: str = "zeros",
                      align_corners: bool = True, kernel: str = "cosine",
                      multicell: bool = True, backend: str = "auto",
                      strict_reference: bool = False,
                      precision: str = "exact"):
    """Sample N feature grids (N, C, H, W) at grid (N, H_out, W_out, 2).

    Grid coords in [-1, 1]; grid[..., 0] is x (addresses W), grid[..., 1] is
    y (addresses H); a grid of batch 1 is shared by all N grids.  Returns
    (N, C, H_out, W_out).  ``strict_reference`` reproduces the reference
    CUDA kernels' coordinate quirks (see SamplerConfig.strict_reference).
    The CUDA kernels compute in f32 for every ``precision``.
    """
    cfg = SamplerConfig(
        dim=2, kernel=kernel, padding_mode=padding_mode,
        align_corners=align_corners, multicell=multicell, backend=backend,
        strict_reference=strict_reference, precision=precision,
    )
    return sample(input, grid, cfg)


def cosine_sampler_3d(input, grid, padding_mode: str = "zeros",
                      align_corners: bool = True, kernel: str = "cosine",
                      multicell: bool = True, backend: str = "auto",
                      strict_reference: bool = False,
                      precision: str = "exact"):
    """Sample N feature volumes (N, C, D, H, W) at grid (N, D_out, H_out, W_out, 3).

    grid[..., 0] is x (addresses W), [..., 1] y (H), [..., 2] z (D).
    Returns (N, C, D_out, H_out, W_out).  For ``strict_reference`` /
    ``precision`` see :func:`cosine_sampler_2d`.
    """
    cfg = SamplerConfig(
        dim=3, kernel=kernel, padding_mode=padding_mode,
        align_corners=align_corners, multicell=multicell, backend=backend,
        strict_reference=strict_reference, precision=precision,
    )
    return sample(input, grid, cfg)


class _ApplyShim:
    """``CosineSampler2d.apply(...)``-style shim for drop-in migration."""

    def __init__(self, fn):
        self._fn = fn

    def apply(self, input, grid, padding_mode="zeros", align_corners=True,
              kernel="cosine", multicell=True):
        return self._fn(input, grid, padding_mode, align_corners, kernel,
                        multicell)


CosineSampler2d = _ApplyShim(cosine_sampler_2d)
CosineSampler3d = _ApplyShim(cosine_sampler_3d)
