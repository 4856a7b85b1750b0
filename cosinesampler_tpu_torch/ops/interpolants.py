"""Interpolation kernels and their derivatives, to arbitrary order.

Counterpart of the JAX package's ops/interpolants.py.  Each kernel is a
closed-form family ``w^(k)(t)`` over the fractional coordinate t in [0, 1]:

* ``cosine``      : w(t) = (1 - cos(pi t)) / 2
* ``linear``      : w(t) = t
* ``smoothstep``  : w(t) = t^2 (3 - 2 t)

Corner weights follow the ceil-corner convention: W_1 = w, W_0 = 1 - w, and
for order k >= 1, W_1^(k) = +w^(k), W_0^(k) = -w^(k).

The JAX package's range-reduced polynomial trig exists only for the TPU's
vector-unit sin/cos; here torch.cos is exact to the dtype, and the CUDA
kernels use libm ``sincospif`` (csrc/sampler_math.cuh).
"""

from __future__ import annotations

import math

import torch

_PI = math.pi

#: canonical kernel names; the public API accepts the reference aliases too
KERNELS = ("cosine", "linear", "smoothstep")

_ALIASES = {
    "cosine": "cosine",
    "bilinear": "linear",
    "trilinear": "linear",
    "linear": "linear",
    "smooth-step": "smoothstep",
    "smoothstep": "smoothstep",
}


def canonical_kernel(name: str) -> str:
    """Map a reference kernel name to its canonical form."""
    try:
        return _ALIASES[name]
    except KeyError:
        raise ValueError(
            f"unknown interpolation kernel {name!r}; expected one of {sorted(_ALIASES)}"
        ) from None


def kernel_weight(kernel: str, t: torch.Tensor, order: int) -> torch.Tensor:
    """k-th derivative ``w^(k)(t)`` of the interpolant ``w``, in t's dtype."""
    if order < 0:
        raise ValueError(f"order must be >= 0, got {order}")
    if kernel == "cosine":
        if order == 0:
            return 0.5 * (1.0 - torch.cos(_PI * t))
        # d^k/dt^k [-cos(pi t)/2] = -(pi^k / 2) cos(pi t + k pi/2)
        return -0.5 * _PI**order * torch.cos(_PI * t + order * (_PI / 2))
    if kernel == "linear":
        if order == 0:
            return t
        if order == 1:
            return torch.ones_like(t)
        return torch.zeros_like(t)
    if kernel == "smoothstep":
        if order == 0:
            return t * t * (3.0 - 2.0 * t)
        if order == 1:
            return 6.0 * t * (1.0 - t)
        if order == 2:
            return 6.0 - 12.0 * t
        if order == 3:
            return torch.full_like(t, -12.0)
        return torch.zeros_like(t)
    raise ValueError(f"unknown canonical kernel {kernel!r}")


def corner_weights(kernel: str, t: torch.Tensor, order: int):
    """Per-axis corner weights ``(W_0^(k)(t), W_1^(k)(t))`` (floor, ceil)."""
    wk = kernel_weight(kernel, t, order)
    if order == 0:
        return 1.0 - wk, wk
    return -wk, wk
