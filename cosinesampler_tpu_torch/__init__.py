"""PyTorch + CUDA port of the JAX/TPU sampler package for NVIDIA Hopper.

The public sampler (``sample``, ``cosine_sampler_2d/3d`` and the
``CosineSampler2d/3d.apply`` shims) with exact derivatives at every order,
the fused value/jacobian/diag-Hessian op, the PINN model and its trainer,
over hand-written CUDA kernels (csrc/).  The JAX package beside it is the
reference it is held to; this package imports neither it nor JAX.
"""

from .models import pinn, train
from .ops import (CosineSampler2d, CosineSampler3d, SamplerConfig,
                  cosine_sampler_2d, cosine_sampler_3d, make_sample_plan,
                  sample, sample_features_padded,
                  sample_features_with_derivs)

__all__ = [
    "CosineSampler2d",
    "CosineSampler3d",
    "SamplerConfig",
    "cosine_sampler_2d",
    "cosine_sampler_3d",
    "sample",
    "sample_features_padded",
    "sample_features_with_derivs",
    "make_sample_plan",
    "pinn",
    "train",
]
