"""Sampler ops: configuration, coordinate and interpolant math, the plain
blend/splat oracle, the any-order autograd pair over the blend_o/splat_o
kernels, the public API and the fused op over the fused2w kernels."""

from .api import (CosineSampler2d, CosineSampler3d, cosine_sampler_2d,
                  cosine_sampler_3d)
from .config import SamplerConfig
from .fused import (make_sample_plan, sample_features_padded,
                    sample_features_with_derivs)
from .sampler import differentiable_blend, differentiable_splat, sample

__all__ = [
    "CosineSampler2d",
    "CosineSampler3d",
    "SamplerConfig",
    "cosine_sampler_2d",
    "cosine_sampler_3d",
    "differentiable_blend",
    "differentiable_splat",
    "sample",
    "sample_features_with_derivs",
    "sample_features_padded",
    "make_sample_plan",
]
