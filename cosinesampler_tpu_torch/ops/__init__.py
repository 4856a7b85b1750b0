"""Sampler ops: configuration, coordinate and interpolant math, the plain
blend/splat oracle and the fused op over the CUDA kernels."""

from .config import SamplerConfig
from .fused import sample_features_padded, sample_features_with_derivs

__all__ = ["SamplerConfig", "sample_features_padded",
           "sample_features_with_derivs"]
