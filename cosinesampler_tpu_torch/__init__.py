"""PyTorch + CUDA port of the JAX/TPU sampler package for NVIDIA Hopper.

The fused 2D PINN training path: the fused value/jacobian/diag-Hessian
sampler with hand-written CUDA kernels (csrc/), the PINN model and its
trainer.  The JAX package beside it is the reference it is held
to; this package imports neither it nor JAX.
"""

from .models import pinn, train
from .ops import SamplerConfig, sample_features_padded, sample_features_with_derivs

__all__ = ["SamplerConfig", "pinn", "sample_features_padded",
           "sample_features_with_derivs", "train"]
