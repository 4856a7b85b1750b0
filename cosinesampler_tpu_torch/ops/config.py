"""Static sampler configuration (counterpart of the JAX package's ops/config.py).

The same frozen dataclass, enums, aliases and errors as the JAX package, so
one configuration means the same thing on both sides.  ``backend`` keeps the
JAX names: ``"xla"`` selects the plain PyTorch reference path, ``"pallas"``
and ``"auto"`` the hand-written CUDA kernels (which take the plain path for
tensors on the CPU, see ops/cuda/fused2w.py).  ``precision`` keeps its
values; the CUDA kernels take only the f32 ones ("exact", "highest").
"""

from __future__ import annotations

import dataclasses

from .interpolants import canonical_kernel

PADDING_MODES = ("zeros", "border", "reflection")
BACKENDS = ("auto", "xla", "pallas")
PRECISIONS = ("exact", "fast", "bf16", "highest")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    dim: int                      # 2 or 3
    kernel: str = "cosine"        # canonical: cosine | linear | smoothstep
    padding_mode: str = "zeros"   # zeros | border | reflection
    align_corners: bool = True
    multicell: bool = True
    backend: str = "auto"         # auto | xla (plain torch) | pallas (kernels)
    #: Reproduce the reference CUDA kernels' two coordinate quirks: the
    #: reflection span 2*(size-2) even without multicell, and the 2D
    #: forward's hardcoded align_corners=True (see the JAX package's
    #: SamplerConfig for the full story).
    strict_reference: bool = False
    precision: str = "exact"

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        object.__setattr__(self, "kernel", canonical_kernel(self.kernel))
        if self.padding_mode not in PADDING_MODES:
            raise ValueError(
                f"padding_mode must be one of {PADDING_MODES}, got {self.padding_mode!r}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {self.precision!r}")


def effective_align(cfg: SamplerConfig, orders) -> bool:
    """align_corners as the reference's kernel for ``orders`` would see it.

    Under ``strict_reference`` the order-0 ("forward") 2D blend uses True;
    every other order uses the flag.
    """
    if cfg.strict_reference and cfg.dim == 2 and all(o == 0 for o in orders):
        return True
    return cfg.align_corners
