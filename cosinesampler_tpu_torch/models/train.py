"""PINN training loop: fused sampler + native point stream + Adam.

Counterpart of the JAX package's models/train.py: per-step collocation batches
from the Philox stream (utils/pointgen.py), the train step (models/pinn.py:
the fused loss by default, the nested-autograd loss with ``fused=False``,
the one-launch megakernel gradient with ``megakernel=True``) and per-step
metrics.  Run it with

    python -m cosinesampler_tpu_torch.models.train --device cuda \
        [--no-fused | --megakernel] [--dim 3]

The device is explicit: ``device="cuda"`` without a card raises, and
nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from ..utils.pointgen import PointGenerator
from . import pinn


@dataclasses.dataclass
class TrainConfig:
    model: pinn.PINNConfig = dataclasses.field(default_factory=pinn.PINNConfig)
    batch_points: int = 100_000
    steps: int = 1000
    lr: float = 1e-3
    seed: int = 0
    device: str = "cuda"
    fused: bool = True           # False: nested autograd (pinn.loss)
    # the one-launch train-step gradient (pinn.value_and_grad_mega, 2D);
    # falls back to autograd of the fused loss where it does not serve
    megakernel: bool = False
    # one collocation set for the whole run (the reference's own pattern);
    # the port builds no bin plan, so this only fixes the points
    fixed_points: bool = False
    # not ported yet: each raises NotImplementedError naming its ROADMAP item
    vol_resident: bool = False
    shard: bool = False
    autotune: bool = False
    checkpoint_dir: Optional[str] = None
    log_every: int = 50


_NOT_PORTED = {
    "vol_resident": "the bricked 3D kernels (ROADMAP B10)",
    "shard": "data-parallel training (ROADMAP A9)",
    "autotune": "the kernel autotuner (ROADMAP A10)",
    "checkpoint_dir": "checkpoints (ROADMAP A7)",
}


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available; pass device='cpu' to train on the CPU")
    return device


def train(cfg: TrainConfig,
          on_metrics: Optional[Callable[[Dict], None]] = None):
    """Run the PINN loop; returns (params, list-of-metric-dicts)."""
    for name, what in _NOT_PORTED.items():
        if getattr(cfg, name):
            raise NotImplementedError(f"TrainConfig.{name} needs {what}")
    device = _device(cfg.device)
    mcfg = cfg.model
    generator = torch.Generator().manual_seed(cfg.seed)
    params = pinn.init_params(generator, mcfg, device)
    optimizer = torch.optim.Adam(params.values(), lr=cfg.lr)
    step_fn = pinn.make_train_step(mcfg, optimizer, fused=cfg.fused,
                                   megakernel=cfg.megakernel)

    metrics: List[Dict] = []
    with PointGenerator(cfg.batch_points, mcfg.dim, seed=cfg.seed) as gen:
        fixed_pts = (torch.from_numpy(gen.batch(0)).to(device)
                     if cfg.fixed_points else None)
        t_last = time.perf_counter()
        for step in range(cfg.steps):
            pts = (fixed_pts if fixed_pts is not None
                   else torch.from_numpy(gen.batch(step)).to(device))
            lval = step_fn(params, pts)
            if (step + 1) % cfg.log_every == 0 or step + 1 == cfg.steps:
                loss = float(lval)          # waits for the device
                now = time.perf_counter()
                window = min(cfg.log_every, step + 1)
                rec = {
                    "step": step + 1,
                    "loss": loss,
                    "steps_per_sec": window / (now - t_last),
                    "points_per_sec": window * cfg.batch_points / (now - t_last),
                }
                metrics.append(rec)
                if on_metrics:
                    on_metrics(rec)
                t_last = now
    return params, metrics


def main(argv=None):
    """CLI: python -m cosinesampler_tpu_torch.models.train [--device cuda] ..."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description="PIXEL-style PINN trainer (PyTorch)")
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-points", type=int, default=100_000)
    ap.add_argument("--n-cells", type=int, default=96)
    ap.add_argument("--cell-dim", type=int, default=4)
    ap.add_argument("--cell-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pde", default=None, help="allen_cahn | helmholtz")
    ap.add_argument("--no-fused", action="store_true",
                    help="use nested autograd through the sampler instead "
                         "of the fused kernels")
    ap.add_argument("--megakernel", action="store_true",
                    help="one-launch train-step gradient (2D): the fused "
                         "blend, the MLP and residual backward and the "
                         "cotangent splat in a single CUDA kernel")
    ap.add_argument("--fixed-points", action="store_true",
                    help="one collocation set for the whole run")
    args = ap.parse_args(argv)

    pde = args.pde or ("allen_cahn" if args.dim == 2 else "helmholtz")
    cfg = TrainConfig(
        model=pinn.PINNConfig(dim=args.dim, n_cells=args.n_cells,
                              cell_dim=args.cell_dim,
                              cell_size=args.cell_size, pde=pde),
        batch_points=args.batch_points, steps=args.steps, lr=args.lr,
        seed=args.seed, device=args.device, fused=not args.no_fused,
        fixed_points=args.fixed_points, megakernel=args.megakernel,
    )
    train(cfg, on_metrics=lambda m: print(json.dumps(m), flush=True))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
