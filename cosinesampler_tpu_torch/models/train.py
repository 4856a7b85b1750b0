"""PINN training loop: fused sampler + native point stream + Adam.

Counterpart of the JAX package's models/train.py: per-step collocation batches
from the Philox stream (utils/pointgen.py), the train step (models/pinn.py:
the fused loss by default, the nested-autograd loss with ``fused=False``,
the one-launch megakernel gradient with ``megakernel=True``, the cells in
the bricked 3D kernels' layout with ``vol_resident=True``) and per-step
metrics.  Run it with

    python -m cosinesampler_tpu_torch.models.train --device cuda \
        [--no-fused | --megakernel] [--dim 3] [--fixed-points]

or, for BASELINE config 5 (16 x 4 x 128^3, 1M points, vol-resident),

    python -m cosinesampler_tpu_torch.models.train --device cuda --dim 3 \
        --n-cells 16 --cell-size 128 --batch-points 1000000 --vol-resident

The device is explicit: ``device="cuda"`` without a card raises, and
nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from ..ops.fused import make_sample_plan, make_vol_plan
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
    # with the fused loss its bin plan is built once (make_sample_plan)
    fixed_points: bool = False
    # the cells in the bricked 3D kernels' layout across steps, Adam's
    # moments too (3D; requires fused, implies fixed_points)
    vol_resident: bool = False
    # not ported yet: each raises NotImplementedError naming its ROADMAP item
    shard: bool = False
    autotune: bool = False
    checkpoint_dir: Optional[str] = None
    log_every: int = 50


_NOT_PORTED = {
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
    mcfg = cfg.model
    if cfg.vol_resident:
        if not cfg.fused:
            raise ValueError("vol_resident=True requires fused=True: the "
                             "bricked kernels serve the fused loss")
        # raises ValueError for a shape the bricked kernels do not take
        pinn.vol_converters(mcfg, cfg.batch_points)
    device = _device(cfg.device)
    generator = torch.Generator().manual_seed(cfg.seed)
    params = pinn.init_params(generator, mcfg, device)
    cells_shape = tuple(params["cells"].shape)
    fixed = cfg.fixed_points or cfg.vol_resident

    metrics: List[Dict] = []
    with PointGenerator(cfg.batch_points, mcfg.dim, seed=cfg.seed) as gen:
        fixed_pts = (torch.from_numpy(gen.batch(0)).to(device) if fixed
                     else None)
        plan = None
        if cfg.vol_resident:
            plan = make_vol_plan(fixed_pts, cells_shape, mcfg.sampler)
            # before the optimizer, so that its moments are born in the
            # kernel layout (the update commutes with the permutation)
            params = pinn.params_to_vol(params, mcfg, cfg.batch_points)
        elif fixed and cfg.fused and not cfg.megakernel:
            plan = make_sample_plan(fixed_pts, cells_shape, mcfg.sampler)
        optimizer = torch.optim.Adam(params.values(), lr=cfg.lr)
        step_fn = pinn.make_train_step(
            mcfg, optimizer, fused=cfg.fused, megakernel=cfg.megakernel,
            planned=plan is not None, vol_resident=cfg.vol_resident)
        t_last = time.perf_counter()
        for step in range(cfg.steps):
            pts = (fixed_pts if fixed_pts is not None
                   else torch.from_numpy(gen.batch(step)).to(device))
            lval = (step_fn(params, pts) if plan is None
                    else step_fn(params, pts, plan))
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
    if cfg.vol_resident:
        params = pinn.params_from_vol(params, mcfg, cfg.batch_points)
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
                    help="one collocation set for the whole run; builds "
                         "its bin plan once")
    ap.add_argument("--vol-resident", action="store_true",
                    help="train with the cells in the bricked 3D kernels' "
                         "layout (3D; implies --fixed-points)")
    args = ap.parse_args(argv)

    pde = args.pde or ("allen_cahn" if args.dim == 2 else "helmholtz")
    cfg = TrainConfig(
        model=pinn.PINNConfig(dim=args.dim, n_cells=args.n_cells,
                              cell_dim=args.cell_dim,
                              cell_size=args.cell_size, pde=pde),
        batch_points=args.batch_points, steps=args.steps, lr=args.lr,
        seed=args.seed, device=args.device, fused=not args.no_fused,
        fixed_points=args.fixed_points, megakernel=args.megakernel,
        vol_resident=args.vol_resident,
    )
    train(cfg, on_metrics=lambda m: print(json.dumps(m), flush=True))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
