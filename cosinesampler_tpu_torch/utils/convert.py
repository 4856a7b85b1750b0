"""Move PINN parameters between the JAX package and the port.

Both packages use the same dict of leaves with the same names, shapes and
layouts (``cells``, ``w1``, ``b1``, ``w2``, ``b2``; see models/pinn.py), so
converting is a copy: the same weights give the same model on both sides.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(d: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """NumPy arrays (e.g. from the JAX package's ``init_params``) -> leaf
    tensors on ``device`` that require grad, dtypes kept."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            .requires_grad_(True) for k, v in d.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's parameter tensors -> NumPy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
