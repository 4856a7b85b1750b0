"""PyTorch port, the PINN model and trainer: part 3 of the tests of
tests/test_torch_port_pinn.py, which holds their helpers. The tests are
split into files of at most 10, which xdist's loadfile queue (ordered by
test count) runs beside tests/test_sharding.py rather than ahead of it.
"""

import json

import numpy as np
import pytest
import torch

from cosinesampler_tpu_torch.models import pinn as tpinn, train as ttrain
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_pinn import KW, KW3


@pytest.mark.parametrize("model", [dict(KW), dict(KW3)],
                         ids=["2d-allen-cahn", "3d-helmholtz"])
def test_train_nested_on_cpu(model):
    """fused=False trains on pinn.loss; its first loss is the fused
    trainer's first loss (same weights and points, same function)."""
    losses = {}
    for fused in (False, True):
        cfg = ttrain.TrainConfig(model=tpinn.PINNConfig(**model),
                                 device="cpu", steps=2, batch_points=256,
                                 log_every=1, fused=fused)
        params, metrics = ttrain.train(cfg)
        assert [m["step"] for m in metrics] == [1, 2]
        assert all(np.isfinite(m["loss"]) for m in metrics)
        assert all(bool(torch.isfinite(v).all()) for v in params.values())
        losses[fused] = metrics[0]["loss"]
    np.testing.assert_allclose(losses[False], losses[True], rtol=1e-5)


def test_cli_no_fused(capsys):
    assert ttrain.main(["--device", "cpu", "--steps", "2", "--batch-points",
                        "256", "--n-cells", "4", "--no-fused"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [m["step"] for m in lines] == [2]
    assert np.isfinite(lines[0]["loss"])


def test_cli_prints_json_metrics(capsys):
    assert ttrain.main(["--device", "cpu", "--steps", "2", "--batch-points",
                        "256", "--n-cells", "4"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [m["step"] for m in lines] == [2]     # the last step always logs
    assert np.isfinite(lines[0]["loss"])
