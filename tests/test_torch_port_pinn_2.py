"""PyTorch port, the PINN model and trainer: part 2 of the tests of
tests/test_torch_port_pinn.py, which holds their helpers. The tests are
split into files of at most 10, which xdist's loadfile queue (ordered by
test count) runs beside tests/test_sharding.py rather than ahead of it.
"""

import numpy as np
import pytest
import torch

from cosinesampler_tpu.utils import pointgen as jpointgen
from cosinesampler_tpu_torch.models import pinn as tpinn, train as ttrain
from cosinesampler_tpu_torch.utils import pointgen as tpointgen
from cosinesampler_tpu_torch.utils.convert import (params_from_numpy,
                                                   params_to_numpy)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_pinn import KW, Q, _setup


def test_params_convert_roundtrip():
    _, _, np_params, _ = _setup(4)
    back = params_to_numpy(params_from_numpy(np_params, "cpu"))
    for k, v in np_params.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("force_numpy", [False, True])
def test_point_stream_bit_equal_to_jax(force_numpy):
    mine = tpointgen.PointGenerator(300, 2, seed=11, force_numpy=force_numpy)
    ref = jpointgen.PointGenerator(300, 2, seed=11, force_numpy=True)
    with mine:
        assert mine.is_native != force_numpy
        for step in (0, 1, 7, 2):    # out of order, as a resume would ask
            np.testing.assert_array_equal(mine.batch(step), ref.batch(step))
    ref.close()


@pytest.mark.parametrize("kwargs,match", [
    (dict(fused=True, vol_resident=True), "vol_resident"),
])
def test_make_train_step_unported_modes_raise(kwargs, match):
    """The vol-resident step serves only shapes the bricked 3D kernels
    take: in 2D it raises."""
    params = tpinn.init_params(torch.Generator().manual_seed(0),
                               tpinn.PINNConfig(**KW), "cpu")
    opt = torch.optim.Adam(params.values())
    step = tpinn.make_train_step(tpinn.PINNConfig(**KW), opt, **kwargs)
    with pytest.raises(ValueError, match=match):
        step(params, torch.zeros((Q, 2)), None)


@pytest.mark.parametrize("field,value", [
    ("vol_resident", True), ("shard", True),
    ("autotune", True), ("checkpoint_dir", "ckpt")])
def test_train_unported_options_raise(field, value):
    """Options not ported raise NotImplementedError naming their ROADMAP
    item; vol_resident is ported and raises ValueError off its route (the
    default model is 2D)."""
    cfg = ttrain.TrainConfig(device="cpu", steps=1, batch_points=64,
                             **{field: value})
    exc, match = ((ValueError, "vol_resident") if field == "vol_resident"
                  else (NotImplementedError, "ROADMAP"))
    with pytest.raises(exc, match=match):
        ttrain.train(cfg)


def test_train_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(ttrain.TrainConfig(device="cuda", steps=1,
                                        batch_points=64))


def test_train_end_to_end_on_cpu():
    seen = []
    cfg = ttrain.TrainConfig(model=tpinn.PINNConfig(**KW), device="cpu",
                             steps=3, batch_points=Q, log_every=1)
    params, metrics = ttrain.train(cfg, on_metrics=seen.append)
    assert [m["step"] for m in metrics] == [1, 2, 3] and seen == metrics
    assert all(np.isfinite(m["loss"]) and m["steps_per_sec"] > 0
               for m in metrics)
    assert params["cells"].shape == (8, 4, 16, 16)
    # fixed points: the same batch every step
    fixed = ttrain.TrainConfig(model=tpinn.PINNConfig(**KW), device="cpu",
                               steps=2, batch_points=Q, log_every=1,
                               fixed_points=True)
    _, fixed_metrics = ttrain.train(fixed)
    assert fixed_metrics[0]["loss"] == metrics[0]["loss"]
