"""PyTorch port, the fused op: part 3 of the tests of
tests/test_torch_port_fused.py, which holds their helpers. The tests are
split into files of at most 10, which xdist's loadfile queue (ordered by
test count) runs beside tests/test_sharding.py rather than ahead of it.
"""

import pytest
import torch

from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import build, fused2w
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_fused import _z


@pytest.mark.parametrize("kw,tensor,exc", [
    (dict(dim=3, precision="fast"), _z(2, 3), NotImplementedError),
    (dict(dim=2, precision="bf16"), _z(2, 2), NotImplementedError),
    (dict(dim=2, precision="fast"), _z(2, 2), NotImplementedError),
    (dict(dim=2, strict_reference=True, align_corners=False), _z(2, 2),
     NotImplementedError),
    (dict(dim=2), _z(2, 2, dtype=torch.float64), TypeError),
    (dict(dim=2), _z(2, 4)[:, ::2], ValueError),
])
def test_kernel_input_checks_reject(kw, tensor, exc):
    with pytest.raises(exc):
        fused2w.check_kernel_inputs(TConfig(**kw), tensor)


def test_kernel_input_checks_accept_main_path():
    fused2w.check_kernel_inputs(
        TConfig(dim=2, precision="highest", strict_reference=True), _z(3, 2))


def test_build_caches_by_content_and_reports_compiler_errors(tmp_path):
    good = tmp_path / "good.cpp"
    good.write_text('extern "C" int answer() { return 42; }\n')
    cmd = ["g++", "-O1", "-shared", "-fPIC"]
    lib = build.build_shared_library("good", [good], cmd, root=tmp_path / "b")
    assert lib.exists()
    assert build.build_shared_library("good", [good], cmd,
                                      root=tmp_path / "b") == lib
    good.write_text('extern "C" int answer() { return 43; }\n')
    assert build.build_shared_library("good", [good], cmd,
                                      root=tmp_path / "b") != lib
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        build.build_shared_library("bad", [bad], cmd, root=tmp_path / "b")
