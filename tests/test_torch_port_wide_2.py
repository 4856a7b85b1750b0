"""PyTorch port, the fused op above 8 channels: part 2 of the tests of
tests/test_torch_port_wide.py, which holds their helpers. The tests are
split into files of at most 10, which xdist's loadfile queue (ordered by
test count) runs beside tests/test_sharding.py rather than ahead of it.
"""

import math

import torch

from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused2w, mega2w, route
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_mega2w_supports_what_jax_admits():
    """Any C with C + 4 <= 128 and up to 32 hidden units, as JAX's
    mega2w.supports; 2D only."""
    cfg = TConfig(dim=2)
    for c in (1, 8, 9, 12, 16, 124):
        assert mega2w.supports(cfg, (96, c, 16, 16), "allen_cahn", 16), c
    assert not mega2w.supports(cfg, (96, 125, 16, 16), "allen_cahn", 16)
    assert not mega2w.supports(cfg, (96, 16, 16, 16), "allen_cahn", 33)
    assert not mega2w.supports(TConfig(dim=3), (8, 16, 8, 8, 8),
                               "helmholtz", 16)


def test_fused_rule_above_8_channels():
    """route.fused_rule above 8 channels, shapes alone: fused2w's /
    fused3w's blend is the v1 blend there and their bwd the v1 bwd's
    scatter but for its mode in place, so the rule takes fused2w /
    fused3w where that bwd adds in place (below
    fused2w.PLANAR_POINTS_PER_TEXEL points a texel: on stacks over the
    L2 at few points) and the v1 pair otherwise; each side at the sweep's
    points (chip_smoke.py wide_route_sweep_phase, PERF.md section 4)."""
    rule = route.fused_rule
    cfg2, cfg3 = TConfig(dim=2), TConfig(dim=3)
    for q in (1024, 16384, 100_000):
        for c in (9, 12, 16, 32):
            assert rule(cfg2, (96, c, 16, 16), q) == "fused", (c, q)
            assert rule(cfg3, (50, c, 16, 16, 16), q) == "fused", (c, q)
    big = (16, 12, 128, 128, 128)
    bound = fused2w.PLANAR_POINTS_PER_TEXEL[3] * 128**3
    for c in (12, 16):
        for q, want in ((4096, "fused3w"), (16384, "fused3w"),
                        (math.ceil(bound) - 1, "fused3w"),
                        (math.ceil(bound), "fused"), (32768, "fused"),
                        (100_000, "fused")):
            assert rule(cfg3, (16, c, 128, 128, 128), q) == want, (c, q)
            assert (want == "fused3w") == fused2w.bwd_geometry(
                3, 16, c, q, big[2:]).planar
    # a 2D stack over the L2 at few points takes fused2w in place
    assert rule(cfg2, (16, 16, 1024, 1024), 4096) == "fused2w"
    assert rule(cfg2, (16, 16, 1024, 1024), 100_000) == "fused"
    # what no kernel takes stays plain above 8 channels too
    assert rule(cfg3, (50, 16, 16, 16, 16), 1024, "cuda",
                torch.float64) == "plain"
    assert rule(cfg3, (50, 8, 16, 16, 16), 1024) == "fused3d"
