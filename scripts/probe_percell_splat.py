"""Split the time of the global-atomics percell splat on one CUDA card.

    PYTHONPATH=CHECKOUT python scripts/probe_percell_splat.py [--reps R]

The design csrc/percell.cu's percell_splat had up to commit 3b5e68b (one
thread a plan slot adding each corner's C values with global atomics into
an output the wrapper zeroes) is compiled here from the source below,
against the corner walk (csrc/pair_corners.cuh) of the package on
PYTHONPATH, with parts switched off:

* ``fill``: the wrapper's ``torch.zeros`` of the output alone;
* ``walk``: the kernel with its atomics replaced by a register sum (the
  plan slot, the pair's corners and weights, its C cotangent loads);
* ``atomics``: the whole kernel into an output zeroed once, outside the
  timed calls;
* ``whole``: the fill and the whole kernel, as the wrapper ran them;
* ``count``: the kernel counting the atomics it would issue (nonzero
  weights times channels), not timed.

Shapes: the nested 3D trainer's volume (16 x 4 x 128^3, 100 000 shared
points, the first batch of its point generator) and 8 x 4 x 32 x 256^2
cells at 2^17 per-cell points (2^20 pairs), both at order 0, cosine,
multicell, zeros, align_corners, with the plan of the package on
PYTHONPATH.  Device ms a call by torch.profiler over ``--reps`` calls, in
turns (each variant, then the same in reverse).  Prints the card's name
and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from cosinesampler_tpu_torch.ops.config import SamplerConfig
from cosinesampler_tpu_torch.ops.coords import offset_lattice
from cosinesampler_tpu_torch.ops.cuda import build, percell
from cosinesampler_tpu_torch.utils.pointgen import PointGenerator

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include "pair_corners.cuh"

namespace {
constexpr int kThreads = 256;

// mode 0: global atomics; 1: a register sum in their place (written only
// if it takes an impossible value, so that the walk stays); 2: the count
// of atomics mode 0 issues, added into *count
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const float* __restrict__ gout,
                 const float* __restrict__ grid, const int* __restrict__ perm,
                 float* __restrict__ out, unsigned long long* count,
                 csm::PairShape s, csm::SamplerParams p) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= s.n * s.q) return;
  const int pair = __ldg(perm + slot);
  const int ni = pair / s.q;
  const int qi = pair - ni * s.q;
  int off[8];
  float wgt[8];
  csm::pair_corners<3>(s, grid, ni, qi, p, off, wgt);
  const float* g = gout + static_cast<int64_t>(ni) * s.c * s.q + qi;
  float* cell = out + static_cast<int64_t>(ni) * s.c * s.texels;
  float sum = 0.0f;
  unsigned long long adds = 0;
  for (int c = 0; c < s.c; ++c) {
    const float gv = __ldg(g + static_cast<int64_t>(c) * s.q);
    float* dst = cell + static_cast<int64_t>(c) * s.texels;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (wgt[k] == 0.0f) continue;
      if (kMode == 0) atomicAdd(dst + off[k], wgt[k] * gv);
      if (kMode == 1) sum = fmaf(wgt[k], gv, sum + off[k] * 1e-30f);
      if (kMode == 2) ++adds;
    }
  }
  if (kMode == 1 && sum == 1.2345e-30f) out[slot] = sum;
  if (kMode == 2) atomicAdd(count, adds);
}
}  // namespace

extern "C" int probe_splat(const void* gout, const void* grid,
                           const void* perm, void* out, void* count, int mode,
                           int n, int c, int d, int h, int w, int q,
                           int grid_batch, int kernel, int padding, int align,
                           int multicell, int strict, float off_step,
                           float off_stop, void* stream) {
  const csm::PairShape s =
      csm::make_pair_shape(3, n, c, d, h, w, q, grid_batch, 0, 0, 0);
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  const int blocks = (n * q + kThreads - 1) / kThreads;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* gg = static_cast<const float*>(gout);
  const auto* gr = static_cast<const float*>(grid);
  const auto* pm = static_cast<const int*>(perm);
  auto* o = static_cast<float*>(out);
  auto* cnt = static_cast<unsigned long long*>(count);
  if (mode == 0)
    probe_kernel<0><<<blocks, kThreads, 0, st>>>(gg, gr, pm, o, cnt, s, p);
  else if (mode == 1)
    probe_kernel<1><<<blocks, kThreads, 0, st>>>(gg, gr, pm, o, cnt, s, p);
  else
    probe_kernel<2><<<blocks, kThreads, 0, st>>>(gg, gr, pm, o, cnt, s, p);
  return cudaGetLastError();
}
"""


def _library():
    src_dir = build.BUILD_ROOT / "probe_src"
    src_dir.mkdir(parents=True, exist_ok=True)
    src = src_dir / "percell_splat_probe.cu"
    src.write_text(SOURCE)
    nvcc = build.nvcc_path()
    flags = [nvcc, *build.NVCC_FLAGS, f"-I{build.CSRC}"]
    lib = ctypes.CDLL(str(build.build_shared_library(
        "percell_splat_probe", [src], flags, [*flags, "-shared"],
        deps=sorted(pathlib.Path(build.CSRC).glob("*.cuh")))))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_splat.argtypes = [ptr] * 5 + [i32] * 13 + [f32, f32, ptr]
    lib.probe_splat.restype = i32
    return lib


def _device_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


def _cases():
    gen = torch.Generator(device="cuda").manual_seed(0)
    with PointGenerator(100_000, 3, seed=7) as pgen:
        shared = torch.from_numpy(pgen.batch(0)).cuda().reshape(
            1, 1, 1, -1, 3)
    wide = torch.rand((8, 1, 1, 1 << 17, 3), generator=gen,
                      device="cuda") * 2 - 1
    for what, shape, grid in (("16x4x128^3, Q=100000 shared",
                               (16, 4, 128, 128, 128), shared),
                              ("8x4x32x256^2, 2^20 per-cell pairs",
                               (8, 4, 32, 256, 256), wide)):
        gout = torch.randn((shape[0], 4, *grid.shape[1:-1]), generator=gen,
                           device="cuda")
        yield what, shape, grid, gout


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lib = _library()
    cfg = SamplerConfig(dim=3)
    for what, shape, grid, gout in _cases():
        n, c, d, h, w = shape
        q = grid.shape[3]
        plan = percell.make_plan(grid, shape, cfg)
        step, stop = offset_lattice(n, cfg.multicell)
        count = torch.zeros(1, dtype=torch.int64, device="cuda")
        held = torch.zeros(shape, device="cuda")

        def launch(mode, out):
            err = lib.probe_splat(
                gout.data_ptr(), grid.data_ptr(), plan.perm.data_ptr(),
                out.data_ptr(), count.data_ptr(), mode, n, c, d, h, w, q,
                grid.shape[0], 0, 0, 1, 1, 0, float(step), float(stop),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe_splat mode {mode}: error {err}")

        def whole():
            launch(0, torch.zeros(shape, device="cuda"))

        runs = {"fill": lambda: torch.zeros(shape, device="cuda"),
                "walk": lambda: launch(1, held),
                "atomics": lambda: launch(0, held),
                "whole": whole,
                "wrapper": lambda: percell.splat(gout, grid, shape[2:], cfg,
                                                 (0, 0, 0), plan)}
        launch(2, held)
        adds = int(count.item())
        got = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            got[k].append(_device_ms(runs[k], args.reps))
        print(f"{card}; probe percell_splat {what}: {n * q} pairs, "
              f"{adds} global atomics ({adds / (8 * c * n * q):.3f} of 8 C "
              f"a pair); device ms a call (two turns): "
              + ", ".join(f"{k} " + " ".join(f"{v:.4f}" for v in vals)
                          for k, vals in got.items()), flush=True)
        del held, plan, grid, gout
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
