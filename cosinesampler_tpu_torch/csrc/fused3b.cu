// Bricked 3D fused blend and its transpose over the kernel-layout volume,
// for NVIDIA Hopper (sm_90a).
//
// fused3b_blend replaces the TPU kernel
//   ops/pallas/fused3b.py::_fused3b_blend_kernel of the JAX package
// fused3b_bwd replaces
//   ops/pallas/fused3b.py::_fused3b_bwd_kernel of the JAX package
//
// Contract (the JAX package's pallas_fused3b_blend_vol / _bwd_vol):
//   vol    (D, H, W, N, C) f32: the cells (N, C, D, H, W) permuted
//          (ops/cuda/fused3b.py cells_to_vol), no pad slots;
//   pts_p  (QP, 3) f32, occ (QP,) f32, hasv (QP / 128,) int32: the brick
//          plan's slot-ordered points, real-slot mask and per-block flag.
//   blend: -> out (7, C, QP) f32 in slot order, rows value, d/dx, d/dy,
//          d/dz, d2/dx2, d2/dy2, d2/dz2 summed over the N cells; zeros in
//          slots with occ == 0.
//   bwd:   g (7, C, QP) f32 -> dvol (D, H, W, N, C), the transpose; slots
//          with occ == 0 add nothing.  dvol must be zeroed.
// All three padding modes and interpolants, multicell on and off, both
// align_corners, any C; a corner out of bounds reads zero and is never
// written.
//
// What bounds them on the H100 SXM (its data sheet's peaks at the 700 W
// power limit: 67 TFLOP/s f32, 3.35 TB/s), and the design:
// * At BASELINE config 5 (16 x 4 x 128^3, 1M points) the f32 volume is
//   537 MB, ten times the 50 MB L2.  Queries in API order gather from and
//   add into all of it at random; the brick plan sorts them so that the
//   128 slots of one block share one (z slab, y group) brick and
//   consecutive blocks walk the volume slab by slab.  The sort is the
//   only part of the TPU kernels carried over: their one-hot MXU
//   contractions, 128-lane W padding, super-brick DMA chain and
//   serialized read-modify-write grid exist because the TPU has no gather
//   and no atomics.
// * The layout keeps one texel's N * C values together, so a query reads
//   a cell's C channels at a corner as one 16-byte load at C = 4 (and adds
//   them back with one vector atomic in the bwd).
// * blend (csrc/texel_gather.cuh, shared with fused3s_blend): a block per
//   plan block compacts its real slots, whose threads then write zeros
//   into the pad slots (30% of QP at config 5), and the gather serves the
//   rest (layouts: ops/cuda/gather.py gather_geometry, bricked).  At
//   C = 4 a thread a query over its cells: two lanes over cells 2j and
//   2j + 1 read whole sectors (74 M at config 5 against 124 M,
//   scripts/count_brick_flush.py) but ran 1.02-1.04 ms against 0.93,
//   since the queries of a brick read neighbouring texels and L1 already
//   merged those records across a thread's loop.  The kernel takes
//   0.97-1.02 ms where the design before (a thread a slot, pad slots
//   included) took 0.91-0.94.  At C = 16 two lanes take interleaved
//   quads of each record, 8 channels each, in one pass over the volume
//   (the design before made a grid pass a group of 8 channels), and two
//   more split the cells: 3.96-3.97 ms against 4.24-4.37.  Bound at
//   config 5: the volume read once, 0.16 ms, and the rows written once,
//   0.05 (PERF.md section 6).
// * bwd (csrc/texel_scatter.cuh, shared with fused3s_bwd): a block per
//   plan block compacts its real slots (pad slots cost nothing: 30% of
//   QP at config 5) and stages their points and cotangents, and a warp's
//   lanes run over (query, cell): 2 queries x 16 cells at config 5.  Each
//   lane adds its cell's corners with float4 atomics (sm_90) at
//   C % 4 == 0, scalar ones otherwise; neighbouring lanes add
//   neighbouring 16-byte records of one texel, so a warp's reductions
//   share L2 sectors: 75 M sectors for 128 M reductions at config 5,
//   where a thread a slot over its cells (the design before) took 124 M
//   (scripts/count_brick_flush.py).  Bound: the volume written once,
//   0.20 ms at config 5 (the wrapper's zero fill, 0.18 ms, comes on top).
//   Measured 1.41-1.43 ms with the fill against the design before's 3.00
//   (C = 16: 5.67 against 12.12), the reductions ~0.2 ms of it.  A
//   block-window shared-memory accumulator flushed by the lines it
//   touched (44 M sectors, 15 M lines) was not built: it could save at
//   most part of those ~0.2 ms, after zeroing a 393 KB window per block
//   and running 128 M shared adds (compare-and-swap loops on sm_90).
//   f32 atomics: not deterministic.
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_rows.cuh"
#include "texel_gather.cuh"
#include "texel_scatter.cuh"

namespace {

// the plan's q_block: one CUDA block of this many threads per plan block
constexpr int kQBlock = 128;

// Block (bx, by): plan block bx, channels [by * groups * G, ...) of c
// (csrc/texel_gather.cuh): zeros into its pad slots, the gather into its
// real ones.
template <int G, bool VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
    blend_kernel(const float* __restrict__ vol, const float* __restrict__ pts,
                 const float* __restrict__ occ, const int* __restrict__ hasv,
                 float* __restrict__ out, int n, int c, csm::CellGeom<3> g,
                 int qp, csm::GatherLayout lay, csm::SamplerParams p) {
  const int t = threadIdx.x;
  const int slot = blockIdx.x * kQBlock + t;
  const bool real =
      t < kQBlock && hasv[blockIdx.x] != 0 && occ[slot] != 0.0f;
  if (t < kQBlock && !real) {
    const int c0 = blockIdx.y * lay.groups * G;
    const int c1 = min(c, c0 + lay.groups * G);
    for (int r = 0; r < csm::kRows<3>; ++r)
      for (int ch = c0; ch < c1; ++ch)
        out[static_cast<int64_t>(r * c + ch) * qp + slot] = 0.0f;
  }
  csm::gather_block<3, G, VEC, false>(csm::GatherQuery{real, slot}, pts, vol,
                                   out, qp, n, c, lay, g, p);
}

// Block (bx, by): plan block bx's real slots, channel groups [by *
// block_groups, ...) of c (csrc/texel_scatter.cuh).
template <int G, bool VEC>
__global__ void __launch_bounds__(csm::kScatterMaxThreads)
    bwd_kernel(const float* __restrict__ g, const float* __restrict__ pts,
               const float* __restrict__ occ, const int* __restrict__ hasv,
               float* __restrict__ dvol, int n, int c, csm::CellGeom<3> geom,
               int qp, csm::ScatterLayout lay, csm::SamplerParams p) {
  if (hasv[blockIdx.x] == 0) return;
  const int slot = blockIdx.x * kQBlock + threadIdx.x;
  const bool mine = threadIdx.x < kQBlock && occ[slot] != 0.0f;
  csm::scatter_block<3, G, VEC>(csm::ScatterQuery{mine, slot}, g, qp, pts,
                             dvol, n, c, lay, geom, p);
}

}  // namespace

extern "C" {

// The launch layout (width, groups, cell lanes) and threads a block come
// from ops/cuda/gather.py gather_geometry.
int fused3b_blend(const void* vol, const void* pts, const void* occ,
                  const void* hasv, void* out, int n, int c, int d, int h,
                  int w, int qp, int width, int groups, int cell_lanes,
                  int threads, int kernel, int padding, int align,
                  int multicell, int strict, float off_step, float off_stop,
                  void* stream) {
  static_assert(kQBlock == csm::kGatherQueries, "one plan block a block");
  if (qp % kQBlock != 0) return cudaErrorInvalidValue;
  if (qp == 0 || c == 0) return cudaGetLastError();
  const csm::GatherLayout lay{width, groups, cell_lanes};
  return csm::launch_gather(
      lay, c, threads, qp / kQBlock, static_cast<cudaStream_t>(stream),
      [](auto gw, auto vec, auto threads) {
        return &blend_kernel<decltype(gw)::value, decltype(vec)::value,
                             decltype(threads)::value>;
      },
      static_cast<const float*>(vol), static_cast<const float*>(pts),
      static_cast<const float*>(occ), static_cast<const int*>(hasv),
      static_cast<float*>(out), n, c, csm::cell_geom3(d, h, w), qp, lay,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop));
}

// dvol (D, H, W, N, C) must be zeroed.  The launch layout (width,
// block_groups, lane_groups, lanes) and threads a block come from
// ops/cuda/scatter.py scatter_geometry.
int fused3b_bwd(const void* g, const void* pts, const void* occ,
                const void* hasv, void* dvol, int n, int c, int d, int h,
                int w, int qp, int width, int block_groups, int lane_groups,
                int lanes, int threads, int kernel, int padding, int align,
                int multicell, int strict, float off_step, float off_stop,
                void* stream) {
  static_assert(kQBlock == csm::kScatterQueries, "one plan block a block");
  if (qp % kQBlock != 0) return cudaErrorInvalidValue;
  if (qp == 0 || n == 0 || c == 0) return cudaGetLastError();
  const csm::ScatterLayout lay{width, block_groups, lane_groups, lanes};
  return csm::launch_scatter<3>(
      lay, c, threads, qp / kQBlock, static_cast<cudaStream_t>(stream),
      [](auto gw, auto vec) {
        return &bwd_kernel<decltype(gw)::value, decltype(vec)::value>;
      },
      static_cast<const float*>(g), static_cast<const float*>(pts),
      static_cast<const float*>(occ), static_cast<const int*>(hasv),
      static_cast<float*>(dvol), n, c, csm::cell_geom3(d, h, w), qp, lay,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop));
}

}  // extern "C"
