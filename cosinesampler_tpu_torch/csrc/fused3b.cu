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
// * Channels: the blend's grid axis y walks channel groups of at most 8
//   (fused_rows.cuh channel_groups / group_width, as csrc/fused.cu),
//   whose rows a thread keeps in registers; one group, the whole stack,
//   up to 8 channels.  A group of a multiple of 4 channels in a stack of
//   a multiple of 4 starts 16-byte aligned and keeps the vector loads
//   (C = 16: two groups of 8).  The bwd's channel groups and lanes:
//   ops/cuda/scatter.py scatter_geometry.
// * blend: one CUDA block per plan block, one thread per slot, looping
//   over the N cells with the per-query corner walk of fused_rows.cuh in
//   its FMA order (the slot's rows equal fused3w_blend's for the same
//   point).  1M x 16 x 8 corners x 4 ch x 7 rows FMAs: bound by
//   operations near 0.1 ms; the volume read once is 0.16 ms.
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
#include "texel_scatter.cuh"

namespace {

// the plan's q_block: one CUDA block of this many threads per plan block
constexpr int kQBlock = 128;

// v[k] = src[k], k < cg (cg <= G); 16-byte loads when the group is
// full and G and the stack's channel count are multiples of 4 (the offset
// (texel * N + cell) * C + c0 is then 16-byte aligned).
template <int G>
__device__ __forceinline__ void load_channels(const float* __restrict__ src,
                                              bool vec, int cg,
                                              float (&v)[G]) {
  if constexpr (G % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < G; k += 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src + k));
        v[k] = q.x;
        v[k + 1] = q.y;
        v[k + 2] = q.z;
        v[k + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < G; ++k) v[k] = k < cg ? __ldg(src + k) : 0.0f;
}

// Block (bx, by): plan block bx, channels [by * G, by * G + cg) of c.
// ONE: c == G, one group (C <= 8), whose channel count, width and vector
// loads are compile-time constants.
template <int G, bool ONE>
__global__ void __launch_bounds__(kQBlock)
    blend_kernel(const float* __restrict__ vol, const float* __restrict__ pts,
                 const float* __restrict__ occ, const int* __restrict__ hasv,
                 float* __restrict__ out, int n, int c, csm::CellGeom<3> g,
                 int qp, csm::SamplerParams p) {
  constexpr int R = csm::kRows<3>;
  const int slot = blockIdx.x * kQBlock + threadIdx.x;
  const int cs = ONE ? G : c;
  const int c0 = ONE ? 0 : blockIdx.y * G;
  const int cg = ONE ? G : min(G, c - c0);
  const bool vec = ONE ? G % 4 == 0 : cg == G && c % 4 == 0;
  float acc[R][G];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < G; ++j) acc[r][j] = 0.0f;
  if (hasv[blockIdx.x] != 0 && occ[slot] != 0.0f) {
    const float pt[3] = {pts[3 * slot], pts[3 * slot + 1], pts[3 * slot + 2]};
    for (int ni = 0; ni < n; ++ni) {
      csm::for_each_corner<3>(
          g, pt, ni, n, p, [&](int idx, const float (&wr)[R]) {
            float v[G];
            load_channels<G>(
                vol + (static_cast<int64_t>(idx) * n + ni) * cs + c0, vec, cg,
                v);
#pragma unroll
            for (int j = 0; j < G; ++j)
#pragma unroll
              for (int r = 0; r < R; ++r)
                acc[r][j] = fmaf(wr[r], v[j], acc[r][j]);
          });
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < cg)
        out[static_cast<int64_t>(r * cs + c0 + j) * qp + slot] = acc[r][j];
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
  csm::scatter_block<G, VEC>(csm::ScatterQuery{mine, slot}, g, qp, pts,
                             dvol, n, c, lay, geom, p);
}

}  // namespace

extern "C" {

int fused3b_blend(const void* vol, const void* pts, const void* occ,
                  const void* hasv, void* out, int n, int c, int d, int h,
                  int w, int qp, int kernel, int padding, int align,
                  int multicell, int strict, float off_step, float off_stop,
                  void* stream) {
  if (qp % kQBlock != 0) return cudaErrorInvalidValue;
  if (qp == 0 || c == 0) return cudaGetLastError();
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  const dim3 grid(qp / kQBlock, csm::channel_groups(c));
  return csm::dispatch_channels(csm::group_width(c), [&](auto gw) {
    constexpr int G = decltype(gw)::value;
    auto* kernel_fn = c == G ? &blend_kernel<G, true>
                             : &blend_kernel<G, false>;
    kernel_fn<<<grid, kQBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vol), static_cast<const float*>(pts),
        static_cast<const float*>(occ), static_cast<const int*>(hasv),
        static_cast<float*>(out), n, c, csm::cell_geom3(d, h, w), qp, p);
    return cudaGetLastError();
  });
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
  return csm::launch_scatter(
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
