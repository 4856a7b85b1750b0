// The v1 fused value/jacobian/diagonal-Hessian blend and its transpose to
// the cells, in 2D and 3D and at any channel count, for NVIDIA Hopper
// (sm_90a): a route of the fused op above 8 channels, beside fused2w /
// fused3w's channel groups (ops/cuda/route.py fused_rule).
//
// fused_v1_blend2 / fused_v1_blend3 replace the TPU kernel
//   ops/pallas/fused.py::_fused_blend_kernel of the JAX package
// fused_v1_bwd2 / fused_v1_bwd3 replace
//   ops/pallas/fused.py::_fused_bwd_kernel of the JAX package
//
// Contract (the JAX package's fused op, generic.blend per row, summed over
// the N cells):
//   blend: cells (N, C, *S) f32, points (Q, D) f32 shared by all cells ->
//          out (1 + 2D, C, Q) f32, rows value, d/dx_i, d2/dx_i2 in
//          all_orders order; grid axis 0 (x) addresses W, 1 H, 2 D.
//   bwd:   g (1 + 2D, C, Q) f32 -> dcells (N, C, *S) f32, the exact
//          transpose.
// Every padding mode and interpolant, multicell on and off, both
// align_corners, the strict-reference reflection span; any C.
//
// Design:
// * The TPU kernels loop over the cells with the whole stack resident in
//   VMEM and contract one-hot corner matrices on the MXU, because the TPU
//   has no per-lane gather.  None of that is carried over: one thread per
//   (query, channel group) walks the cells through fused_rows.cuh's corner
//   walk and gathers from global memory (a 96 x 16 x 16^2 stack, 1.6 MB,
//   sits in L2).
// * Channels: grid axis y walks groups of at most 8 channels of equal
//   width (C = 16: two of 8; C = 12: two of 6; C = 9: 5 and 4), so a
//   thread keeps (1 + 2D) x 8 sums in registers at any C.  Each group
//   redoes the per-(query, cell) coordinate math, the price of the cap.
// * bwd: groups of at most 4 channels (measured faster than 8).  A block
//   owns a chunk of cells of one channel group and a slice of the queries,
//   accumulates into a shared-memory copy of the chunk with shared atomics
//   and flushes it once with global atomicAdd (as fused2w_bwd; a 3D group
//   of 4 x 16^3 takes 64 KB, three to a block, opted in).  A group of one
//   cell over the card's opt-in limit adds straight into dcells.  The
//   slices are sized by the occupancy API so that the grid's last wave is
//   full.  The TPU bwd was deterministic; f32 atomics are not, so results
//   agree with the plain version to rounding.
#include <cuda_runtime.h>

#include "fused_rows.cuh"

namespace {

using csm::CellGeom;
using csm::kGroupChannels;
using csm::kRows;
using csm::SamplerParams;

constexpr int kBlendThreads = 128;
constexpr int kBwdThreadsSmall = 256;
constexpr int kBwdThreadsLarge = 512;
// The bwd's channel groups are narrower: groups of 4 were faster than
// groups of 8 at 96 x 16 x 16^2 and level with them at 50 x 16 x 16^3,
// their fewer cotangent registers outweighing the coordinate math each
// group redoes (PERF.md section 6).
constexpr int kBwdGroup = 4;

template <int D>
CellGeom<D> geom_of(const int* sizes) {  // sizes: W, H(, D)
  CellGeom<D> g;
  g.texels = 1;
  for (int i = 0; i < D; ++i) {
    g.size[i] = sizes[i];
    g.texels *= sizes[i];
  }
  return g;
}

// One thread per query of channel group blockIdx.y: its rows over all n
// cells, in registers.
template <int D>
__global__ void __launch_bounds__(kBlendThreads)
    v1_blend_kernel(const float* __restrict__ cells,
                    const float* __restrict__ points,
                    float* __restrict__ out, int n, int c, int cw,
                    CellGeom<D> g, int q, SamplerParams p) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const int c0 = blockIdx.y * cw;
  const int cg = min(cw, c - c0);
  float pt[D];
#pragma unroll
  for (int i = 0; i < D; ++i) pt[i] = points[D * qi + i];
  float acc[kRows<D>][kGroupChannels];
#pragma unroll
  for (int r = 0; r < kRows<D>; ++r)
#pragma unroll
    for (int j = 0; j < kGroupChannels; ++j) acc[r][j] = 0.0f;
  csm::blend_query_range<D, kGroupChannels>(
      cells + static_cast<int64_t>(c0) * g.texels,
      static_cast<int64_t>(c) * g.texels, g, 0, n, n, cg, pt, p, acc);
#pragma unroll
  for (int r = 0; r < kRows<D>; ++r)
#pragma unroll
    for (int j = 0; j < kGroupChannels; ++j)
      if (j < cg) out[static_cast<int64_t>(r * c + c0 + j) * q + qi] = acc[r][j];
}

// Block (bx, by, bz) adds queries [bx * q_per_block, ...) into cells
// [by * cells_per_chunk, ...), channels [bz * cw, ...).  SMEM: through a
// shared copy of the chunk, flushed once; otherwise straight into dcells,
// which must be zeroed.
template <int D, bool SMEM>
__global__ void __launch_bounds__(kBwdThreadsLarge)
    v1_bwd_kernel(const float* __restrict__ g,
                  const float* __restrict__ points, float* __restrict__ dcells,
                  int n, int c, int cw, CellGeom<D> geom, int q,
                  int cells_per_chunk, int q_per_block, SamplerParams p) {
  extern __shared__ float sacc[];
  const int c0 = blockIdx.z * cw;
  const int cg = min(cw, c - c0);
  const int n0 = blockIdx.y * cells_per_chunk;
  const int n1 = min(n, n0 + cells_per_chunk);
  const int64_t cell_stride = static_cast<int64_t>(c) * geom.texels;
  const int group_elems = cg * geom.texels;
  const int chunk_elems = (n1 - n0) * group_elems;
  float* chunk_out = dcells + n0 * cell_stride +
                     static_cast<int64_t>(c0) * geom.texels;
  if (SMEM) {
    for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) sacc[e] = 0.0f;
    __syncthreads();
  }

  const int q0 = blockIdx.x * q_per_block;
  const int q1 = min(q, q0 + q_per_block);
  for (int qi = q0 + threadIdx.x; qi < q1; qi += blockDim.x) {
    float gv[kRows<D>][kBwdGroup];
#pragma unroll
    for (int r = 0; r < kRows<D>; ++r)
#pragma unroll
      for (int j = 0; j < kBwdGroup; ++j)
        gv[r][j] = j < cg
                       ? __ldg(g + static_cast<int64_t>(r * c + c0 + j) * q + qi)
                       : 0.0f;
    float pt[D];
#pragma unroll
    for (int i = 0; i < D; ++i) pt[i] = points[D * qi + i];
    if (SMEM) {
      csm::splat_query_range<D, kBwdGroup>(sacc, group_elems, geom, n0,
                                                n1, n, cg, pt, p, gv);
    } else {
      csm::splat_query_range<D, kBwdGroup>(chunk_out, cell_stride, geom,
                                                n0, n1, n, cg, pt, p, gv);
    }
  }

  if (SMEM) {
    __syncthreads();
    for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) {
      const float v = sacc[e];
      if (v != 0.0f) {
        const int ln = e / group_elems;
        atomicAdd(chunk_out + ln * cell_stride + (e - ln * group_elems), v);
      }
    }
  }
}

// The number of query slices to split each (cell chunk, channel group)
// into: the fewest that keep at least 90% of the card's resident block
// slots busy over the grid's last wave (or the best of up to
// max_slices).  The flush of a slice's shared copy costs one pass over its
// chunk, so more slices than that only add flushes.
int pick_slices(int work_blocks, int slots, int max_slices) {
  int best = 1;
  double best_use = 0.0;
  for (int k = 1; k <= max_slices; ++k) {
    const int64_t total = static_cast<int64_t>(work_blocks) * k;
    const int64_t waves = (total + slots - 1) / slots;
    const double use = static_cast<double>(total) / (waves * slots);
    if (use >= 0.9) return k;
    if (use > best_use) {
      best = k;
      best_use = use;
    }
  }
  return best;
}

template <int D>
cudaError_t launch_blend(const float* cells, const float* points, float* out,
                         int n, int c, const CellGeom<D>& g, int q,
                         const SamplerParams& p, cudaStream_t stream) {
  if (q == 0 || c == 0) return cudaGetLastError();
  const dim3 grid(csm::cdiv(q, kBlendThreads), csm::channel_groups(c));
  v1_blend_kernel<D><<<grid, kBlendThreads, 0, stream>>>(
      cells, points, out, n, c, csm::group_width(c), g, q, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const float* g, const float* points, float* dcells,
                       int n, int c, const CellGeom<D>& geom, int q,
                       const SamplerParams& p, cudaStream_t stream) {
  if (q == 0 || n == 0 || c == 0 || geom.texels == 0)
    return cudaGetLastError();
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;

  // chunks of cells of one channel group: up to 48 KB, or as many groups
  // of a larger cell as the opted-in limit holds; above it global atomics
  const int cw = csm::group_width(c, kBwdGroup);
  const int groups = csm::channel_groups(c, kBwdGroup);
  const int64_t group_bytes = static_cast<int64_t>(cw) * geom.texels * 4;
  const bool smem = group_bytes <= lim.smem_optin;
  const int64_t budget = group_bytes <= csm::kStaticSmemBytes
                             ? csm::kStaticSmemBytes
                             : lim.smem_optin;
  const int cells_per_chunk =
      smem ? static_cast<int>(std::min<int64_t>(n, budget / group_bytes)) : n;
  const int chunks = csm::cdiv(n, cells_per_chunk);
  const size_t bytes =
      smem ? static_cast<size_t>(cells_per_chunk) * group_bytes : 0;
  const int threads = bytes > static_cast<size_t>(csm::kStaticSmemBytes)
                          ? kBwdThreadsLarge
                          : kBwdThreadsSmall;
  auto* kernel = smem ? &v1_bwd_kernel<D, true> : &v1_bwd_kernel<D, false>;
  err = csm::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  // the grid's waves filled (pick_slices) at the blocks an SM holds, and
  // no block with fewer queries than threads
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return err;
  const int q_blocks = pick_slices(chunks * groups,
                                   std::max(1, per_sm) * lim.sms,
                                   csm::cdiv(q, threads));
  const int q_per_block = csm::cdiv(q, q_blocks);
  const dim3 grid(csm::cdiv(q, q_per_block), chunks, groups);
  kernel<<<grid, threads, bytes, stream>>>(g, points, dcells, n, c, cw, geom,
                                           q, cells_per_chunk, q_per_block,
                                           p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The 2D and 3D entry points take fused2w's and fused3w's arguments.
int fused_v1_blend2(const void* cells, const void* points, void* out, int n,
                    int c, int h, int w, int q, int kernel, int padding,
                    int align, int multicell, int strict, float off_step,
                    float off_stop, void* stream) {
  const int sizes[2] = {w, h};
  return launch_blend<2>(
      static_cast<const float*>(cells), static_cast<const float*>(points),
      static_cast<float*>(out), n, c, geom_of<2>(sizes), q,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

int fused_v1_blend3(const void* cells, const void* points, void* out, int n,
                    int c, int d, int h, int w, int q, int kernel, int padding,
                    int align, int multicell, int strict, float off_step,
                    float off_stop, void* stream) {
  const int sizes[3] = {w, h, d};
  return launch_blend<3>(
      static_cast<const float*>(cells), static_cast<const float*>(points),
      static_cast<float*>(out), n, c, geom_of<3>(sizes), q,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

// dcells (N, C, H, W) must be zeroed.
int fused_v1_bwd2(const void* g, const void* points, void* dcells, int n,
                  int c, int h, int w, int q, int kernel, int padding,
                  int align, int multicell, int strict, float off_step,
                  float off_stop, void* stream) {
  const int sizes[2] = {w, h};
  return launch_bwd<2>(
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<float*>(dcells), n, c, geom_of<2>(sizes), q,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

// dcells (N, C, D, H, W) must be zeroed.
int fused_v1_bwd3(const void* g, const void* points, void* dcells, int n,
                  int c, int d, int h, int w, int q, int kernel, int padding,
                  int align, int multicell, int strict, float off_step,
                  float off_stop, void* stream) {
  const int sizes[3] = {w, h, d};
  return launch_bwd<3>(
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<float*>(dcells), n, c, geom_of<3>(sizes), q,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
