// The small-cloud fused 2D blend and its transpose to the cells, for
// NVIDIA Hopper (sm_90a): value, d/dx, d/dy, d2/dx2, d2/dy2 summed over the
// multicell ensemble, served from a copy of the cell stack staged in shared
// memory.
//
// fused2d_blend replaces the TPU kernel
//   ops/pallas/fused2d.py::_fused2_blend_kernel of the JAX package
// fused2d_bwd replaces
//   ops/pallas/fused2d.py::_fused2_bwd_kernel of the JAX package
//
// Contract (fused2w's: the JAX package's fused op at dim 2):
//   blend: cells (N, C, H, W) f32, points (Q, 2) f32 shared by all cells ->
//          out (5, C, Q) f32.
//   bwd:   g (5, C, Q) f32 -> dcells (N, C, H, W) f32, the exact transpose.
// Zeros, border and reflection padding (the JAX kernels' wide set), every
// interpolant, multicell on and off, both align_corners; any C, a channel
// group of one cell (at most 8 channels) within a block's opted-in shared
// memory.
//
// Design:
// * The TPU kernels keep the whole stack in VMEM and gather each query's
//   shared 3x3 (4x4 with reflection) texel patch through nine one-hot MXU
//   contractions.  Hopper gathers per lane, so the patch and the one-hot
//   panels go: a thread per query walks its corners in a shared-memory copy
//   of the cells.
// * Small clouds (the JAX route: fewer than 2048 queries) give few query
//   blocks, so the cells are split too: block (bx, by, bz) serves queries
//   [bx * 128, ...) from a chunk of cells [by * cells_per_chunk, ...) of
//   channel group bz, staged once with coalesced loads.  The 96 x 4 x 16^2
//   stack is 393 KB, over the 227 KB a block gets, and a chunk of 4 cells
//   (16 KB) leaves room for several blocks an SM.  With more than one
//   chunk the blocks add their partial rows into the zeroed output with
//   f32 atomics, so the blend is not bit-deterministic.
// * bwd: the block accumulates its queries' cotangent into a zeroed shared
//   copy of its chunk with shared atomics and flushes it once with global
//   atomicAdd.  f32 atomics: not deterministic.
#include <cuda_runtime.h>

#include "fused_rows.cuh"

namespace {

using csm::CellGeom;
using csm::kGroupChannels;
using csm::SamplerParams;

constexpr int kThreads = 128;
// fewest cells a chunk stages, so that staging a chunk is paid by the
// work it serves
constexpr int kMinChunkCells = 4;

struct Plan {
  int cw;           // channel group width
  int groups;       // channel groups
  int cells_per_chunk;
  int chunks;
  int q_blocks;
  int q_per_block;
  size_t bytes;     // dynamic shared memory of a block
};

// Chunks of at most 48 KB (or one cell group up to the opted-in limit),
// small enough that the grid fills the card twice over where the cells
// allow it.
cudaError_t make_plan(int n, int c, int texels, int q, Plan* plan) {
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  plan->cw = csm::group_width(c);
  plan->groups = csm::channel_groups(c);
  const int64_t group_bytes = static_cast<int64_t>(plan->cw) * texels * 4;
  if (group_bytes > lim.smem_optin) return cudaErrorInvalidValue;
  const int fit = static_cast<int>(std::max<int64_t>(
      1, csm::kStaticSmemBytes / group_bytes));
  const int q_tiles = csm::cdiv(q, kThreads);
  const int want_chunks =
      csm::cdiv(2 * lim.sms, std::max(1, q_tiles * plan->groups));
  const int cells = std::max(kMinChunkCells, csm::cdiv(n, want_chunks));
  plan->cells_per_chunk = std::min(n, std::min(fit, cells));
  plan->chunks = csm::cdiv(n, plan->cells_per_chunk);
  plan->q_blocks = std::max(
      1, std::min(q_tiles, csm::cdiv(2 * lim.sms,
                                     plan->chunks * plan->groups)));
  plan->q_per_block = csm::cdiv(q, plan->q_blocks);
  plan->q_blocks = csm::cdiv(q, plan->q_per_block);
  plan->bytes = static_cast<size_t>(plan->cells_per_chunk) * group_bytes;
  return cudaSuccess;
}

// Stages cells [n0, n1), channels [c0, c0 + cg) into s as (cell, channel,
// texel), coalesced.
__device__ __forceinline__ void stage(const float* __restrict__ cells,
                                      float* s, int n0, int n1, int c, int c0,
                                      int cg, int texels) {
  const int group_elems = cg * texels;
  const int elems = (n1 - n0) * group_elems;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int ln = e / group_elems;
    s[e] = cells[(static_cast<int64_t>(n0 + ln) * c + c0) * texels +
                 (e - ln * group_elems)];
  }
}

// ATOMIC: add the partial rows into out (zeroed); otherwise store them.
template <bool ATOMIC>
__global__ void __launch_bounds__(kThreads)
    blend_kernel(const float* __restrict__ cells,
                 const float* __restrict__ points, float* __restrict__ out,
                 int n, int c, int cw, CellGeom<2> g, int q,
                 int cells_per_chunk, int q_per_block, SamplerParams p) {
  extern __shared__ float scells[];
  const int c0 = blockIdx.z * cw;
  const int cg = min(cw, c - c0);
  const int n0 = blockIdx.y * cells_per_chunk;
  const int n1 = min(n, n0 + cells_per_chunk);
  stage(cells, scells, n0, n1, c, c0, cg, g.texels);
  __syncthreads();
  const int q1 = min(q, static_cast<int>(blockIdx.x + 1) * q_per_block);
  for (int qi = blockIdx.x * q_per_block + threadIdx.x; qi < q1;
       qi += blockDim.x) {
    const float pt[2] = {points[2 * qi], points[2 * qi + 1]};
    float acc[5][kGroupChannels];
#pragma unroll
    for (int r = 0; r < 5; ++r)
#pragma unroll
      for (int j = 0; j < kGroupChannels; ++j) acc[r][j] = 0.0f;
    csm::blend_query_range<2, kGroupChannels>(scells, cg * g.texels, g, n0,
                                              n1, n, cg, pt, p, acc);
#pragma unroll
    for (int r = 0; r < 5; ++r)
#pragma unroll
      for (int j = 0; j < kGroupChannels; ++j) {
        if (j < cg) {
          float* o = out + static_cast<int64_t>(r * c + c0 + j) * q + qi;
          if (ATOMIC) {
            atomicAdd(o, acc[r][j]);
          } else {
            *o = acc[r][j];
          }
        }
      }
  }
}

// dcells must be zeroed.
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const float* __restrict__ g, const float* __restrict__ points,
               float* __restrict__ dcells, int n, int c, int cw,
               CellGeom<2> geom, int q, int cells_per_chunk, int q_per_block,
               SamplerParams p) {
  extern __shared__ float sacc[];
  const int c0 = blockIdx.z * cw;
  const int cg = min(cw, c - c0);
  const int n0 = blockIdx.y * cells_per_chunk;
  const int n1 = min(n, n0 + cells_per_chunk);
  const int group_elems = cg * geom.texels;
  const int chunk_elems = (n1 - n0) * group_elems;
  for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) sacc[e] = 0.0f;
  __syncthreads();
  const int q1 = min(q, static_cast<int>(blockIdx.x + 1) * q_per_block);
  for (int qi = blockIdx.x * q_per_block + threadIdx.x; qi < q1;
       qi += blockDim.x) {
    float gv[5][kGroupChannels];
#pragma unroll
    for (int r = 0; r < 5; ++r)
#pragma unroll
      for (int j = 0; j < kGroupChannels; ++j)
        gv[r][j] = j < cg
                       ? __ldg(g + static_cast<int64_t>(r * c + c0 + j) * q + qi)
                       : 0.0f;
    const float pt[2] = {points[2 * qi], points[2 * qi + 1]};
    csm::splat_query_range<2, kGroupChannels>(sacc, group_elems, geom, n0, n1,
                                              n, cg, pt, p, gv);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) {
    const float v = sacc[e];
    if (v != 0.0f) {
      const int ln = e / group_elems;
      atomicAdd(dcells + (static_cast<int64_t>(n0 + ln) * c + c0) *
                             geom.texels + (e - ln * group_elems), v);
    }
  }
}

CellGeom<2> geom2(int h, int w) {
  CellGeom<2> g;
  g.size[0] = w;
  g.size[1] = h;
  g.texels = h * w;
  return g;
}

}  // namespace

extern "C" {

int fused2d_blend(const void* cells, const void* points, void* out, int n,
                  int c, int h, int w, int q, int kernel, int padding,
                  int align, int multicell, int strict, float off_step,
                  float off_stop, void* stream) {
  if (q == 0 || c == 0) return cudaGetLastError();
  const SamplerParams p = csm::make_params(kernel, padding, align, multicell,
                                           strict, off_step, off_stop);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = static_cast<size_t>(5) * c * q * sizeof(float);
  if (n == 0) return cudaMemsetAsync(out, 0, out_bytes, s);
  Plan plan;
  cudaError_t err = make_plan(n, c, h * w, q, &plan);
  if (err != cudaSuccess) return err;
  const dim3 grid(plan.q_blocks, plan.chunks, plan.groups);
  const auto* x = static_cast<const float*>(cells);
  const auto* pts = static_cast<const float*>(points);
  auto* o = static_cast<float*>(out);
  if (plan.chunks > 1) {
    err = cudaMemsetAsync(out, 0, out_bytes, s);
    if (err != cudaSuccess) return err;
    auto* kernel_fn = &blend_kernel<true>;
    err = csm::allow_smem(kernel_fn, plan.bytes);
    if (err != cudaSuccess) return err;
    kernel_fn<<<grid, kThreads, plan.bytes, s>>>(
        x, pts, o, n, c, plan.cw, geom2(h, w), q, plan.cells_per_chunk,
        plan.q_per_block, p);
  } else {
    auto* kernel_fn = &blend_kernel<false>;
    err = csm::allow_smem(kernel_fn, plan.bytes);
    if (err != cudaSuccess) return err;
    kernel_fn<<<grid, kThreads, plan.bytes, s>>>(
        x, pts, o, n, c, plan.cw, geom2(h, w), q, plan.cells_per_chunk,
        plan.q_per_block, p);
  }
  return cudaGetLastError();
}

// dcells (N, C, H, W) must be zeroed.
int fused2d_bwd(const void* g, const void* points, void* dcells, int n,
                int c, int h, int w, int q, int kernel, int padding, int align,
                int multicell, int strict, float off_step, float off_stop,
                void* stream) {
  if (q == 0 || n == 0 || c == 0 || h * w == 0) return cudaGetLastError();
  const SamplerParams p = csm::make_params(kernel, padding, align, multicell,
                                           strict, off_step, off_stop);
  Plan plan;
  cudaError_t err = make_plan(n, c, h * w, q, &plan);
  if (err != cudaSuccess) return err;
  err = csm::allow_smem(&bwd_kernel, plan.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(plan.q_blocks, plan.chunks, plan.groups);
  bwd_kernel<<<grid, kThreads, plan.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<float*>(dcells), n, c, plan.cw, geom2(h, w), q,
      plan.cells_per_chunk, plan.q_per_block, p);
  return cudaGetLastError();
}

}  // extern "C"
