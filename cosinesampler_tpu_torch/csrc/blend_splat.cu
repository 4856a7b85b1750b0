// The blend_o / splat_o pair behind the public sampler and its autograd at
// every order, 2D and 3D, for NVIDIA Hopper (sm_90a).
//
// blend_o replaces the TPU kernel
//   ops/pallas/kernels.py::_blend_kernel of the JAX package
// splat_o replaces
//   ops/pallas/kernels.py::_splat_kernel
//
// Contract (the JAX package's generic.blend / generic.splat):
//   blend_o: input (N, C, *S) f32, grid (G, Q, d) f32 with G = N, or G = 1
//            for a query cloud shared by all cells, per-axis derivative
//            orders -> out (N, C, Q) f32: the 2^d corners of every
//            (cell, query) pair weighed by the interpolant's derivative of
//            order orders[i] along grid axis i, mult^k folded in.
//   splat_o: gout (N, C, Q) f32 -> out (N, C, *S) f32, the exact transpose
//            of blend_o with respect to the input.
// Grid axis i addresses spatial axis d-1-i (x -> W, y -> H, z -> D).  Zeros
// padding drops out-of-bounds corners; border and reflection fold the
// coordinate (csrc/sampler_math.cuh) and the bounds check keeps the rest.
// The strict-reference 2D order-0 align quirk is the caller's: the wrapper
// passes the align flag the gather should see (ops/config.py
// effective_align).
//
// What bounds them on the H100, and the design:
// * The TPU kernels build per-axis one-hot corner matrices and contract
//   them on the MXU, because the TPU has no per-lane gather and no
//   atomics; its (8, 128) blocks and VMEM-resident cell block do not carry
//   over.  Here each thread owns one (cell, query) pair.
// * blend_o writes N*C*Q floats and reads a cell stack that sits in the
//   50 MB L2 (96 x 4 x 16 x 16 f32 is 393 KB): at the main path it is
//   bound by writing the 154 MB output (~46 us at 3.35 TB/s).  A thread
//   computes the 2^d corner offsets and weights once and loops over the
//   channels, so there is no channel cap; consecutive threads take
//   consecutive queries of one cell, so the output stores coalesce and a
//   warp's gathers fall in one cell.
// * splat_o reads the N*C*Q cotangent once (154 MB at the main path,
//   ~46 us).  Its naive form, one global atomicAdd per (pair, corner,
//   channel), piles onto the few thousand texels of each cell.  A block
//   owns a chunk of cells in shared memory, accumulates its slice of the
//   queries there with shared-memory atomics, and flushes the chunk once.
//   Shared-memory f32 atomicAdd compiles to a compare-and-swap loop
//   (ATOMS.CAST.SPIN in the SASS), so what it costs is bank conflicts and
//   retries: with a warp's 32 lanes on 32 queries of one cell (the first
//   design), the lanes land on random words of a 1 KB channel plane.  So
//   where a chunk holds several cells (up to 8: the 2D main path's 4 KB
//   cells), a warp's lanes split over the chunk's cells: the 8 lanes of a
//   query add its corners into 8 cells whose strides (4 floats past a
//   multiple of 32) put them in 8 distinct bank quads, and no two lanes
//   of one instruction share a word; a cell's lanes take runs of 2
//   consecutive queries, 8 a warp, one 32-byte sector of cotangents.  A
//   64 KB 3D cell takes a block to itself, lanes on queries.  The flush
//   is one bulk async reduction (TMA, cp.reduce.async.bulk .add.f32) a
//   cell into out, issued by one thread: the L2 adds whole cells instead
//   of a global atomic an element (6.5 M of them at the 2D main path),
//   and blocks along the queries make three waves of the blocks the card
//   holds at once.  A cell above the card's per-block shared memory (227
//   KB on the H100) takes global atomics directly.  Tried and dropped
//   as slower (PERF.md section 6): a channel-interleaved (texel, C)
//   layout with 64- and 128-bit compare-and-swap of a corner's channels,
//   partial sums in a scratch summed by a second kernel, 32 cells a warp
//   (one block an SM), and for 64 KB 3D cells a per-block counting sort
//   of the queries by texel before the adds.
// * The TPU splat was deterministic (a sequential accumulation over query
//   blocks).  This one is not: f32 atomics add in an order that changes
//   from run to run, so results agree with the plain version to rounding,
//   not bit for bit.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bulk_copy.cuh"
#include "launch.cuh"
#include "pair_corners.cuh"

namespace {

constexpr int kBlendThreads = 256;

// One thread per (cell, query): thread t takes cell t / Q, query t % Q.
template <int D>
__global__ void __launch_bounds__(kBlendThreads)
    blend_o_kernel(const float* __restrict__ input,
                   const float* __restrict__ grid, float* __restrict__ out,
                   csm::PairShape s, csm::SamplerParams p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= s.n * s.q) return;
  const int ni = t / s.q;
  const int qi = t - ni * s.q;
  int off[1 << D];
  float wgt[1 << D];
  csm::pair_corners<D>(s, grid, ni, qi, p, off, wgt);
  const float* cell = input + static_cast<int64_t>(ni) * s.c * s.texels;
  float* dst = out + static_cast<int64_t>(ni) * s.c * s.q + qi;
  for (int c = 0; c < s.c; ++c) {
    const float* src = cell + static_cast<int64_t>(c) * s.texels;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < (1 << D); ++k)
      acc = fmaf(wgt[k], __ldg(src + off[k]), acc);
    dst[static_cast<int64_t>(c) * s.q] = acc;
  }
}

constexpr int kSplatThreads = 256;

// One launch's geometry (ops/cuda/blend_splat.py splat_geometry).
struct SplatGeom {
  int cells;  // cells a block holds in shared memory (kSmem)
  int stride;  // floats of one cell in shared memory
  int q_per_block;
  bool bulk;  // flush by bulk reductions (else a global atomic an element)
};

// Block (bx, by) accumulates queries [by * q_per_block, ...) into cells
// [bx * g.cells, ...) (kSmem: in shared memory, flushed once at the end;
// otherwise every cell, straight into out).  out must be zeroed.  Lane l
// of a warp takes cell l % kLanes of each group of kLanes cells, and
// query run l / kLanes of the warp's 32 / kLanes runs, each of
// max(1, kLanes / 4) consecutive queries: with kLanes 8, a run's 8 lanes
// add one query's corners into 8 cells whose strides put them in 8
// distinct banks, and a cell's lanes read 8 consecutive cotangents (one
// sector).
//
// In 2D with lanes over cells the registers are capped (40 a thread) so
// that six blocks, the most a 33 KB chunk of 8 cells lets an SM hold, run
// on an SM instead of four: more warps to hide the compare-and-swap
// loops' latency (PERF.md section 6).
template <int D, int kLanes, bool kSmem>
__global__ void __launch_bounds__(kSplatThreads,
                                  D == 2 && kLanes > 1 ? 6 : 1)
    splat_o_kernel(const float* __restrict__ gout,
                   const float* __restrict__ grid, float* __restrict__ out,
                   csm::PairShape s, SplatGeom g, csm::SamplerParams p) {
  extern __shared__ __align__(16) float sacc[];
  constexpr int kRuns = 32 / kLanes;
  constexpr int kRunLen = kLanes >= 4 ? kLanes / 4 : 1;
  const int cell_elems = s.c * s.texels;
  const int n0 = kSmem ? blockIdx.x * g.cells : 0;
  const int n1 = kSmem ? min(s.n, n0 + g.cells) : s.n;
  const int stride = kSmem ? g.stride : cell_elems;
  if (kSmem) {
    const int elems = (n1 - n0) * stride;
    float4* acc4 = reinterpret_cast<float4*>(sacc);
    for (int e = threadIdx.x; e < elems / 4; e += kSplatThreads)
      acc4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int e = elems / 4 * 4 + threadIdx.x; e < elems; e += kSplatThreads)
      sacc[e] = 0.0f;
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane % kLanes, lj = lane / kLanes;
  const int q0 = blockIdx.y * g.q_per_block;
  const int q1 = min(s.q, q0 + g.q_per_block);
  for (int qa = q0 + (warp * kRuns + lj) * kRunLen; qa < q1;
       qa += (kSplatThreads / 32) * kRuns * kRunLen) {
    for (int ni = n0 + li; ni < n1; ni += kLanes) {
      float* cell = kSmem ? sacc + (ni - n0) * stride
                          : out + static_cast<int64_t>(ni) * cell_elems;
      const float* g_cell = gout + static_cast<int64_t>(ni) * s.c * s.q;
      // not unrolled: two pairs' corners at once take more registers than
      // four blocks an SM leave a thread
#pragma unroll 1
      for (int r = 0; r < kRunLen; ++r) {
        const int qi = qa + r;
        if (qi >= q1) break;
        int off[1 << D];
        float wgt[1 << D];
        csm::pair_corners<D>(s, grid, ni, qi, p, off, wgt);
        for (int c = 0; c < s.c; ++c) {
          const float gv = __ldg(g_cell + static_cast<int64_t>(c) * s.q + qi);
          float* dst = cell + c * s.texels;
#pragma unroll
          for (int k = 0; k < (1 << D); ++k)
            if (wgt[k] != 0.0f) atomicAdd(dst + off[k], wgt[k] * gv);
        }
      }
    }
  }
  if (!kSmem) return;

  float* dst = out + static_cast<int64_t>(n0) * cell_elems;
  if (g.bulk) {
    // the shared-memory atomics are generic-proxy writes: fence them
    // before the async proxy reads the accumulator; one bulk reduction a
    // cell (cell_elems, stride and out 16-byte aligned: the launch checks)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int ln = 0; ln < n1 - n0; ++ln)
        csm::bulk_reduce_add(dst + static_cast<int64_t>(ln) * cell_elems,
                             sacc + ln * stride,
                             static_cast<uint32_t>(cell_elems) * 4u);
      csm::bulk_store_wait();
    }
    return;
  }
  __syncthreads();
  for (int ln = 0; ln < n1 - n0; ++ln)
    for (int e = threadIdx.x; e < cell_elems; e += kSplatThreads) {
      const float v = sacc[ln * stride + e];
      if (v != 0.0f) atomicAdd(dst + static_cast<int64_t>(ln) * cell_elems + e, v);
    }
}

template <int D>
cudaError_t launch_blend(const float* input, const float* grid, float* out,
                         const csm::PairShape& s,
                         const csm::SamplerParams& p, cudaStream_t stream) {
  const int pairs = s.n * s.q;
  if (pairs == 0 || s.c == 0) return cudaGetLastError();
  blend_o_kernel<D>
      <<<csm::cdiv(pairs, kBlendThreads), kBlendThreads, 0, stream>>>(
          input, grid, out, s, p);
  return cudaGetLastError();
}

template <int D, int kLanes, bool kSmem>
cudaError_t launch_splat_kernel(const float* gout, const float* grid,
                                float* out, const csm::PairShape& s,
                                const SplatGeom& g, int q_blocks,
                                const csm::SamplerParams& p,
                                cudaStream_t stream) {
  auto* kernel = &splat_o_kernel<D, kLanes, kSmem>;
  const size_t bytes =
      kSmem ? static_cast<size_t>(g.cells) * g.stride * sizeof(float) : 0;
  cudaError_t err = csm::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int chunks = kSmem ? csm::cdiv(s.n, g.cells) : 1;
  kernel<<<dim3(chunks, q_blocks), kSplatThreads, bytes, stream>>>(
      gout, grid, out, s, g, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_splat(const float* gout, const float* grid, float* out,
                         const csm::PairShape& s, int cells, int lanes,
                         int stride, int q_per_block, int q_blocks,
                         const csm::SamplerParams& p, cudaStream_t stream) {
  if (s.n == 0 || s.q == 0 || s.c == 0 || s.texels == 0)
    return cudaGetLastError();
  const int64_t cell_elems = static_cast<int64_t>(s.c) * s.texels;
  if (cells < 0 || q_blocks < 1 || q_blocks > 65535 || q_per_block < 1 ||
      static_cast<int64_t>(q_blocks) * q_per_block < s.q ||
      (cells > 0 && stride < cell_elems) || (cells == 0 && lanes != 1))
    return cudaErrorInvalidValue;
  // bulk reductions take 16-byte aligned addresses and sizes
  const bool bulk = cell_elems % 4 == 0 && stride % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const SplatGeom g{cells, stride, q_per_block, bulk};
  if (cells == 0)
    return launch_splat_kernel<D, 1, false>(gout, grid, out, s, g, q_blocks,
                                            p, stream);
  switch (lanes) {
    case 1:
      return launch_splat_kernel<D, 1, true>(gout, grid, out, s, g, q_blocks,
                                             p, stream);
    case 2:
      return launch_splat_kernel<D, 2, true>(gout, grid, out, s, g, q_blocks,
                                             p, stream);
    case 4:
      return launch_splat_kernel<D, 4, true>(gout, grid, out, s, g, q_blocks,
                                             p, stream);
    case 8:
      return launch_splat_kernel<D, 8, true>(gout, grid, out, s, g, q_blocks,
                                             p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// d is ignored for dim == 2; orders (ox, oy, oz) per grid axis.
int blend_o(const void* input, const void* grid, void* out, int dim, int n,
            int c, int d, int h, int w, int q, int grid_batch, int ox, int oy,
            int oz, int kernel, int padding, int align, int multicell,
            int strict, float off_step, float off_stop, void* stream) {
  if (csm::bad_pair_args(dim, grid_batch, n, ox, oy, oz))
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(dim, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  const auto* in = static_cast<const float*>(input);
  const auto* gr = static_cast<const float*>(grid);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return dim == 2 ? launch_blend<2>(in, gr, o, s, p, st)
                  : launch_blend<3>(in, gr, o, s, p, st);
}

// The geometry (cells, lanes, stride, q_per_block, q_blocks) of
// ops/cuda/blend_splat.py splat_geometry; cells 0: global atomics.  out
// (N, C, *S) must be zeroed.
int splat_o(const void* gout, const void* grid, void* out, int dim, int n,
            int c, int d, int h, int w, int q, int grid_batch, int ox, int oy,
            int oz, int cells, int lanes, int stride, int q_per_block,
            int q_blocks, int kernel, int padding, int align, int multicell,
            int strict, float off_step, float off_stop, void* stream) {
  if (csm::bad_pair_args(dim, grid_batch, n, ox, oy, oz))
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(dim, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  const auto* g = static_cast<const float*>(gout);
  const auto* gr = static_cast<const float*>(grid);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return dim == 2 ? launch_splat<2>(g, gr, o, s, cells, lanes, stride,
                                    q_per_block, q_blocks, p, st)
                  : launch_splat<3>(g, gr, o, s, cells, lanes, stride,
                                    q_per_block, q_blocks, p, st);
}

}  // extern "C"
