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
//   over.  Here threads own (cell, query) pairs.
// * blend_o writes N*C*Q floats (154 MB at the 2D main path, ~46 us at
//   3.35 TB/s; 80 MB at the 3D main shape, 50 x 4 x 16^3, ~24 us) and
//   reads a cell stack that sits in the 50 MB L2.  Its first design, one
//   thread per (cell, query) pair gathering the 2^d x C corner values
//   through L1/L2 (blend_o_kernel), took 0.146 ms in 2D and 0.209 in 3D
//   (H100 80GB HBM3, 700.00 W), where a pair makes 32 scalar gathers.
//   Where a cell fits a block's shared memory and has enough queries
//   (blend_o_staged_kernel), a block
//   stages its cells (4 of the 2D main path's 4 KB cells, one 64 KB 3D
//   cell) and takes every q_blocks-th round of 512 queries: a thread
//   takes one query of a round and its cells, the corners come from
//   shared memory, and the stores of a warp fall on consecutive queries
//   of one cell.  Channels are interleaved per texel where C is a
//   multiple of 4 (staged with 128-bit reads), so one 128-bit shared load
//   serves a corner's 4 channels: 8 loads a 3D pair instead of 32 (other
//   C: channel planes, staged with bulk async copies).  Blocks of 512
//   threads, two an SM, in one wave.  What bounds it: in 2D the stores,
//   which alone took 0.093 ms against 0.050 for a fill of the same 154 MB
//   (the same card): a block writes 16 rows of the (N, C, Q) output at
//   once.  Rounds interleaved across the blocks along the queries, so
//   that the card's stores at any moment fall in a narrow window of each
//   row, read 4% faster than contiguous query slices; streaming stores,
//   runs of queries a warp and other block sizes read the same or
//   slower.  In 3D the per-pair coordinate math bounds it (0.13 ms
//   without the stores at 256 threads a block).  PERF.md section 6 has
//   the times (chip_smoke.py blend_sweep_phase).  Cells that do not fit,
//   or have fewer queries than texels (where the gathers touch less than
//   a whole cell), keep the first design.
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

// dynamic shared memory ahead of the staged blend's cells: its mbarrier,
// padded so that the cells stay 16-byte aligned for the bulk copies
constexpr int kBarrierBytes = 16;
// the staged blend's threads a block, and the blocks an SM that its
// registers allow (64 a thread); shared memory may allow fewer
// (ops/cuda/blend_splat.py blend_geometry)
constexpr int kStagedThreads = 512;
constexpr int kStagedBlocksPerSm = 2;

// One staged blend_o launch's geometry (ops/cuda/blend_splat.py
// blend_geometry).
struct BlendGeom {
  int cells;        // cells a block stages
  int stride;       // floats of one cell in shared memory (a multiple of 4)
  bool bulk;        // planes staged by bulk async copies (16-byte aligned)
};

// Block (bx, by) stages cells [bx * g.cells, ...) in shared memory and
// blends rounds by, by + gridDim.y, ... of kStagedThreads queries of
// each (the blocks along the queries interleave, so the card's stores at
// any moment fall in a narrow window of each output row): a thread takes
// one query of a round and walks the block's cells, so the stores of a
// warp fall on consecutive queries of one cell.  V 0: channel planes as in
// global memory (bulk-copied where aligned); V 4: the channels of a texel
// side by side (C a multiple of 4), one 128-bit shared load a corner and
// 4 channels.
template <int D, int V>
__global__ void __launch_bounds__(kStagedThreads, kStagedBlocksPerSm)
    blend_o_staged_kernel(const float* __restrict__ input,
                          const float* __restrict__ grid,
                          float* __restrict__ out, csm::PairShape s,
                          BlendGeom g, csm::SamplerParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* scells = reinterpret_cast<float*>(smem + kBarrierBytes);
  const int cell_elems = s.c * s.texels;
  const int n0 = blockIdx.x * g.cells;
  const int n1 = min(s.n, n0 + g.cells);
  const float* src = input + static_cast<int64_t>(n0) * cell_elems;
  const bool bulk = V == 0 && g.bulk;
  if (bulk) {
    if (threadIdx.x == 0) {
      csm::barrier_init(bar);
      const uint32_t bytes = static_cast<uint32_t>(cell_elems) * 4u;
      csm::barrier_expect(bar, bytes * (n1 - n0));
      for (int ln = 0; ln < n1 - n0; ++ln)
        csm::bulk_load(scells + ln * g.stride,
                       src + static_cast<int64_t>(ln) * cell_elems, bytes,
                       bar);
    }
  } else if (V == 0) {
    for (int e = threadIdx.x; e < (n1 - n0) * cell_elems; e += blockDim.x) {
      const int ln = e / cell_elems;
      scells[ln * g.stride + (e - ln * cell_elems)] = __ldg(src + e);
    }
  } else {
    // 128-bit reads of 4 consecutive elements (C % 4 == 0, so a cell's
    // elements and src are 16-byte aligned), several in flight a thread,
    // written texel-major
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int e4 = threadIdx.x; e4 < (n1 - n0) * cell_elems / 4;
         e4 += blockDim.x) {
      const float4 v = __ldg(src4 + e4);
      const int ln = 4 * e4 / cell_elems;
      const int r = 4 * e4 - ln * cell_elems;
      int c = r / s.texels;
      int t = r - c * s.texels;
      float* dst = scells + ln * g.stride;
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dst[t * s.c + c] = vals[j];
        if (++t == s.texels) {
          t = 0;
          ++c;
        }
      }
    }
  }
  __syncthreads();

  // every thread waits for the copies before its first shared load
  bool staged = !bulk;
  for (int qi = blockIdx.y * blockDim.x + threadIdx.x; qi < s.q;
       qi += gridDim.y * blockDim.x) {
    for (int ln = 0; ln < n1 - n0; ++ln) {
      const int ni = n0 + ln;
      int off[1 << D];
      float wgt[1 << D];
      csm::pair_corners<D>(s, grid, ni, qi, p, off, wgt);
      if (!staged) {
        csm::barrier_wait(bar, 0);
        staged = true;
      }
      const float* cell = scells + ln * g.stride;
      float* dst = out + static_cast<int64_t>(ni) * s.c * s.q + qi;
      if (V == 0) {
        for (int c = 0; c < s.c; ++c) {
          const float* src_c = cell + c * s.texels;
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < (1 << D); ++k)
            acc = fmaf(wgt[k], src_c[off[k]], acc);
          dst[static_cast<int64_t>(c) * s.q] = acc;
        }
      } else {
        for (int c = 0; c < s.c; c += 4) {
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int k = 0; k < (1 << D); ++k) {
            const float4 v =
                *reinterpret_cast<const float4*>(cell + off[k] * s.c + c);
            acc.x = fmaf(wgt[k], v.x, acc.x);
            acc.y = fmaf(wgt[k], v.y, acc.y);
            acc.z = fmaf(wgt[k], v.z, acc.z);
            acc.w = fmaf(wgt[k], v.w, acc.w);
          }
          dst[static_cast<int64_t>(c) * s.q] = acc.x;
          dst[static_cast<int64_t>(c + 1) * s.q] = acc.y;
          dst[static_cast<int64_t>(c + 2) * s.q] = acc.z;
          dst[static_cast<int64_t>(c + 3) * s.q] = acc.w;
        }
      }
    }
  }
  // a block whose threads had no pair must not exit with copies in flight
  if (!staged) csm::barrier_wait(bar, 0);
}

template <int D, int V>
cudaError_t launch_blend_staged(const float* input, const float* grid,
                                float* out, const csm::PairShape& s,
                                const BlendGeom& g, int q_blocks,
                                const csm::SamplerParams& p,
                                cudaStream_t stream) {
  auto* kernel = &blend_o_staged_kernel<D, V>;
  const size_t bytes = kBarrierBytes +
                       static_cast<size_t>(g.cells) * g.stride * sizeof(float);
  cudaError_t err = csm::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(csm::cdiv(s.n, g.cells), q_blocks), kStagedThreads, bytes,
           stream>>>(input, grid, out, s, g, p);
  return cudaGetLastError();
}

// cells 0: the unstaged kernel (one thread per pair, corners gathered
// through L1/L2); otherwise the staged kernel in the given layout.
template <int D>
cudaError_t launch_blend(const float* input, const float* grid, float* out,
                         const csm::PairShape& s, int cells, int interleave,
                         int stride, int q_blocks,
                         const csm::SamplerParams& p, cudaStream_t stream) {
  const int pairs = s.n * s.q;
  if (pairs == 0 || s.c == 0) return cudaGetLastError();
  if (cells == 0) {
    blend_o_kernel<D>
        <<<csm::cdiv(pairs, kBlendThreads), kBlendThreads, 0, stream>>>(
            input, grid, out, s, p);
    return cudaGetLastError();
  }
  const int64_t cell_elems = static_cast<int64_t>(s.c) * s.texels;
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  if (cells < 0 || stride < cell_elems || stride % 4 != 0 || q_blocks < 1 ||
      q_blocks > 65535 || (interleave && s.c % 4 != 0) ||
      kBarrierBytes + 4 * static_cast<int64_t>(cells) * stride >
          lim.smem_optin)
    return cudaErrorInvalidValue;
  // bulk copies take 16-byte aligned addresses and sizes
  const bool bulk = cell_elems % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(input) % 16 == 0;
  if (interleave && reinterpret_cast<uintptr_t>(input) % 16 != 0)
    interleave = 0;  // the channels' 128-bit reads take aligned cells
  const BlendGeom g{cells, stride, bulk};
  return interleave ? launch_blend_staged<D, 4>(input, grid, out, s, g,
                                                q_blocks, p, stream)
                    : launch_blend_staged<D, 0>(input, grid, out, s, g,
                                                q_blocks, p, stream);
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

// d is ignored for dim == 2; orders (ox, oy, oz) per grid axis.  The
// geometry (cells, interleave, stride, q_blocks) of
// ops/cuda/blend_splat.py blend_geometry; cells 0: the unstaged kernel.
int blend_o(const void* input, const void* grid, void* out, int dim, int n,
            int c, int d, int h, int w, int q, int grid_batch, int ox, int oy,
            int oz, int cells, int interleave, int stride, int q_blocks,
            int kernel, int padding, int align, int multicell, int strict,
            float off_step, float off_stop, void* stream) {
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
  return dim == 2 ? launch_blend<2>(in, gr, o, s, cells, interleave, stride,
                                    q_blocks, p, st)
                  : launch_blend<3>(in, gr, o, s, cells, interleave, stride,
                                    q_blocks, p, st);
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
