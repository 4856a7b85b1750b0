// Slab-decomposed blend_o / splat_o over pairs binned by (cell, slab), for
// volumes too large for one block's shared memory, 2D and 3D, for NVIDIA
// Hopper (sm_90a).
//
// slab_blend replaces the TPU kernel
//   ops/pallas/slab.py::_blend_slab_kernel of the JAX package
// slab_splat replaces
//   ops/pallas/slab.py::_splat_slab_kernel
// slab_bins builds the bins both walk (the JAX route bins nothing).
//
// Contract (the blend_o / splat_o contract of csrc/blend_splat.cu):
//   input (N, C, *S) f32 with S = (D, H, W) or (H, W), grid (G, Q, d) f32
//   with G = N or 1, per-axis derivative orders, and the slab geometry
//   (dz, cc) of ops/cuda/slab.py: the leading spatial axis is cut into
//   slabs of dz rows and the channels into chunks of cc.  When the axis
//   takes more than one slab, the bins of slab_bins: perm (N * Q,) int32,
//   the pair n * Q + q of each slot, ordered by (cell, floor row of the
//   leading axis clamped to [0, D)), and starts (N * D + 1,) int32, the
//   first slot of each (cell, row).  With one slab they are null and a
//   cell's slots are its pairs in query order.
//   slab_blend: -> out (N, C, Q) f32 in query order, equal bit for bit to
//               blend_o's.
//   slab_splat: gout (N, C, Q) f32 -> out (N, C, *S) f32, the transpose.
//               Every element of out is written, so it needs no zeroing.
//   slab_bins:  grid -> perm and starts; starts must be zeroed.  A
//               cell's rows must fit one block's shared-memory histogram.
//
// What bounds them on the H100, and the design:
// * The bytes: the blend must stage the volume (each block its slab plus
//   a one-row halo, 0.8 GB for the 537 MB nested 128^3 volume at dz = 2),
//   the splat must write it once (537 MB); the pairs' coordinates and
//   cotangents are read once per block that serves them.
// * Block (slab, chunk, cell) owns the rows [z0, z0 + dz) of cc channels
//   of one cell.  It walks only its own slots: the blend the bin of its
//   slab (a pair's corner rows are its floor row and the next, both in the
//   staged window), the splat the bins of floor rows z0 - 1 to
//   z0 + dz - 1 (the pairs with a corner row in its slab), a contiguous
//   range of slots.  Each output element is written once: the blend's
//   pairs by one block each, the splat's slab accumulated in shared memory
//   with shared-memory atomics and stored once (the slabs tile the volume).
// * The blend stages its window with 1D bulk async copies (TMA), one per
//   channel, issued by one thread and completing on an mbarrier, while
//   every thread loads its first pair's coordinates and computes its
//   corners.  Rows whose bytes are not a multiple of 16 (or a window that
//   leaves no room for the barrier) are copied by the block's threads.
//   A block whose bin is empty stages nothing.  The splat stores its slab
//   with 1D bulk async copies from shared memory where the rows allow.
// * slab_bins is csrc/pair_bins.cuh's counting sort with no host sync,
//   keyed by the (cell, row) of csrc/pair_corners.cuh's floor, the one
//   the blend and splat walk, so a pair's bin always holds its corner
//   rows.  Its order within a bin is that of its atomics: not
//   deterministic, which moves no blend value and only the splat's
//   (already unordered) summation.
// * The TPU kernels' one-hot MXU contractions, sublane-multiple slab
//   heights, zero-initialised accumulation over a sequential grid axis and
//   evaluation of every query against every slab do not carry over.
// * The splat's shared-memory atomics add in no fixed order: not
//   deterministic.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bulk_copy.cuh"
#include "launch.cuh"
#include "pair_bins.cuh"
#include "pair_corners.cuh"

namespace {

constexpr int kSlabThreads = 512;
// a splat block that has an SM to itself (over half its shared memory)
// takes twice the threads, to hide its gathers' latency
constexpr int kWideSplatThreads = 1024;
// dynamic shared memory ahead of the blend's window: its mbarrier, padded
// so that the window stays 16-byte aligned for the bulk copies
constexpr int kBarrierBytes = 16;

// --- the block's slab and its slots -------------------------------------

// Slab geometry of one block: slab (blockIdx.x), channel chunk
// (blockIdx.y), cell (blockIdx.z).
template <int D>
struct SlabBlock {
  int depth;  // rows of the leading axis
  int row;    // elements of one row: H * W (3D) or W (2D)
  int z0, c0, cn, ni;

  __device__ SlabBlock(const csm::PairShape& s, int dz, int cc) {
    depth = s.size[D - 1];
    row = s.stride[D - 1];
    z0 = blockIdx.x * dz;
    c0 = blockIdx.y * cc;
    cn = min(cc, s.c - c0);
    ni = blockIdx.z;
  }

  // The slots [*first, *last) of the pairs whose floor row lies in
  // [lo, hi): the bins' range, or the whole cell without bins.
  __device__ void slots(const csm::PairShape& s, const int* starts, int lo,
                        int hi, int* first, int* last) const {
    if (starts == nullptr) {
      *first = ni * s.q;
      *last = *first + s.q;
    } else {
      *first = __ldg(starts + ni * depth + max(lo, 0));
      *last = __ldg(starts + ni * depth + min(hi, depth));
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kSlabThreads)
    slab_blend_kernel(const float* __restrict__ input,
                      const float* __restrict__ grid,
                      const int* __restrict__ perm,
                      const int* __restrict__ starts,
                      float* __restrict__ out, csm::PairShape s, int dz,
                      int cc, csm::SamplerParams p, bool bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* win = reinterpret_cast<float*>(smem + (bulk ? kBarrierBytes : 0));
  const SlabBlock<D> b(s, dz, cc);
  int first, last;
  b.slots(s, starts, b.z0, b.z0 + dz, &first, &last);
  if (first == last) return;  // an empty bin stages nothing

  // rows [z0, z0 + dz] of the chunk: the slab and its one-row halo
  const int rows = min(dz + 1, b.depth - b.z0);
  const int win_elems = rows * b.row;
  const float* src = input +
                     (static_cast<int64_t>(b.ni) * s.c + b.c0) * s.texels +
                     static_cast<int64_t>(b.z0) * b.row;
  if (bulk) {
    if (threadIdx.x == 0) {
      csm::barrier_init(bar);
      const uint32_t bytes = static_cast<uint32_t>(win_elems) * 4u;
      csm::barrier_expect(bar, bytes * b.cn);
      for (int c = 0; c < b.cn; ++c)
        csm::bulk_load(win + c * win_elems, src + static_cast<int64_t>(c) * s.texels,
                  bytes, bar);
    }
    __syncthreads();
  } else {
    for (int c = 0; c < b.cn; ++c)
      for (int e = threadIdx.x; e < win_elems; e += blockDim.x)
        win[c * win_elems + e] =
            __ldg(src + static_cast<int64_t>(c) * s.texels + e);
    __syncthreads();
  }

  // thread 0 always has a slot, so it waits for the copies before the
  // block can exit
  bool staged = !bulk;
  const int base = b.z0 * b.row;
  float* dst_cell = out + (static_cast<int64_t>(b.ni) * s.c + b.c0) * s.q;
  for (int slot = first + threadIdx.x; slot < last; slot += blockDim.x) {
    const int pair = perm == nullptr ? slot : __ldg(perm + slot);
    const int qi = pair - b.ni * s.q;
    int off[1 << D];
    float wgt[1 << D];
    csm::pair_corners<D>(s, grid, b.ni, qi, p, off, wgt);
    // the bin's in-bounds corners lie in the window
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
      off[k] -= base;
      if (wgt[k] == 0.0f || off[k] < 0 || off[k] >= win_elems) {
        wgt[k] = 0.0f;
        off[k] = 0;
      }
    }
    if (!staged) {
      csm::barrier_wait(bar, 0);
      staged = true;
    }
    float* dst = dst_cell + qi;
    for (int c = 0; c < b.cn; ++c) {
      const float* w_c = win + c * win_elems;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < (1 << D); ++k) acc = fmaf(wgt[k], w_c[off[k]], acc);
      dst[static_cast<int64_t>(c) * s.q] = acc;
    }
  }
}

template <int D, int kThreads>
__global__ void __launch_bounds__(kThreads)
    slab_splat_kernel(const float* __restrict__ gout,
                      const float* __restrict__ grid,
                      const int* __restrict__ perm,
                      const int* __restrict__ starts,
                      float* __restrict__ out, csm::PairShape s, int dz,
                      int cc, csm::SamplerParams p, bool bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  const SlabBlock<D> b(s, dz, cc);
  const int rows = min(dz, b.depth - b.z0);
  const int slab_elems = rows * b.row;
  const int acc_elems = b.cn * slab_elems;
  if (acc_elems % 4 == 0) {
    float4* acc4 = reinterpret_cast<float4*>(acc);
    for (int e = threadIdx.x; e < acc_elems / 4; e += blockDim.x)
      acc4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int e = threadIdx.x; e < acc_elems; e += blockDim.x) acc[e] = 0.0f;
  }
  __syncthreads();

  // corner rows f and f + 1: the pairs of floor rows z0 - 1 to
  // z0 + rows - 1 have one in the slab
  int first, last;
  b.slots(s, starts, b.z0 - 1, b.z0 + rows, &first, &last);
  const int base = b.z0 * b.row;
  const float* g_cell = gout + (static_cast<int64_t>(b.ni) * s.c + b.c0) * s.q;
  for (int slot = first + threadIdx.x; slot < last; slot += blockDim.x) {
    const int pair = perm == nullptr ? slot : __ldg(perm + slot);
    const int qi = pair - b.ni * s.q;
    int off[1 << D];
    float wgt[1 << D];
    csm::pair_corners<D>(s, grid, b.ni, qi, p, off, wgt);
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
      off[k] -= base;
      if (off[k] < 0 || off[k] >= slab_elems) wgt[k] = 0.0f;
    }
    for (int c = 0; c < b.cn; ++c) {
      const float gv = __ldg(g_cell + static_cast<int64_t>(c) * s.q + qi);
      float* a_c = acc + c * slab_elems;
#pragma unroll
      for (int k = 0; k < (1 << D); ++k)
        if (wgt[k] != 0.0f) atomicAdd(a_c + off[k], wgt[k] * gv);
    }
  }

  float* dst = out + (static_cast<int64_t>(b.ni) * s.c + b.c0) * s.texels +
               static_cast<int64_t>(b.z0) * b.row;
  if (bulk) {
    // the shared-memory atomics are generic-proxy writes: fence them
    // before the async proxy reads the slab
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int c = 0; c < b.cn; ++c)
        csm::bulk_store(dst + static_cast<int64_t>(c) * s.texels,
                   acc + c * slab_elems,
                   static_cast<uint32_t>(slab_elems) * 4u);
      csm::bulk_store_wait();
    }
  } else {
    __syncthreads();
    for (int c = 0; c < b.cn; ++c)
      for (int e = threadIdx.x; e < slab_elems; e += blockDim.x)
        dst[static_cast<int64_t>(c) * s.texels + e] = acc[c * slab_elems + e];
  }
}

// --- the bins: a counting sort of the pairs by (cell, floor row) ---------

// A pair's key: the floor row of the leading axis, clamped to the cell's
// rows (csrc/pair_bins.cuh).
template <int D>
struct RowKey {
  int keys;  // rows of the leading axis

  __device__ int operator()(const csm::PairShape& s, const float* grid,
                            int ni, int qi, const csm::SamplerParams& p) const {
    const int f = csm::pair_floor<D>(s, grid, ni, qi, D - 1, p);
    return min(max(f, 0), keys - 1);
  }
};

// --- launches --------------------------------------------------------------

template <int D, bool kBlend>
cudaError_t launch_slab(const float* src, const float* grid, const int* perm,
                        const int* starts, float* out,
                        const csm::PairShape& s, int dz, int cc,
                        const csm::SamplerParams& p, cudaStream_t stream) {
  if (dz < 1 || cc < 1) return cudaErrorInvalidValue;
  if (s.n == 0 || s.c == 0 || s.texels == 0 || (kBlend && s.q == 0))
    return cudaGetLastError();
  const int depth = s.size[D - 1];
  const int row = s.stride[D - 1];
  // more than one slab needs the bins
  const bool bins = depth > dz;
  if (bins && (perm == nullptr || starts == nullptr))
    return cudaErrorInvalidValue;
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  // cc channels of dz rows, plus the halo row for the blend
  const int64_t data = static_cast<int64_t>(cc) * (kBlend ? dz + 1 : dz) *
                       row * static_cast<int64_t>(sizeof(float));
  // bulk copies take 16-byte aligned addresses and sizes
  const bool aligned =
      row % 4 == 0 &&
      reinterpret_cast<uintptr_t>(kBlend ? src : out) % 16 == 0;
  const bool bulk =
      aligned && (!kBlend || data + kBarrierBytes <= lim.smem_optin);
  const int64_t bytes = data + (kBlend && bulk ? kBarrierBytes : 0);
  if (bytes > lim.smem_optin) return cudaErrorInvalidValue;
  const bool wide = !kBlend && 2 * bytes > lim.smem_per_sm;
  auto* kernel = kBlend  ? &slab_blend_kernel<D>
                 : wide ? &slab_splat_kernel<D, kWideSplatThreads>
                        : &slab_splat_kernel<D, kSlabThreads>;
  err = csm::allow_smem(kernel, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 blocks(csm::cdiv(depth, dz), csm::cdiv(s.c, cc), s.n);
  kernel<<<blocks, wide ? kWideSplatThreads : kSlabThreads,
           static_cast<size_t>(bytes), stream>>>(
      src, grid, bins ? perm : nullptr, bins ? starts : nullptr, out, s, dz,
      cc, p, bulk);
  return cudaGetLastError();
}

template <bool kBlend>
int slab_entry(const void* src, const void* grid, const void* perm,
               const void* starts, void* out, int dim, int n, int c, int d,
               int h, int w, int q, int grid_batch, int ox, int oy, int oz,
               int dz, int cc, int kernel, int padding, int align,
               int multicell, int strict, float off_step, float off_stop,
               void* stream) {
  if (csm::bad_pair_args(dim, grid_batch, n, ox, oy, oz) || n > 65535)
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(dim, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  const auto* in = static_cast<const float*>(src);
  const auto* gr = static_cast<const float*>(grid);
  const auto* pm = static_cast<const int*>(perm);
  const auto* st = static_cast<const int*>(starts);
  auto* o = static_cast<float*>(out);
  auto cs = static_cast<cudaStream_t>(stream);
  return dim == 2
             ? launch_slab<2, kBlend>(in, gr, pm, st, o, s, dz, cc, p, cs)
             : launch_slab<3, kBlend>(in, gr, pm, st, o, s, dz, cc, p, cs);
}

}  // namespace

extern "C" {

// d is ignored for dim == 2; orders (ox, oy, oz) per grid axis; perm and
// starts null when the leading axis is one slab (d or h <= dz).
int slab_blend(const void* input, const void* grid, const void* perm,
               const void* starts, void* out, int dim, int n, int c, int d,
               int h, int w, int q, int grid_batch, int ox, int oy, int oz,
               int dz, int cc, int kernel, int padding, int align,
               int multicell, int strict, float off_step, float off_stop,
               void* stream) {
  return slab_entry<true>(input, grid, perm, starts, out, dim, n, c, d, h, w,
                          q, grid_batch, ox, oy, oz, dz, cc, kernel, padding,
                          align, multicell, strict, off_step, off_stop,
                          stream);
}

// Writes every element of out (N, C, *S).
int slab_splat(const void* gout, const void* grid, const void* perm,
               const void* starts, void* out, int dim, int n, int c, int d,
               int h, int w, int q, int grid_batch, int ox, int oy, int oz,
               int dz, int cc, int kernel, int padding, int align,
               int multicell, int strict, float off_step, float off_stop,
               void* stream) {
  return slab_entry<false>(gout, grid, perm, starts, out, dim, n, c, d, h, w,
                           q, grid_batch, ox, oy, oz, dz, cc, kernel, padding,
                           align, multicell, strict, off_step, off_stop,
                           stream);
}

// The bins of a grid over (N, *S) cells: key and rank (N * Q,) int32
// scratch, starts (N * D + 1,) int32 zeroed, perm (N * Q,) int32.  d is
// ignored for dim == 2.
int slab_bins(const void* grid, void* key, void* rank, void* starts,
              void* perm, int dim, int n, int d, int h, int w, int q,
              int grid_batch, int padding, int align, int multicell,
              int strict, float off_step, float off_stop, void* stream) {
  if (csm::bad_pair_args(dim, grid_batch, n, 0, 0, 0) || n > 65535)
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(dim, n, 1, d, h, w, q, grid_batch, 0, 0, 0);
  const csm::SamplerParams p = csm::make_params(
      csm::kCosine, padding, align, multicell, strict, off_step, off_stop);
  const auto* gr = static_cast<const float*>(grid);
  auto* k = static_cast<int*>(key);
  auto* r = static_cast<int*>(rank);
  auto* st = static_cast<int*>(starts);
  auto* pm = static_cast<int*>(perm);
  auto cs = static_cast<cudaStream_t>(stream);
  return dim == 2
             ? csm::bins::sort_pairs(gr, k, r, st, pm, nullptr, s, p,
                                     RowKey<2>{s.size[1]}, cs)
             : csm::bins::sort_pairs(gr, k, r, st, pm, nullptr, s, p,
                                     RowKey<3>{s.size[2]}, cs);
}

}  // extern "C"
