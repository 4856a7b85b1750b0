// Slab-decomposed blend_o / splat_o for volumes too large for one block's
// shared memory, 2D and 3D, for NVIDIA Hopper (sm_90a).
//
// slab_blend replaces the TPU kernel
//   ops/pallas/slab.py::_blend_slab_kernel of the JAX package
// slab_splat replaces
//   ops/pallas/slab.py::_splat_slab_kernel
//
// Contract (the blend_o / splat_o contract of csrc/blend_splat.cu):
//   input (N, C, *S) f32 with S = (D, H, W) or (H, W), grid (G, Q, d) f32
//   with G = N or 1, per-axis derivative orders, and the slab geometry
//   (dz, cc) of ops/cuda/slab.py: the leading spatial axis is cut into
//   slabs of dz rows and the channels into chunks of cc.
//   slab_blend: -> out (N, C, Q) f32, equal bit for bit to blend_o's.
//   slab_splat: gout (N, C, Q) f32 -> out (N, C, *S) f32, the transpose.
//               Every element of out is written, so it needs no zeroing.
//
// What bounds them on the H100, and the design:
// * A volume over the 227 KB of shared memory a block may use sends
//   splat_o to its global-atomics branch, whose atomics land at random in
//   device memory.  Here block (slab, chunk, cell) owns the rows
//   [z0, z0 + dz) of cc channels of one cell and keeps them in shared
//   memory: the splat accumulates its slab there with shared-memory
//   atomics and writes it out once with plain stores (the slabs tile the
//   volume, so no two blocks write one element and out needs no memset);
//   the blend stages its rows plus a one-row halo and serves the pairs
//   whose floor row lies in its slab (a pair's corner rows are its floor
//   row and the next), so every output is written once, without atomics.
// * Every block still reads all Q coordinates of its cell, but only the
//   cheap slab-axis floor (no interpolant weights) for a pair it does not
//   serve: slabs multiply that test and nothing else, as on the TPU.  The
//   route is for clouds too sparse to pay for percell's sort; the bytes
//   it must move are the staged volume (blend) or the written one (splat)
//   and the coordinates once per slab.
// * The TPU kernels' one-hot MXU contractions, sublane-multiple slab
//   heights and zero-initialised accumulation over a sequential grid axis
//   do not carry over.
// * The splat's shared-memory atomics add in no fixed order: not
//   deterministic.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "launch.cuh"
#include "pair_corners.cuh"

namespace {

constexpr int kSlabThreads = 512;

// Slab geometry of one block: slab (blockIdx.x), channel chunk
// (blockIdx.y), cell (blockIdx.z).
template <int D>
struct SlabBlock {
  int depth;  // rows of the leading axis
  int row;    // elements of one row: H * W (3D) or W (2D)
  int ns;     // slabs
  int slab, z0, c0, cn, ni;

  __device__ SlabBlock(const csm::PairShape& s, int dz, int cc) {
    depth = s.size[D - 1];
    row = s.stride[D - 1];
    ns = (depth + dz - 1) / dz;
    slab = blockIdx.x;
    z0 = slab * dz;
    c0 = blockIdx.y * cc;
    cn = min(cc, s.c - c0);
    ni = blockIdx.z;
  }
};

template <int D>
__global__ void __launch_bounds__(kSlabThreads)
    slab_blend_kernel(const float* __restrict__ input,
                      const float* __restrict__ grid, float* __restrict__ out,
                      csm::PairShape s, int dz, int cc, csm::SamplerParams p) {
  extern __shared__ float win[];
  const SlabBlock<D> b(s, dz, cc);
  // rows [z0, z0 + dz] of the chunk: the slab and its one-row halo
  const int rows = min(dz + 1, b.depth - b.z0);
  const int win_elems = rows * b.row;
  for (int c = 0; c < b.cn; ++c) {
    const float* src =
        input + (static_cast<int64_t>(b.ni) * s.c + b.c0 + c) * s.texels +
        static_cast<int64_t>(b.z0) * b.row;
    for (int e = threadIdx.x; e < win_elems; e += blockDim.x)
      win[c * win_elems + e] = __ldg(src + e);
  }
  __syncthreads();

  const int base = b.z0 * b.row;
  float* dst_cell = out + (static_cast<int64_t>(b.ni) * s.c + b.c0) * s.q;
  for (int qi = threadIdx.x; qi < s.q; qi += blockDim.x) {
    // the owner: the slab of the floor row, the edge slabs taking the
    // clamped floors outside [0, depth)
    const int f = csm::pair_floor<D>(s, grid, b.ni, qi, D - 1, p);
    const int owner = f < 0 ? 0 : min(f / dz, b.ns - 1);
    if (owner != b.slab) continue;
    int off[1 << D];
    float wgt[1 << D];
    csm::pair_corners<D>(s, grid, b.ni, qi, p, off, wgt);
    // an owned pair's in-bounds corners lie in the window
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
      off[k] -= base;
      if (wgt[k] == 0.0f || off[k] < 0 || off[k] >= win_elems) {
        wgt[k] = 0.0f;
        off[k] = 0;
      }
    }
    for (int c = 0; c < b.cn; ++c) {
      const float* w_c = win + c * win_elems;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < (1 << D); ++k) acc = fmaf(wgt[k], w_c[off[k]], acc);
      dst_cell[static_cast<int64_t>(c) * s.q + qi] = acc;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kSlabThreads)
    slab_splat_kernel(const float* __restrict__ gout,
                      const float* __restrict__ grid, float* __restrict__ out,
                      csm::PairShape s, int dz, int cc, csm::SamplerParams p) {
  extern __shared__ float acc[];
  const SlabBlock<D> b(s, dz, cc);
  const int rows = min(dz, b.depth - b.z0);
  const int slab_elems = rows * b.row;
  for (int e = threadIdx.x; e < b.cn * slab_elems; e += blockDim.x)
    acc[e] = 0.0f;
  __syncthreads();

  const int base = b.z0 * b.row;
  const float* g_cell = gout + (static_cast<int64_t>(b.ni) * s.c + b.c0) * s.q;
  for (int qi = threadIdx.x; qi < s.q; qi += blockDim.x) {
    // corner rows f and f + 1: skip the pair unless one lies in the slab
    const int f = csm::pair_floor<D>(s, grid, b.ni, qi, D - 1, p);
    if (f + 1 < b.z0 || f >= b.z0 + rows) continue;
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
  __syncthreads();

  for (int c = 0; c < b.cn; ++c) {
    float* dst = out +
                 (static_cast<int64_t>(b.ni) * s.c + b.c0 + c) * s.texels +
                 static_cast<int64_t>(b.z0) * b.row;
    for (int e = threadIdx.x; e < slab_elems; e += blockDim.x)
      dst[e] = acc[c * slab_elems + e];
  }
}

// Shared memory of one block: cc channels of dz rows, plus the halo row
// for the blend.
int64_t slab_smem_bytes(const csm::PairShape& s, int dim, int dz, int cc,
                        bool blend) {
  const int row = s.stride[dim - 1];
  return static_cast<int64_t>(cc) * (blend ? dz + 1 : dz) * row *
         static_cast<int64_t>(sizeof(float));
}

template <int D, bool kBlend>
cudaError_t launch_slab(const float* src, const float* grid, float* out,
                        const csm::PairShape& s, int dz, int cc,
                        const csm::SamplerParams& p, cudaStream_t stream) {
  if (dz < 1 || cc < 1) return cudaErrorInvalidValue;
  if (s.n == 0 || s.c == 0 || s.texels == 0 || (kBlend && s.q == 0))
    return cudaGetLastError();
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  const int64_t bytes = slab_smem_bytes(s, D, dz, cc, kBlend);
  if (bytes > lim.smem_optin) return cudaErrorInvalidValue;
  auto* kernel = kBlend ? &slab_blend_kernel<D> : &slab_splat_kernel<D>;
  err = csm::allow_smem(kernel, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 blocks(csm::cdiv(s.size[D - 1], dz), csm::cdiv(s.c, cc), s.n);
  kernel<<<blocks, kSlabThreads, static_cast<size_t>(bytes), stream>>>(
      src, grid, out, s, dz, cc, p);
  return cudaGetLastError();
}

template <bool kBlend>
int slab_entry(const void* src, const void* grid, void* out, int dim, int n,
               int c, int d, int h, int w, int q, int grid_batch, int ox,
               int oy, int oz, int dz, int cc, int kernel, int padding,
               int align, int multicell, int strict, float off_step,
               float off_stop, void* stream) {
  if (csm::bad_pair_args(dim, grid_batch, n, ox, oy, oz) || n > 65535)
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(dim, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  const auto* in = static_cast<const float*>(src);
  const auto* gr = static_cast<const float*>(grid);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return dim == 2 ? launch_slab<2, kBlend>(in, gr, o, s, dz, cc, p, st)
                  : launch_slab<3, kBlend>(in, gr, o, s, dz, cc, p, st);
}

}  // namespace

extern "C" {

// d is ignored for dim == 2; orders (ox, oy, oz) per grid axis.
int slab_blend(const void* input, const void* grid, void* out, int dim,
               int n, int c, int d, int h, int w, int q, int grid_batch,
               int ox, int oy, int oz, int dz, int cc, int kernel,
               int padding, int align, int multicell, int strict,
               float off_step, float off_stop, void* stream) {
  return slab_entry<true>(input, grid, out, dim, n, c, d, h, w, q,
                          grid_batch, ox, oy, oz, dz, cc, kernel, padding,
                          align, multicell, strict, off_step, off_stop,
                          stream);
}

// Writes every element of out (N, C, *S).
int slab_splat(const void* gout, const void* grid, void* out, int dim, int n,
               int c, int d, int h, int w, int q, int grid_batch, int ox,
               int oy, int oz, int dz, int cc, int kernel, int padding,
               int align, int multicell, int strict, float off_step,
               float off_stop, void* stream) {
  return slab_entry<false>(gout, grid, out, dim, n, c, d, h, w, q,
                           grid_batch, ox, oy, oz, dz, cc, kernel, padding,
                           align, multicell, strict, off_step, off_stop,
                           stream);
}

}  // extern "C"
