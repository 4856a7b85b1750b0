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
//   channel), piles onto the few thousand texels of each cell.  As in
//   fused2w_bwd, a block owns a chunk of cells in shared memory,
//   accumulates its slice of the queries there with shared-memory
//   atomics, and flushes the chunk once with global atomicAdd.  A cell
//   above 48 KB (the 3D 4 x 16^3 cell is 64 KB) takes one cell per block
//   in opted-in dynamic shared memory, up to the card's per-block limit
//   (227 KB on the H100); only a cell larger than that takes global
//   atomics directly.
// * The TPU splat was deterministic (a sequential accumulation over query
//   blocks).  This one is not: f32 atomics add in an order that changes
//   from run to run, so results agree with the plain version to rounding,
//   not bit for bit.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "sampler_math.cuh"

namespace {

constexpr int kBlendThreads = 256;
constexpr int kSplatThreads = 256;
constexpr int kStaticSmemBytes = 48 * 1024;  // no opt-in attribute needed

struct Shape {
  int n, c, q;
  int grid_batch;  // 1 (shared queries) or n
  int size[3];     // per grid axis: W, H, D
  int stride[3];   // flat texel stride per grid axis: 1, W, H*W
  int order[3];
  int texels;      // prod(S)
};

// Corner offsets (flat texel index) and weights of one (cell, query) pair;
// an out-of-bounds corner gets weight 0 and offset 0.
template <int D>
__device__ __forceinline__ void corners(const Shape& s, const float* grid,
                                        int ni, int qi,
                                        const csm::SamplerParams& p,
                                        int off[1 << D], float wgt[1 << D]) {
  const float offset = csm::cell_offset(ni, s.n, p);
  const float* g =
      grid + (static_cast<int64_t>(s.grid_batch == 1 ? 0 : ni) * s.q + qi) * D;
  csm::AxisWeights a[D];
#pragma unroll
  for (int i = 0; i < D; ++i)
    a[i] = csm::axis_weights(g[i], s.size[i], offset, s.order[i], p);
  // corner bit D-1-i selects axis i's ceil corner: itertools.product order
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    int idx = 0;
    float w = 1.0f;
    bool ok = true;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int up = (k >> (D - 1 - i)) & 1;
      const int ci = a[i].i0 + up;
      ok = ok && ci >= 0 && ci < s.size[i];
      idx += ci * s.stride[i];
      w = i == 0 ? (up ? a[i].w1 : a[i].w0) : w * (up ? a[i].w1 : a[i].w0);
    }
    off[k] = ok ? idx : 0;
    wgt[k] = ok ? w : 0.0f;
  }
}

// One thread per (cell, query): thread t takes cell t / Q, query t % Q.
template <int D>
__global__ void __launch_bounds__(kBlendThreads)
    blend_o_kernel(const float* __restrict__ input,
                   const float* __restrict__ grid, float* __restrict__ out,
                   Shape s, csm::SamplerParams p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= s.n * s.q) return;
  const int ni = t / s.q;
  const int qi = t - ni * s.q;
  int off[1 << D];
  float wgt[1 << D];
  corners<D>(s, grid, ni, qi, p, off, wgt);
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

// Block (bx, by) accumulates queries [by * q_per_block, ...) into cells
// [bx * cells_per_chunk, ...).  SMEM: in shared memory, flushed once at the
// end; otherwise straight into out.  out must be zeroed.
template <int D, bool SMEM>
__global__ void __launch_bounds__(kSplatThreads)
    splat_o_kernel(const float* __restrict__ gout,
                   const float* __restrict__ grid, float* __restrict__ out,
                   Shape s, int cells_per_chunk, int q_per_block,
                   csm::SamplerParams p) {
  extern __shared__ float sacc[];
  const int cell_elems = s.c * s.texels;
  const int n0 = blockIdx.x * cells_per_chunk;
  const int n1 = min(s.n, n0 + cells_per_chunk);
  const int chunk_elems = (n1 - n0) * cell_elems;
  float* chunk_out = out + static_cast<int64_t>(n0) * cell_elems;
  float* acc = SMEM ? sacc : chunk_out;
  if (SMEM) {
    for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) sacc[e] = 0.0f;
    __syncthreads();
  }

  const int q0 = blockIdx.y * q_per_block;
  const int q1 = min(s.q, q0 + q_per_block);
  for (int qi = q0 + threadIdx.x; qi < q1; qi += blockDim.x) {
    for (int ni = n0; ni < n1; ++ni) {
      int off[1 << D];
      float wgt[1 << D];
      corners<D>(s, grid, ni, qi, p, off, wgt);
      const float* g = gout + static_cast<int64_t>(ni) * s.c * s.q + qi;
      float* cell = acc + static_cast<int64_t>(ni - n0) * cell_elems;
      for (int c = 0; c < s.c; ++c) {
        const float gv = __ldg(g + static_cast<int64_t>(c) * s.q);
        float* dst = cell + static_cast<int64_t>(c) * s.texels;
#pragma unroll
        for (int k = 0; k < (1 << D); ++k)
          if (wgt[k] != 0.0f) atomicAdd(dst + off[k], wgt[k] * gv);
      }
    }
  }

  if (SMEM) {
    __syncthreads();
    for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) {
      const float v = sacc[e];
      if (v != 0.0f) atomicAdd(chunk_out + e, v);
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int D>
cudaError_t launch_blend(const float* input, const float* grid, float* out,
                         const Shape& s, const csm::SamplerParams& p,
                         cudaStream_t stream) {
  const int pairs = s.n * s.q;
  if (pairs == 0 || s.c == 0) return cudaGetLastError();
  blend_o_kernel<D><<<cdiv(pairs, kBlendThreads), kBlendThreads, 0, stream>>>(
      input, grid, out, s, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_splat(const float* gout, const float* grid, float* out,
                         const Shape& s, const csm::SamplerParams& p,
                         cudaStream_t stream) {
  if (s.n == 0 || s.q == 0 || s.c == 0 || s.texels == 0)
    return cudaGetLastError();
  int device = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;

  const int64_t cell_bytes =
      static_cast<int64_t>(s.c) * s.texels * static_cast<int64_t>(sizeof(float));
  const bool smem = cell_bytes <= optin;
  // up to 48 KB of cells per block, or one larger cell in opted-in memory
  const int cells_per_chunk =
      !smem ? s.n
            : (cell_bytes <= kStaticSmemBytes
                   ? std::min<int64_t>(s.n, kStaticSmemBytes / cell_bytes)
                   : 1);
  const int chunks = cdiv(s.n, cells_per_chunk);
  // enough blocks for ~4 per SM, but no block with fewer queries than threads
  const int q_blocks = std::max(
      1, std::min(std::min(cdiv(4 * sms, chunks), cdiv(s.q, kSplatThreads)),
                  65535));
  const int q_per_block = cdiv(s.q, q_blocks);
  const dim3 blocks(chunks, cdiv(s.q, q_per_block));
  if (smem) {
    const size_t bytes = static_cast<size_t>(cells_per_chunk) * cell_bytes;
    auto* kernel = &splat_o_kernel<D, true>;
    if (bytes > static_cast<size_t>(kStaticSmemBytes)) {
      err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
    }
    kernel<<<blocks, kSplatThreads, bytes, stream>>>(
        gout, grid, out, s, cells_per_chunk, q_per_block, p);
  } else {
    splat_o_kernel<D, false><<<blocks, kSplatThreads, 0, stream>>>(
        gout, grid, out, s, cells_per_chunk, q_per_block, p);
  }
  return cudaGetLastError();
}

Shape make_shape(int dim, int n, int c, int d, int h, int w, int q,
                 int grid_batch, int ox, int oy, int oz) {
  Shape s;
  s.n = n;
  s.c = c;
  s.q = q;
  s.grid_batch = grid_batch;
  s.size[0] = w;
  s.size[1] = h;
  s.size[2] = dim == 3 ? d : 1;
  s.stride[0] = 1;
  s.stride[1] = w;
  s.stride[2] = h * w;
  s.order[0] = ox;
  s.order[1] = oy;
  s.order[2] = dim == 3 ? oz : 0;
  s.texels = h * w * (dim == 3 ? d : 1);
  return s;
}

csm::SamplerParams make_params(int kernel, int padding, int align,
                               int multicell, int strict, float off_step,
                               float off_stop) {
  csm::SamplerParams p;
  p.kernel = kernel;
  p.padding = padding;
  p.align = align != 0;
  p.multicell = multicell != 0;
  p.strict = strict != 0;
  p.off_step = off_step;
  p.off_stop = off_stop;
  return p;
}

bool bad_args(int dim, int grid_batch, int n, int ox, int oy, int oz) {
  return (dim != 2 && dim != 3) || (grid_batch != 1 && grid_batch != n) ||
         ox < 0 || oy < 0 || oz < 0;
}

}  // namespace

extern "C" {

// d is ignored for dim == 2; orders (ox, oy, oz) per grid axis.
int blend_o(const void* input, const void* grid, void* out, int dim, int n,
            int c, int d, int h, int w, int q, int grid_batch, int ox, int oy,
            int oz, int kernel, int padding, int align, int multicell,
            int strict, float off_step, float off_stop, void* stream) {
  if (bad_args(dim, grid_batch, n, ox, oy, oz)) return cudaErrorInvalidValue;
  const Shape s = make_shape(dim, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = make_params(kernel, padding, align, multicell,
                                           strict, off_step, off_stop);
  const auto* in = static_cast<const float*>(input);
  const auto* gr = static_cast<const float*>(grid);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return dim == 2 ? launch_blend<2>(in, gr, o, s, p, st)
                  : launch_blend<3>(in, gr, o, s, p, st);
}

// out (N, C, *S) must be zeroed.
int splat_o(const void* gout, const void* grid, void* out, int dim, int n,
            int c, int d, int h, int w, int q, int grid_batch, int ox, int oy,
            int oz, int kernel, int padding, int align, int multicell,
            int strict, float off_step, float off_stop, void* stream) {
  if (bad_args(dim, grid_batch, n, ox, oy, oz)) return cudaErrorInvalidValue;
  const Shape s = make_shape(dim, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = make_params(kernel, padding, align, multicell,
                                           strict, off_step, off_stop);
  const auto* g = static_cast<const float*>(gout);
  const auto* gr = static_cast<const float*>(grid);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return dim == 2 ? launch_splat<2>(g, gr, o, s, p, st)
                  : launch_splat<3>(g, gr, o, s, p, st);
}

}  // extern "C"
