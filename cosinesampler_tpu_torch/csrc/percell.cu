// Binned per-cell blend_o / splat_o for 3D volumes too large to stay on
// chip, for NVIDIA Hopper (sm_90a).
//
// percell_blend replaces the TPU kernel
//   ops/pallas/percell.py::_blend_pc_kernel of the JAX package
// percell_splat replaces
//   ops/pallas/percell.py::_splat_pc_kernel
// percell_plan builds the tiles' bins both walk (the JAX route sorts on
// the host side of its pallas_call).
//
// Contract (the blend_o / splat_o contract of csrc/blend_splat.cu, 3D):
//   input (N, C, D, H, W) f32, grid (G, Q, 3) f32 with G = N or G = 1 (a
//   cloud shared by all cells), per-axis derivative orders, the tile
//   geometry (dz, ty, cc) of ops/cuda/percell.py, and the plan of
//   percell_plan: perm (N * Q,) int32, the pair n * Q + q of each slot,
//   ordered by (cell, z tile, y band) of the pair's floor corner (z floor
//   clamped to [0, D) over dz, y floor clamped to [0, H) over ty), and
//   starts (N * T + 1,) int32, the first slot of each (cell, tile), T =
//   ceil(D / dz) * ceil(H / ty) tiles a cell.
//   percell_blend: -> out (N, C, Q) f32 in query order, equal bit for bit
//                  to blend_o's.
//   percell_splat: gout (N, C, Q) f32 -> out (N, C, D, H, W) f32, the
//                  transpose; out must be zeroed.
//   percell_plan:  grid -> perm and starts; starts must be zeroed.
//
// What bounds them on the H100, and the design:
// * A 4-channel 128^3 cell is 33.5 MB, and the 16 cells of the nested 3D
//   trainer 537 MB, ten times the 50 MB L2.  A gather per corner and
//   channel moves a 32-byte sector for 4 bytes: 1.6 M pairs pulled ~1.6 GB
//   from L2 for a 26 MB output.  So the blend stages: block (tile, channel
//   chunk) owns z rows [z0, z0 + dz) and y rows [y0, y0 + ty) of one cell,
//   the pairs of its tile's bin have their corners in z rows
//   [z0, z0 + dz] and y rows [y0, y0 + ty], and rows y0..y0 + ty of one
//   z plane of one channel are one contiguous span of (ty + 1) * W
//   floats: one 1D bulk async copy (TMA) per (channel, z row), issued by
//   one thread and completing on an mbarrier while every thread computes
//   its first pair's corners.  The tile (ops/cuda/percell.py geometry)
//   takes a share of an SM's shared memory so that two blocks stage and
//   compute side by side, cut to the fewest halo rows a tile; consecutive
//   blocks walk a cell's tiles in key order, so a halo plane comes from L2.
//   The blend then reads its corners from shared memory and stores each
//   pair's C channels straight to query order (scattered 4-byte stores;
//   no slot order and no gather back).  A block whose bin is empty stages
//   nothing.  Rows whose bytes are not a multiple of 16 are copied by the
//   block's threads; a cell whose two rows of one channel of two planes do
//   not fit the tile's shared memory (or whose tiles a cell's histogram
//   cannot count) is not staged: its blocks gather from the volume.
// * percell_plan is csrc/pair_bins.cuh's counting sort on the floors of
//   csrc/pair_corners.cuh, the kernels' own, so a bin always holds its
//   pairs' corner rows.
// * percell_splat: one thread per plan slot adds each corner's C values
//   with global atomics; the tiles' order keeps them L2-local.  No
//   shared-memory accumulator: a tile's pairs add into a window shared by
//   the next tiles, which would flush most of its atomics anyway
//   (fused3b's finding, scripts/count_brick_flush.py).
// * The TPU kernels' window DMA chain, z front pad, sublane-multiple
//   window rows and one-hot MXU contractions exist for VMEM and are not
//   carried over; the sort is.
// * f32 atomics and an order within a bin set by atomics: the splat is not
//   deterministic (the blend is: each output is one block's).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bulk_copy.cuh"
#include "launch.cuh"
#include "pair_bins.cuh"
#include "pair_corners.cuh"

namespace {

constexpr int kThreads = 256;
// dynamic shared memory ahead of the blend's window: its mbarrier, padded
// so that the window stays 16-byte aligned for the bulk copies
constexpr int kBarrierBytes = 16;

// Tiles of one cell: z rows [zt * dz, ...) by y rows [band * ty, ...).
struct Tiles {
  int dz, ty;
  int nzt, nb;  // z tiles and y bands a cell

  __host__ __device__ int per_cell() const { return nzt * nb; }
};

inline Tiles make_tiles(int d, int h, int dz, int ty) {
  return Tiles{dz, ty, csm::cdiv(d, dz), csm::cdiv(h, ty)};
}

// A pair's key: its tile within the cell, (z tile) * nb + (y band), from
// the clamped floors of the kernels' own corner walk.
struct TileKey {
  int keys;
  Tiles t;

  __device__ int operator()(const csm::PairShape& s, const float* grid,
                            int ni, int qi, const csm::SamplerParams& p) const {
    const int z = min(max(csm::pair_floor<3>(s, grid, ni, qi, 2, p), 0),
                      s.size[2] - 1);
    const int y = min(max(csm::pair_floor<3>(s, grid, ni, qi, 1, p), 0),
                      s.size[1] - 1);
    return (z / t.dz) * t.nb + y / t.ty;
  }
};

// Block (blockIdx.x: cell * tiles + tile, blockIdx.y: channel chunk of cc)
// evaluates its bin's pairs.  kStaged: from the tile's window in shared
// memory (bulk: staged by bulk copies, else by the threads); otherwise
// from the volume.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    percell_blend_kernel(const float* __restrict__ input,
                         const float* __restrict__ grid,
                         const int* __restrict__ perm,
                         const int* __restrict__ starts,
                         float* __restrict__ out, csm::PairShape s, Tiles t,
                         int cc, csm::SamplerParams p, bool bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int first = __ldg(starts + blockIdx.x);
  const int last = __ldg(starts + blockIdx.x + 1);
  if (first == last) return;  // an empty bin stages nothing
  const int ni = blockIdx.x / t.per_cell();
  const int tile = blockIdx.x - ni * t.per_cell();
  const int zt = tile / t.nb;
  const int z0 = zt * t.dz, y0 = (tile - zt * t.nb) * t.ty;
  const int w = s.size[0], h = s.size[1], d = s.size[2];
  const int zrows = min(t.dz + 1, d - z0), yrows = min(t.ty + 1, h - y0);
  const int span = yrows * w;          // one (channel, z row) of the window
  const int win_elems = zrows * span;  // one channel
  const int c0 = blockIdx.y * cc, cn = min(cc, s.c - c0);
  const float* cells =
      input + (static_cast<int64_t>(ni) * s.c + c0) * s.texels;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* win = reinterpret_cast<float*>(smem + kBarrierBytes);
  if (kStaged) {
    const float* src = cells + static_cast<int64_t>(z0) * s.stride[2] +
                       static_cast<int64_t>(y0) * w;
    if (bulk) {
      if (threadIdx.x == 0) {
        csm::barrier_init(bar);
        const uint32_t bytes = static_cast<uint32_t>(span) * 4u;
        csm::barrier_expect(bar, bytes * zrows * cn);
        for (int c = 0; c < cn; ++c)
          for (int z = 0; z < zrows; ++z)
            csm::bulk_load(win + (c * zrows + z) * span,
                           src + static_cast<int64_t>(c) * s.texels +
                               static_cast<int64_t>(z) * s.stride[2],
                           bytes, bar);
      }
    } else {
      for (int c = 0; c < cn; ++c)
        for (int z = 0; z < zrows; ++z)
          for (int e = threadIdx.x; e < span; e += blockDim.x)
            win[(c * zrows + z) * span + e] =
                __ldg(src + static_cast<int64_t>(c) * s.texels +
                      static_cast<int64_t>(z) * s.stride[2] + e);
    }
    __syncthreads();
  }

  // thread 0 always has a slot, so it waits for the copies before the
  // block can exit
  bool staged = !(kStaged && bulk);
  float* dst_cell = out + (static_cast<int64_t>(ni) * s.c + c0) * s.q;
  for (int slot = first + threadIdx.x; slot < last; slot += blockDim.x) {
    const int qi = __ldg(perm + slot) - ni * s.q;
    csm::AxisWeights a[3];
    csm::pair_axes<3>(s, grid, ni, qi, p, a);
    int off[8];
    float wgt[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int x = a[0].i0 + csm::corner_up<3>(k, 0);
      const int y = a[1].i0 + csm::corner_up<3>(k, 1);
      const int z = a[2].i0 + csm::corner_up<3>(k, 2);
      // in the volume and, staged, in the window (the bin's pairs always
      // are; a corner outside both is out of bounds)
      const bool ok = x >= 0 && x < w && y >= 0 && y < h && z >= 0 && z < d &&
                      (!kStaged || (y >= y0 && y - y0 < yrows && z >= z0 &&
                                    z - z0 < zrows));
      off[k] = !ok ? 0
               : kStaged ? ((z - z0) * yrows + (y - y0)) * w + x
                         : z * s.stride[2] + y * w + x;
      wgt[k] = ok ? csm::corner_weight<3>(a, k) : 0.0f;
    }
    if (!staged) {
      csm::barrier_wait(bar, 0);
      staged = true;
    }
    float* dst = dst_cell + qi;
    for (int c = 0; c < cn; ++c) {
      const float* src = kStaged ? win + c * win_elems
                                 : cells + static_cast<int64_t>(c) * s.texels;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc = fmaf(wgt[k], kStaged ? src[off[k]] : __ldg(src + off[k]), acc);
      dst[static_cast<int64_t>(c) * s.q] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    percell_splat_kernel(const float* __restrict__ gout,
                         const float* __restrict__ grid,
                         const int* __restrict__ perm,
                         float* __restrict__ out, csm::PairShape s,
                         csm::SamplerParams p) {
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
  for (int c = 0; c < s.c; ++c) {
    const float gv = __ldg(g + static_cast<int64_t>(c) * s.q);
    float* dst = cell + static_cast<int64_t>(c) * s.texels;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (wgt[k] != 0.0f) atomicAdd(dst + off[k], wgt[k] * gv);
  }
}

bool bad_tiles(int d, int h, int dz, int ty) {
  return dz < 1 || ty < 1 || dz > d || ty > h;
}

}  // namespace

extern "C" {

// dim must be 3; orders (ox, oy, oz) per grid axis; the tile (dz, ty), its
// channels cc and staged (0 or 1) from ops/cuda/percell.py geometry; out
// (N, C, Q) in query order.
int percell_blend(const void* input, const void* grid, const void* perm,
                  const void* starts, void* out, int dim, int n, int c, int d,
                  int h, int w, int q, int grid_batch, int ox, int oy, int oz,
                  int dz, int ty, int cc, int staged, int kernel, int padding,
                  int align, int multicell, int strict, float off_step,
                  float off_stop, void* stream) {
  if (dim != 3 || csm::bad_pair_args(3, grid_batch, n, ox, oy, oz) ||
      bad_tiles(d, h, dz, ty) || cc < 1)
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(3, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  if (n == 0 || q == 0 || c == 0) return cudaGetLastError();
  const Tiles t = make_tiles(d, h, dz, ty);
  const int64_t blocks = static_cast<int64_t>(n) * t.per_cell();
  if (blocks > 0x7fffffff || csm::cdiv(c, cc) > 65535)
    return cudaErrorInvalidValue;
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  const int64_t bytes =
      staged ? kBarrierBytes + static_cast<int64_t>(cc) *
                                   std::min(dz + 1, d) * std::min(ty + 1, h) *
                                   w * static_cast<int64_t>(sizeof(float))
             : 0;
  if (bytes > lim.smem_optin) return cudaErrorInvalidValue;
  // bulk copies take 16-byte aligned addresses and sizes
  const bool bulk =
      w % 4 == 0 && reinterpret_cast<uintptr_t>(input) % 16 == 0;
  auto* kernel_fn = staged ? &percell_blend_kernel<true>
                           : &percell_blend_kernel<false>;
  err = csm::allow_smem(kernel_fn, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  kernel_fn<<<dim3(static_cast<unsigned>(blocks), csm::cdiv(c, cc)),
              kThreads, static_cast<size_t>(bytes),
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(input), static_cast<const float*>(grid),
      static_cast<const int*>(perm), static_cast<const int*>(starts),
      static_cast<float*>(out), s, t, cc, p, bulk);
  return cudaGetLastError();
}

// out (N, C, D, H, W) must be zeroed; perm in any order of the pairs.
int percell_splat(const void* gout, const void* grid, const void* perm,
                  void* out, int dim, int n, int c, int d, int h, int w, int q,
                  int grid_batch, int ox, int oy, int oz, int kernel,
                  int padding, int align, int multicell, int strict,
                  float off_step, float off_stop, void* stream) {
  if (dim != 3 || csm::bad_pair_args(3, grid_batch, n, ox, oy, oz))
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(3, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  const int pairs = n * q;
  if (pairs == 0 || c == 0) return cudaGetLastError();
  percell_splat_kernel<<<csm::cdiv(pairs, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gout), static_cast<const float*>(grid),
      static_cast<const int*>(perm), static_cast<float*>(out), s, p);
  return cudaGetLastError();
}

// The plan of a grid over (N, C, D, H, W) cells with tiles (dz, ty): key
// and rank (N * Q,) int32 scratch, starts (N * T + 1,) int32 zeroed, perm
// (N * Q,) int32.
int percell_plan(const void* grid, void* key, void* rank, void* starts,
                 void* perm, int n, int d, int h, int w, int q, int grid_batch,
                 int dz, int ty, int padding, int align, int multicell,
                 int strict, float off_step, float off_stop, void* stream) {
  if (csm::bad_pair_args(3, grid_batch, n, 0, 0, 0) ||
      bad_tiles(d, h, dz, ty))
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(3, n, 1, d, h, w, q, grid_batch, 0, 0, 0);
  const csm::SamplerParams p = csm::make_params(
      csm::kCosine, padding, align, multicell, strict, off_step, off_stop);
  const Tiles t = make_tiles(d, h, dz, ty);
  return csm::bins::sort_pairs(
      static_cast<const float*>(grid), static_cast<int*>(key),
      static_cast<int*>(rank), static_cast<int*>(starts),
      static_cast<int*>(perm), s, p, TileKey{t.per_cell(), t},
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
