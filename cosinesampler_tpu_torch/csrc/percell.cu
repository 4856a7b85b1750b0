// Binned per-cell blend_o / splat_o for 3D volumes too large to stay on
// chip, for NVIDIA Hopper (sm_90a).
//
// percell_blend replaces the TPU kernel
//   ops/pallas/percell.py::_blend_pc_kernel of the JAX package
// percell_splat replaces
//   ops/pallas/percell.py::_splat_pc_kernel
// percell_plan builds the rows' bins both walk (the JAX route sorts on
// the host side of its pallas_call).
//
// Contract (the blend_o / splat_o contract of csrc/blend_splat.cu, 3D):
//   input (N, C, D, H, W) f32, grid (G, Q, 3) f32 with G = N or G = 1 (a
//   cloud shared by all cells), per-axis derivative orders, the plan of
//   percell_plan and a tile geometry (dz, ty, cc) of ops/cuda/percell.py
//   (the blend's and the splat's are their own).  The plan: perm (N * Q,)
//   int32, the pair n * Q + q of each slot, ordered by (cell, z key, y
//   key) of the pair's floor corner, z key = (z floor clamped to [0, D))
//   / kz and y key = (y floor clamped to [0, H)) / ky, and starts
//   (N * K + 1,) int32, the first slot of each (cell, z key, y key), K =
//   ceil(D / kz) * ceil(H / ky) keys a cell (kz = ky = 1, a key a row,
//   wherever D * H fits the plan's histogram).
//   percell_blend: -> out (N, C, Q) f32 in query order, equal bit for bit
//                  to blend_o's.
//   percell_splat: gout (N, C, Q) f32 -> out (N, C, D, H, W) f32, the
//                  transpose.  Every element of out is written, so it
//                  needs no zeroing.
//   percell_plan:  grid -> perm and starts; starts must be zeroed.
//
// What bounds them on the H100, and the design:
// * A 4-channel 128^3 cell is 33.5 MB, and the 16 cells of the nested 3D
//   trainer 537 MB, ten times the 50 MB L2.  A gather per corner and
//   channel moves a 32-byte sector for 4 bytes: 1.6 M pairs pulled ~1.6 GB
//   from L2 for a 26 MB output.  The splat must write the 537 MB once.
// * Tiles: block (tile, channel chunk) owns z rows [z0, z0 + dz) and y
//   rows [y0, y0 + ty) of one cell.  The pairs a tile needs are a few
//   contiguous slot ranges of the plan, one a z key: the blend's, the
//   pairs whose floor lies in its rows (their corners lie in rows
//   [z0, z0 + dz] x [y0, y0 + ty]); the splat's, those whose floor lies in
//   z [z0 - 1, z0 + dz - 1] x y [y0 - 1, y0 + ty - 1], exactly the pairs
//   with a corner in its rows (corners are floor and floor + 1; one off
//   the volume weighs 0).  A block lays its ranges end to end (a warp's
//   scan of their lengths) and its threads walk them as one; with keys
//   coarser than rows a walk also meets pairs of other rows, which the
//   blend skips and whose corners the splat's tile filter drops.
// * The blend stages: rows y0..y0 + ty of one z plane of one channel are
//   one contiguous span of (ty + 1) * W floats, one 1D bulk async copy
//   (TMA) per (channel, z row), issued by one thread and completing on an
//   mbarrier while every thread computes its first pair's corners.  The
//   tile (ops/cuda/percell.py geometry) takes a share of an SM's shared
//   memory so that two blocks stage and compute side by side, cut to the
//   fewest halo rows a tile; consecutive blocks walk a cell's tiles in key
//   order, so a halo plane comes from L2.  It reads its corners from
//   shared memory and stores each pair's C channels straight to query
//   order (scattered 4-byte stores; no slot order and no gather back).  A
//   block whose walk is empty stages nothing.  Rows whose bytes are not a
//   multiple of 16 are copied by the block's threads; a cell whose two
//   rows of one channel of two planes do not fit the tile's shared memory
//   is not staged: its blocks gather from the volume.
// * The splat accumulates its tile (all W, cc channels) in shared memory
//   with shared-memory atomics and stores each (channel, z row) span of
//   ty * W floats once with a 1D bulk async copy, so the 537 MB output
//   is written once and not zeroed first (the tiles partition every
//   cell).  In the design before it, a thread a plan slot added 8 C
//   values with global atomics into a zeroed output: 51 M atomics (80%
//   of its time) and a 537 MB fill at the nested volume
//   (scripts/probe_percell_splat.py).  A walk meets (dz + 1)(ty + 1) /
//   (dz ty) times the tile's own pairs, about one a thread, each a chain
//   of dependent loads and 8 C compare-and-swap adds: small blocks, many
//   an SM, hide that latency better than large tiles save halo pairs, so
//   the tile (ops/cuda/percell.py splat_geometry, chip_smoke.py's sweep)
//   is one z row of 18 y rows in 256-thread blocks, four an SM (62
//   registers a thread; forcing 6 or 12 blocks an SM spilled and lost,
//   PERF.md section 6), and so did issuing a pair's eight
//   compare-and-swap loops together in place of atomicAdd's one at a
//   time.  Rows too wide for a 256-thread block's share take a
//   1024-thread block, one an SM.
// * percell_plan is csrc/pair_bins.cuh's counting sort on the floors of
//   csrc/pair_corners.cuh, the kernels' own, so a walk always holds its
//   pairs' corner rows.  A key a (z row, y row) is 16 384 keys a 128^3
//   cell: a 64 KB count histogram, and 1 MB of starts at the nested
//   volume.
// * The TPU kernels' window DMA chain, z front pad, sublane-multiple
//   window rows and one-hot MXU contractions exist for VMEM and are not
//   carried over; the sort is.
// * f32 shared atomics and an order within a key set by atomics: the
//   splat is not deterministic (the blend is: each output is one block's).
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
// the most z rows a tile may own (ops/cuda/percell.py MAX_TILE_ROWS): a
// splat walks one slot range a z key of rows z0 - 1 to z0 + dz - 1
constexpr int kMaxTileRows = 64;
constexpr int kMaxRanges = kMaxTileRows + 1;

// The plan's keys: z key = z / kz, y key = y / ky of the clamped floors.
struct Keys {
  int kz, ky;
  int nzk, nyk;  // z and y keys a cell

  __host__ __device__ int per_cell() const { return nzk * nyk; }
};

inline Keys make_keys(int d, int h, int kz, int ky) {
  return Keys{kz, ky, csm::cdiv(d, kz), csm::cdiv(h, ky)};
}

// Tiles of one cell: z rows [zt * dz, ...) by y rows [band * ty, ...).
struct Tiles {
  int dz, ty;
  int nzt, nb;  // z tiles and y bands a cell

  __host__ __device__ int per_cell() const { return nzt * nb; }
};

inline Tiles make_tiles(int d, int h, int dz, int ty) {
  return Tiles{dz, ty, csm::cdiv(d, dz), csm::cdiv(h, ty)};
}

// A pair's key within its cell from the clamped floors of the kernels'
// own corner walk.
struct RowKey {
  int keys;
  Keys k;

  __device__ int operator()(const csm::PairShape& s, const float* grid,
                            int ni, int qi, const csm::SamplerParams& p) const {
    const int z = min(max(csm::pair_floor<3>(s, grid, ni, qi, 2, p), 0),
                      s.size[2] - 1);
    const int y = min(max(csm::pair_floor<3>(s, grid, ni, qi, 1, p), 0),
                      s.size[1] - 1);
    return (z / k.kz) * k.nyk + y / k.ky;
  }
};

// The block's tile: blockIdx.x = cell * tiles + tile, blockIdx.y = channel
// chunk of cc.
struct TileBlock {
  int ni, z0, y0;
  int rows, yrows;  // the tile's own rows, cut at the cell's edge
  int c0, cn;

  __device__ TileBlock(const csm::PairShape& s, const Tiles& t, int cc) {
    ni = blockIdx.x / t.per_cell();
    const int tile = blockIdx.x - ni * t.per_cell();
    const int zt = tile / t.nb;
    z0 = zt * t.dz;
    y0 = (tile - zt * t.nb) * t.ty;
    rows = min(t.dz, s.size[2] - z0);
    yrows = min(t.ty, s.size[1] - y0);
    c0 = blockIdx.y * cc;
    cn = min(cc, s.c - c0);
  }
};

// The plan's slots of the keys of floors z in [zlo, zhi] x y in [ylo, yhi]
// (clamped to the cell), laid end to end: range r is first[r] + [0,
// pre[r + 1] - pre[r]).  Returns the slot count; the whole block calls
// it (two barriers).
struct Walk {
  int first[kMaxRanges];
  int pre[kMaxRanges + 1];
};

__device__ int walk_init(Walk& wk, const int* __restrict__ starts,
                         const csm::PairShape& s, const Keys& k, int ni,
                         int zlo, int zhi, int ylo, int yhi) {
  zlo = max(zlo, 0) / k.kz;
  zhi = min(zhi, s.size[2] - 1) / k.kz;
  ylo = max(ylo, 0) / k.ky;
  yhi = min(yhi, s.size[1] - 1) / k.ky;
  const int nr = zhi - zlo + 1;
  const int* cell = starts + static_cast<int64_t>(ni) * k.per_cell();
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    const int* row = cell + (zlo + r) * k.nyk;
    const int f = __ldg(row + ylo);
    wk.first[r] = f;
    wk.pre[r + 1] = __ldg(row + yhi + 1) - f;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < nr; base += 32) {
      const int r = base + lane;
      int incl = r < nr ? wk.pre[r + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (r < nr) wk.pre[r + 1] = carry + incl;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) wk.pre[0] = 0;
  }
  __syncthreads();
  return wk.pre[nr];
}

// The slot of walk index i; *r (this thread's range, indices rising) is
// carried from call to call.
__device__ __forceinline__ int walk_slot(const Walk& wk, int i, int* r) {
  while (wk.pre[*r + 1] <= i) ++*r;
  return wk.first[*r] + i - wk.pre[*r];
}

// Block (blockIdx.x: cell * tiles + tile, blockIdx.y: channel chunk of cc)
// evaluates the pairs whose floor lies in its tile.  kStaged: from the
// tile's window in shared memory (bulk: staged by bulk copies, else by the
// threads); otherwise from the volume.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    percell_blend_kernel(const float* __restrict__ input,
                         const float* __restrict__ grid,
                         const int* __restrict__ perm,
                         const int* __restrict__ starts,
                         float* __restrict__ out, csm::PairShape s, Keys k,
                         Tiles t, int cc, csm::SamplerParams p, bool bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Walk wk;
  const TileBlock b(s, t, cc);
  const int total = walk_init(wk, starts, s, k, b.ni, b.z0,
                              b.z0 + b.rows - 1, b.y0, b.y0 + b.yrows - 1);
  if (total == 0) return;  // an empty walk stages nothing
  const int w = s.size[0], h = s.size[1], d = s.size[2];
  const int z0 = b.z0, y0 = b.y0;
  const int zrows = min(t.dz + 1, d - z0), yrows = min(t.ty + 1, h - y0);
  const int span = yrows * w;          // one (channel, z row) of the window
  const int win_elems = zrows * span;  // one channel
  const int cn = b.cn;
  const float* cells =
      input + (static_cast<int64_t>(b.ni) * s.c + b.c0) * s.texels;
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

  // a thread waits for the copies before its first corner read, and
  // before it exits in any case
  bool staged = !(kStaged && bulk);
  float* dst_cell = out + (static_cast<int64_t>(b.ni) * s.c + b.c0) * s.q;
  int r = 0;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int qi = __ldg(perm + walk_slot(wk, i, &r)) - b.ni * s.q;
    csm::AxisWeights a[3];
    csm::pair_axes<3>(s, grid, b.ni, qi, p, a);
    // keys coarser than rows: the pairs of other tiles' rows are theirs
    const int fz = min(max(a[2].i0, 0), d - 1) - z0;
    const int fy = min(max(a[1].i0, 0), h - 1) - y0;
    if (fz < 0 || fz >= b.rows || fy < 0 || fy >= b.yrows) continue;
    int off[8];
    float wgt[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int x = a[0].i0 + csm::corner_up<3>(kk, 0);
      const int y = a[1].i0 + csm::corner_up<3>(kk, 1);
      const int z = a[2].i0 + csm::corner_up<3>(kk, 2);
      // in the volume and, staged, in the window (the tile's pairs always
      // are; a corner outside both is out of bounds)
      const bool ok = x >= 0 && x < w && y >= 0 && y < h && z >= 0 && z < d &&
                      (!kStaged || (y >= y0 && y - y0 < yrows && z >= z0 &&
                                    z - z0 < zrows));
      off[kk] = !ok ? 0
                : kStaged ? ((z - z0) * yrows + (y - y0)) * w + x
                          : z * s.stride[2] + y * w + x;
      wgt[kk] = ok ? csm::corner_weight<3>(a, kk) : 0.0f;
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
      for (int kk = 0; kk < 8; ++kk)
        acc = fmaf(wgt[kk], kStaged ? src[off[kk]] : __ldg(src + off[kk]),
                   acc);
      dst[static_cast<int64_t>(c) * s.q] = acc;
    }
  }
  if (!staged) csm::barrier_wait(bar, 0);
}

// Block (blockIdx.x: cell * tiles + tile, blockIdx.y: channel chunk of cc)
// adds the pairs with a corner in its tile into shared memory and stores
// the tile once (bulk: by bulk copies, one a (channel, z row)).
template <int kBlockThreads, int kMinBlocks>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks)
    percell_splat_kernel(const float* __restrict__ gout,
                         const float* __restrict__ grid,
                         const int* __restrict__ perm,
                         const int* __restrict__ starts,
                         float* __restrict__ out, csm::PairShape s, Keys k,
                         Tiles t, int cc, csm::SamplerParams p, bool bulk) {
  extern __shared__ __align__(16) float acc[];
  __shared__ Walk wk;
  const TileBlock b(s, t, cc);
  const int w = s.size[0], hw = s.stride[2];
  const int z0 = b.z0, y0 = b.y0, rows = b.rows, yrows = b.yrows;
  const int span = yrows * w;          // one (channel, z row) of the tile
  const int tile_elems = rows * span;  // one channel
  const int acc_elems = b.cn * tile_elems;
  if (acc_elems % 4 == 0) {
    float4* acc4 = reinterpret_cast<float4*>(acc);
    for (int e = threadIdx.x; e < acc_elems / 4; e += blockDim.x)
      acc4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int e = threadIdx.x; e < acc_elems; e += blockDim.x) acc[e] = 0.0f;
  }
  // corners are floor and floor + 1: the pairs of floors z0 - 1 to
  // z0 + rows - 1 by y0 - 1 to y0 + yrows - 1 have one in the tile
  const int total = walk_init(wk, starts, s, k, b.ni, z0 - 1, z0 + rows - 1,
                              y0 - 1, y0 + yrows - 1);
  const float* g_cell =
      gout + (static_cast<int64_t>(b.ni) * s.c + b.c0) * s.q;
  int r = 0;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int qi = __ldg(perm + walk_slot(wk, i, &r)) - b.ni * s.q;
    csm::AxisWeights a[3];
    csm::pair_axes<3>(s, grid, b.ni, qi, p, a);
    int off[8];
    float wgt[8];
    bool any = false;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int x = a[0].i0 + csm::corner_up<3>(kk, 0);
      const int y = a[1].i0 + csm::corner_up<3>(kk, 1) - y0;
      const int z = a[2].i0 + csm::corner_up<3>(kk, 2) - z0;
      // in the tile (so in the volume on y and z)
      const bool ok = x >= 0 && x < w && y >= 0 && y < yrows && z >= 0 &&
                      z < rows;
      off[kk] = ok ? (z * yrows + y) * w + x : 0;
      wgt[kk] = ok ? csm::corner_weight<3>(a, kk) : 0.0f;
      any = any || wgt[kk] != 0.0f;
    }
    if (!any) continue;
    for (int c = 0; c < b.cn; ++c) {
      const float gv = __ldg(g_cell + static_cast<int64_t>(c) * s.q + qi);
      float* a_c = acc + c * tile_elems;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        if (wgt[kk] != 0.0f) atomicAdd(a_c + off[kk], wgt[kk] * gv);
    }
  }

  float* dst = out + (static_cast<int64_t>(b.ni) * s.c + b.c0) * s.texels +
               static_cast<int64_t>(z0) * hw + static_cast<int64_t>(y0) * w;
  if (bulk) {
    // the shared-memory atomics are generic-proxy writes: fence them
    // before the async proxy reads the tile
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int c = 0; c < b.cn; ++c)
        for (int z = 0; z < rows; ++z)
          csm::bulk_store(dst + static_cast<int64_t>(c) * s.texels +
                              static_cast<int64_t>(z) * hw,
                          acc + c * tile_elems + z * span,
                          static_cast<uint32_t>(span) * 4u);
      csm::bulk_store_wait();
    }
  } else {
    __syncthreads();
    for (int e = threadIdx.x; e < acc_elems; e += blockDim.x) {
      const int c = e / tile_elems;
      const int rest = e - c * tile_elems;
      const int z = rest / span;
      dst[static_cast<int64_t>(c) * s.texels + static_cast<int64_t>(z) * hw +
          (rest - z * span)] = acc[e];
    }
  }
}

// The instantiation for a splat launch's threads a block
// (ops/cuda/percell.py SplatTile): 256, four blocks an SM, or 1024, one
// block an SM; null for another.
using SplatFn = decltype(&percell_splat_kernel<256, 4>);
SplatFn splat_kernel(int threads) {
  switch (threads) {
    case 256: return &percell_splat_kernel<256, 4>;
    case 1024: return &percell_splat_kernel<1024, 1>;
    default: return nullptr;
  }
}

bool bad_grid(int d, int h, int kz, int ky, int dz, int ty) {
  return kz < 1 || ky < 1 || dz < 1 || ty < 1 || dz > d || ty > h ||
         dz > kMaxTileRows;
}

// The plan's starts hold N * K + 1 ints and a cell's keys fit the
// histogram: checked by the wrapper, which allocates them.
bool bad_launch(int n, const Tiles& t, int c, int cc) {
  return cc < 1 || static_cast<int64_t>(n) * t.per_cell() > 0x7fffffff ||
         csm::cdiv(c, cc) > 65535;
}

}  // namespace

extern "C" {

// dim must be 3; orders (ox, oy, oz) per grid axis; the plan's keys (kz,
// ky); the tile (dz, ty), its channels cc and staged (0 or 1) from
// ops/cuda/percell.py geometry; out (N, C, Q) in query order.
int percell_blend(const void* input, const void* grid, const void* perm,
                  const void* starts, void* out, int dim, int n, int c, int d,
                  int h, int w, int q, int grid_batch, int ox, int oy, int oz,
                  int kz, int ky, int dz, int ty, int cc, int staged,
                  int kernel, int padding, int align, int multicell,
                  int strict, float off_step, float off_stop, void* stream) {
  if (dim != 3 || csm::bad_pair_args(3, grid_batch, n, ox, oy, oz) ||
      bad_grid(d, h, kz, ky, dz, ty))
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(3, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  if (n == 0 || q == 0 || c == 0) return cudaGetLastError();
  const Tiles t = make_tiles(d, h, dz, ty);
  if (bad_launch(n, t, c, cc)) return cudaErrorInvalidValue;
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  const int64_t bytes =
      staged ? kBarrierBytes + static_cast<int64_t>(cc) *
                                   std::min(dz + 1, d) * std::min(ty + 1, h) *
                                   w * static_cast<int64_t>(sizeof(float))
             : 0;
  if (bytes + static_cast<int64_t>(sizeof(Walk)) > lim.smem_optin)
    return cudaErrorInvalidValue;
  // bulk copies take 16-byte aligned addresses and sizes
  const bool bulk =
      w % 4 == 0 && reinterpret_cast<uintptr_t>(input) % 16 == 0;
  auto* kernel_fn = staged ? &percell_blend_kernel<true>
                           : &percell_blend_kernel<false>;
  err = csm::allow_smem(kernel_fn, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  kernel_fn<<<dim3(static_cast<unsigned>(static_cast<int64_t>(n) *
                                         t.per_cell()),
                   csm::cdiv(c, cc)),
              kThreads, static_cast<size_t>(bytes),
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(input), static_cast<const float*>(grid),
      static_cast<const int*>(perm), static_cast<const int*>(starts),
      static_cast<float*>(out), s, make_keys(d, h, kz, ky), t, cc, p, bulk);
  return cudaGetLastError();
}

// Writes every element of out (N, C, D, H, W); the plan's keys (kz, ky)
// and the splat's tile (dz, ty), channels cc and threads a block (256 or
// 1024) from ops/cuda/percell.py splat_geometry.
int percell_splat(const void* gout, const void* grid, const void* perm,
                  const void* starts, void* out, int dim, int n, int c, int d,
                  int h, int w, int q, int grid_batch, int ox, int oy, int oz,
                  int kz, int ky, int dz, int ty, int cc, int threads,
                  int kernel, int padding, int align, int multicell,
                  int strict, float off_step, float off_stop, void* stream) {
  if (dim != 3 || csm::bad_pair_args(3, grid_batch, n, ox, oy, oz) ||
      bad_grid(d, h, kz, ky, dz, ty))
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(3, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  if (n == 0 || c == 0 || s.texels == 0) return cudaGetLastError();
  const Tiles t = make_tiles(d, h, dz, ty);
  SplatFn kernel_fn = splat_kernel(threads);
  if (bad_launch(n, t, c, cc) || kernel_fn == nullptr)
    return cudaErrorInvalidValue;
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  const int64_t bytes = static_cast<int64_t>(std::min(cc, c)) * dz * ty * w *
                        static_cast<int64_t>(sizeof(float));
  if (bytes + static_cast<int64_t>(sizeof(Walk)) > lim.smem_optin)
    return cudaErrorInvalidValue;
  const bool bulk = w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  err = csm::allow_smem(kernel_fn, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  kernel_fn<<<dim3(static_cast<unsigned>(static_cast<int64_t>(n) *
                                         t.per_cell()),
                   csm::cdiv(c, cc)),
              threads, static_cast<size_t>(bytes),
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gout), static_cast<const float*>(grid),
      static_cast<const int*>(perm), static_cast<const int*>(starts),
      static_cast<float*>(out), s, make_keys(d, h, kz, ky), t, cc, p, bulk);
  return cudaGetLastError();
}

// The plan of a grid over (N, C, D, H, W) cells with keys (kz, ky): key
// and rank (N * Q,) int32 scratch, starts (N * K + 1,) int32 zeroed, perm
// (N * Q,) int32, sums percell_scan_scratch(N * K) int32 scratch.
int percell_plan(const void* grid, void* key, void* rank, void* starts,
                 void* perm, void* sums, int n, int d, int h, int w, int q,
                 int grid_batch,
                 int kz, int ky, int padding, int align, int multicell,
                 int strict, float off_step, float off_stop, void* stream) {
  if (csm::bad_pair_args(3, grid_batch, n, 0, 0, 0) || kz < 1 || ky < 1)
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(3, n, 1, d, h, w, q, grid_batch, 0, 0, 0);
  const csm::SamplerParams p = csm::make_params(
      csm::kCosine, padding, align, multicell, strict, off_step, off_stop);
  const Keys k = make_keys(d, h, kz, ky);
  return csm::bins::sort_pairs(
      static_cast<const float*>(grid), static_cast<int*>(key),
      static_cast<int*>(rank), static_cast<int*>(starts),
      static_cast<int*>(perm), static_cast<int*>(sums), s, p,
      RowKey{k.per_cell(), k}, static_cast<cudaStream_t>(stream));
}

// The ints of percell_plan's scan scratch for m = N * K counts.
int percell_scan_scratch(int m) { return csm::bins::scan_scratch(m); }

}  // extern "C"
