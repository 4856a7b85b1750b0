// fused3b's backward through private super-brick accumulators and a
// fold, for NVIDIA Hopper (sm_90a).
//
// fused3b_bwd_ghost replaces the TPU kernel
//   ops/pallas/fused3b.py::_fused3b_bwd_ghost_kernel of the JAX package
// fused3b_ghost_fold replaces its overlap-add epilogue
//   ops/pallas/fused3b.py::_fold_bricks
//
// Contract (the JAX package's pallas_fused3b_bwd_vol(..., ghost=True)):
// the volume cotangent of fused3b_blend (csrc/fused3b.cu) for a slot-ordered
// (7, C, QP) cotangent g and the brick plan, equal to fused3b_bwd's; only
// the accumulation differs.  A super-brick is one z slab z0 of the plan
// times rb consecutive y bins, numbered y-major, sbi = (ybin / rb) * nbz +
// z0 (ops/cuda/fused3b.py ghost_plan, which also remaps the plan's tail
// blocks as JAX does).  In the coordinates of a volume padded by fp texels
// in front of z and y (fp = 2, or 3 under reflection; nsh = fp + 1 slabs),
// super-brick (ysb, z0) covers slabs [z0, z0 + nsh) and rows
// [ysb * own, ysb * own + rows_s), own = rb * gy, rows_s = own + fp: every
// corner of a query its blocks hold.
//   ghost:  -> bricks (nsb, nsh, rows_s, W, N, C) f32: brick sbi holds the
//           contributions of its blocks' queries, written with plain
//           stores, never read back; bricks no block visited are not
//           written (uninitialized).
//   fold:   bricks, visited (nsb,) -> dvol (D, H, W, N, C) f32 (no zeroing
//           needed): each texel sums the y-bricks whose rows reach it
//           (2 for rb * gy >= fp) x nsh z-shifts in a fixed order, unvisited bricks selected out, never multiplied
//           (uninitialized memory may hold inf or nan).
// All three padding modes and interpolants, multicell on and off, both
// align_corners, any C.
//
// What bounds them on the H100 SXM (its data sheet's peaks at the 700 W
// power limit: 67 TFLOP/s f32, 3.35 TB/s), and the design:
// * fused3b_bwd adds every corner's C sums to the volume with a global
//   float4 atomic (128 M of them at BASELINE config 5).  Here one CUDA
//   block owns one super-brick, a chunk of its cells and one channel group
//   (of at most 8): it zeroes that part of the brick in shared memory,
//   walks the super-brick's plan blocks (ghost_plan's first / last) with
//   fused_rows.cuh's corner walk, adds with shared-memory atomics, and
//   stores the part to the private brick once.  No global atomics.
// * Sizes: one bin's window at config 5 is 4 rows x 3 slabs x 128 x 16
//   cells x 4 channels (393 KB), over a block's 227 KB, so the cells of a
//   brick are split over blocks (the corner walk is per (query, cell), so
//   nothing is computed twice but the query's loads); a block takes at
//   most half an SM's shared memory, so two share an SM and one's stores
//   overlap the other's atomics.  rb sets the bricks' bytes, nsh * (own +
//   fp) / own times the volume's (3.4x at rb = 8), and the blocks' count
//   (ops/cuda/fused3b.py GHOST_RB, measured).
// * The bricks' bytes, written once and read once by the fold, bound the
//   pair from below: 2 x 2.07 GB at config 5 and rb = 8, some 1.2 ms.
//   fused3b_bwd's own bound (the cotangent read, the volume written once)
//   is 0.2 ms: the private bricks cost nsh times the volume's bytes
//   before any atomic is saved.
// * Determinism: the fold sums in a fixed order, but the shared-memory
//   atomics within a brick add in an order that changes from run to run,
//   so the whole path is not bit-deterministic (chip_smoke.py prints the
//   max difference of two runs).
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_rows.cuh"

namespace {

// the plan's q_block (csrc/fused3b.cu)
constexpr int kQBlock = 128;
constexpr int kGhostThreads = 512;
constexpr int kFoldThreads = 256;

// The super-bricks' geometry (ops/cuda/fused3b.py _ghost_geom).
struct Bricks {
  int nbz;     // z slabs of the plan: sbi % nbz is z0
  int nysb;    // super-bricks along y
  int own;     // rows a super-brick owns: rb * gy
  int rows_s;  // rows it covers: own + fp
  int fp;      // the front pad of the padded coordinates
  int nsh;     // slabs it covers
};

// Block (s, by, bz): super-brick s, cells [by * cells_per_block, ...),
// channels [bz * G, bz * G + cg).
template <int G>
__global__ void __launch_bounds__(kGhostThreads)
    ghost_kernel(const float* __restrict__ g, const float* __restrict__ pts,
                 const float* __restrict__ occ, const int* __restrict__ hasv,
                 const int* __restrict__ sbi, const int* __restrict__ first,
                 const int* __restrict__ last,
                 const int* __restrict__ visited, float* __restrict__ bricks,
                 int n, int c, csm::CellGeom<3> geom, int qp, Bricks b,
                 int cells_per_block, csm::SamplerParams p) {
  constexpr int R = csm::kRows<3>;
  extern __shared__ float sacc[];
  const int s = blockIdx.x;
  if (visited[s] == 0) return;
  const int c0 = blockIdx.z * G;
  const int cg = min(G, c - c0);
  const int n0 = blockIdx.y * cells_per_block;
  const int n1 = min(n, n0 + cells_per_block);
  const int lanes = (n1 - n0) * cg;  // floats of one brick texel here
  const int w = geom.size[0];
  const int elems = b.nsh * b.rows_s * w * lanes;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) sacc[e] = 0.0f;
  __syncthreads();

  const int z0 = s % b.nbz;
  const int ys = (s / b.nbz) * b.own;
  const int slot1 = (last[s] + 1) * kQBlock;
  for (int slot = first[s] * kQBlock + threadIdx.x; slot < slot1;
       slot += blockDim.x) {
    const int blk = slot / kQBlock;
    if (sbi[blk] != s || hasv[blk] == 0 || occ[slot] == 0.0f) continue;
    float gv[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < G; ++j)
        gv[r][j] =
            j < cg ? __ldg(g + static_cast<int64_t>(r * c + c0 + j) * qp + slot)
                   : 0.0f;
    const float pt[3] = {pts[3 * slot], pts[3 * slot + 1], pts[3 * slot + 2]};
    for (int ni = n0; ni < n1; ++ni) {
      csm::for_each_corner_axes<3>(
          geom, pt, ni, n, p,
          [&](const int (&ci)[3], int, const float (&wr)[R]) {
            const int row = ci[1] + b.fp - ys;
            const int k = ci[2] + b.fp - z0;
            // the plan bins a query so that its corners lie in its brick
            // (the JAX kernel's window); a corner outside would be dropped
            // and the plain version, which checks, would disagree
            if (row < 0 || row >= b.rows_s || k < 0 || k >= b.nsh) return;
            float* dst = sacc + ((k * b.rows_s + row) * w + ci[0]) * lanes +
                         (ni - n0) * cg;
#pragma unroll
            for (int j = 0; j < G; ++j) {
              if (j < cg) {
                float v = 0.0f;
#pragma unroll
                for (int r = 0; r < R; ++r) v = fmaf(wr[r], gv[r][j], v);
                atomicAdd(dst + j, v);
              }
            }
          });
    }
  }
  __syncthreads();

  // this block's part of brick s, stored once
  const int64_t texel = static_cast<int64_t>(n) * c;
  float* out = bricks + static_cast<int64_t>(s) * b.nsh * b.rows_s * w * texel;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int t = e / lanes;
    const int l = e - t * lanes;
    const int ln = l / cg;
    out[t * texel + (n0 + ln) * c + c0 + (l - ln * cg)] = sacc[e];
  }
}

// One thread per V consecutive floats of dvol (V = 4: one texel's N * C
// values are a multiple of 4, the loads and stores 16 bytes).
template <int V>
__global__ void __launch_bounds__(kFoldThreads)
    fold_kernel(const float* __restrict__ bricks,
                const int* __restrict__ visited, float* __restrict__ dvol,
                int64_t total, int inner, int h, Bricks b) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int64_t e =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (e >= total) return;
  const int64_t zy = e / inner;
  const int rem = static_cast<int>(e - zy * inner);
  const int z = static_cast<int>(zy / h);
  const int y = static_cast<int>(zy - static_cast<int64_t>(z) * h);
  const int pz = z + b.fp;
  const int py = y + b.fp;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  // the y-brick that owns the row, then those whose spill rows reach it;
  // within each, z shifts 0 .. nsh - 1
  for (int dsb = 0; dsb * b.own < b.fp + b.own; ++dsb) {
    const int ysb = py / b.own - dsb;
    const int row = py - ysb * b.own;
    if (ysb < 0 || ysb >= b.nysb || row >= b.rows_s) continue;
    for (int k = 0; k < b.nsh; ++k) {
      const int zs = pz - k;
      if (zs < 0 || zs >= b.nbz) continue;
      const int sb = ysb * b.nbz + zs;
      if (visited[sb] == 0) continue;
      const float* src =
          bricks +
          ((static_cast<int64_t>(sb) * b.nsh + k) * b.rows_s + row) * inner +
          rem;
      const Vec x = *reinterpret_cast<const Vec*>(src);
      const float* xv = reinterpret_cast<const float*>(&x);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += xv[v];
    }
  }
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dvol + e) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    dvol[e] = acc[0];
  }
}

}  // namespace

extern "C" {

// bricks (nsb, nsh, rows_s, W, N, C): written for visited super-bricks.
int fused3b_bwd_ghost(const void* g, const void* pts, const void* occ,
                      const void* hasv, const void* sbi, const void* first,
                      const void* last, const void* visited, void* bricks,
                      int n, int c, int d, int h, int w, int qp, int nsb,
                      int nbz, int nysb, int own, int rows_s, int fp, int nsh,
                      int kernel, int padding, int align, int multicell,
                      int strict, float off_step, float off_stop,
                      void* stream) {
  if (qp % kQBlock != 0) return cudaErrorInvalidValue;
  if (nsb == 0 || n == 0 || c == 0) return cudaGetLastError();
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  const Bricks b{nbz, nysb, own, rows_s, fp, nsh};
  const int gw = csm::group_width(c);
  // one cell of one channel group's brick; as many cells as half an SM's
  // shared memory holds, or one up to the opted-in limit
  const int64_t cell_bytes = static_cast<int64_t>(nsh) * rows_s * w * gw * 4;
  if (cell_bytes > lim.smem_optin) return cudaErrorInvalidValue;
  const int64_t half = lim.smem_per_sm / 2 - 1024;
  const int cells_per_block = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(n, half / cell_bytes)));
  const size_t bytes = static_cast<size_t>(cells_per_block * cell_bytes);
  const dim3 grid(nsb, csm::cdiv(n, cells_per_block), csm::channel_groups(c));
  return csm::dispatch_channels(gw, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    auto* kernel_fn = &ghost_kernel<G>;
    cudaError_t e = csm::allow_smem(kernel_fn, bytes);
    if (e != cudaSuccess) return e;
    kernel_fn<<<grid, kGhostThreads, bytes,
                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const float*>(pts),
        static_cast<const float*>(occ), static_cast<const int*>(hasv),
        static_cast<const int*>(sbi), static_cast<const int*>(first),
        static_cast<const int*>(last), static_cast<const int*>(visited),
        static_cast<float*>(bricks), n, c, csm::cell_geom3(d, h, w), qp, b,
        cells_per_block, p);
    return cudaGetLastError();
  });
}

// dvol (D, H, W, N, C): every element written.
int fused3b_ghost_fold(const void* bricks, const void* visited, void* dvol,
                       int n, int c, int d, int h, int w, int nbz, int nysb,
                       int own, int rows_s, int fp, int nsh, void* stream) {
  const int inner = w * n * c;
  const int64_t total = static_cast<int64_t>(d) * h * inner;
  if (total == 0) return cudaGetLastError();
  const Bricks b{nbz, nysb, own, rows_s, fp, nsh};
  auto* src = static_cast<const float*>(bricks);
  auto* vis = static_cast<const int*>(visited);
  auto* out = static_cast<float*>(dvol);
  auto* cs = static_cast<cudaStream_t>(stream);
  if (inner % 4 == 0) {
    const int64_t threads = total / 4;
    fold_kernel<4><<<static_cast<unsigned>((threads + kFoldThreads - 1) /
                                           kFoldThreads),
                     kFoldThreads, 0, cs>>>(src, vis, out, total, inner, h, b);
  } else {
    fold_kernel<1><<<static_cast<unsigned>((total + kFoldThreads - 1) /
                                           kFoldThreads),
                     kFoldThreads, 0, cs>>>(src, vis, out, total, inner, h, b);
  }
  return cudaGetLastError();
}

}  // extern "C"
