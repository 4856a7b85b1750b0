// The whole 2D PINN train-step gradient in one launch, for NVIDIA Hopper
// (sm_90a).
//
// mega2w_step replaces the TPU kernel
//   ops/pallas/mega2w.py::_mega2w_kernel of the JAX package.
//
// Contract (the JAX kernel's, pinned there by tests/test_mega2w.py): the
// value and gradient of the fused PINN loss
//   loss = sum_q r_q^2 / Q,  r = allen_cahn or helmholtz residual of
//   u = w2 . tanh(W1^T f + b1) + b2 and its derivatives, f = the (5, C)
//   fused rows of query q summed over the N cells (csrc/fused_rows.cuh),
// with respect to the cells (N, C, H, W), w1 (C, Hd), b1 (Hd), w2 (Hd, 1)
// and b2 (1).  Equal to torch.autograd of pinn.loss_fused_slots up to f32
// summation order.
//
// The TPU kernel gets the MLP's cotangents from an in-kernel jax.vjp; here
// they are derived by hand, per query, with d1 = 1 - h^2, d2 = -2 h d1,
// d3 = (6 h^2 - 2) d1 and a_k = W1^T f_k, b_k = W1^T f_kk:
//   g_pre = w2 (g_u d1 + sum_k g_uk d2 a_k + g_ukk (d3 a_k^2 + d2 b_k))
//   g_a_k = w2 (g_uk d1 + 2 g_ukk d2 a_k),  g_b_k = w2 g_ukk d1
//   dw2  += g_u h + sum_k g_uk d1 a_k + g_ukk (d2 a_k^2 + d1 b_k)
//   db1  += g_pre,  dW1 += f g_pre + sum_k f_k g_a_k + f_kk g_b_k
//   g_f = W1 g_pre, g_f_k = W1 g_a_k, g_f_kk = W1 g_b_k
// and plain_mega2w_step (ops/cuda/mega2w.py) repeats them in PyTorch, held
// to torch.autograd in f64 by the CPU tests.  tanhf is the accurate libm
// one (no --use_fast_math): tanh saturates to +-1 and d1 to 0, so large
// pre-activations stay finite.
//
// What bounds it on the H100 SXM (its data sheet's peaks at the 700 W
// power limit: 67 TFLOP/s f32, 3.35 TB/s), and the design:
// * The work is the fused2w blend and splat (96 x 100 000 x 4 corners x 4
//   channels x 5 rows FMAs each at the main path, ~0.023 ms each at the
//   f32 peak) and a small MLP: bound by operations.  What the TPU kernel
//   keeps out of HBM, the (5C, Q) feature block, is 8 MB here (~2.4 us):
//   what one launch saves on this card is the launches and eager
//   operations of the two-kernel step around it.
// * Measured on the first design (one block of 512 an SM, each over
//   its own queries; H100 80GB HBM3, 700.00 W, PERF.md section 6): of its
//   ~1.18 ms at the main path, the splat took ~0.92 (shared-memory f32
//   atomicAdd compiles to a compare-and-swap loop, and a warp's lanes sat
//   on random texels of one 4 KB cell), the blend from L2 ~0.22, the MLP
//   ~0.04, and the per-block global-atomic flush of the 393 KB stack read
//   as nothing.
// * So cells a block can stage (mega2w_staged_kernel) take three phases
//   over work units of (chunk of cells, query slice), one unit a block,
//   with grid-wide barriers between them (a cooperative launch; two
//   blocks of 512 an SM up to 4 channels).  Phase 1: a unit stages its
//   chunk with bulk async copies (TMA) and blends its slice over the
//   chunk from shared memory into partial rows, stored to a scratch in
//   query order (chunks x 5C x Q floats: 32 MB at the main path, in L2).
//   Phase 2: a thread a query sums its partial rows and runs the MLP
//   forward, the residual and the backward above in registers; the MLP
//   gradients and the loss are summed over each warp with shuffles and
//   over the block with shared-memory atomics, and the feature cotangents
//   go to a second scratch (5C x Q).  Phase 3: a unit zeroes its chunk in
//   shared memory and splats its slice's cotangents with splat_o's
//   layout (csrc/blend_splat.cu): a warp's lanes split over up to 8 cells
//   whose strides (4 floats past a multiple of 32) put them in distinct
//   bank quads, so no two lanes of one compare-and-swap share a bank;
//   then one bulk async reduction a cell adds the chunk into the output
//   (12.7 MB of L2 adds at the main path).  The work units come from the
//   host (ops/cuda/mega2w.py geometry: 4 chunks of 24 cells x 66 slices
//   of 1 516 queries at the main path, 0.455-0.457 ms against 1.18 on
//   the same card; the sweep in chip_smoke.py times the alternatives).
//   What bounds it now is the splat's compare-and-swap adds, as in
//   splat_o (~0.28 ms of it), then the blend from shared memory (~0.14).
// * A cell over a block's shared memory takes mega2w_global_kernel: a
//   block over its own queries, the blend gathered through L1/L2 and the
//   splat added with global atomics.
// * Above 8 channels (mega2w_wide_kernel; JAX's kernel takes any C with
//   C + 4 <= 128) a thread cannot hold the 5C feature rows and their
//   cotangents in registers.  Stage 1 blends one channel group of at most
//   8 at a time (fused_rows.cuh group_width) and stores the rows to a
//   global scratch in query order (5C x Q floats, written and read back
//   by the same thread, so they stay in L1/L2).  Stage 2 walks the hidden
//   units 8 at a time: the first layer is linear in the features, so
//   their pre-activation rows pre, a_k, b_k are accumulated over the
//   channels from the scratch, and dW1 and the feature cotangents
//   g_f = W1 g_* of those 8 units are added channel by channel, the
//   cotangents into a second scratch of 5C x Q floats.  A grid-wide
//   barrier (a cooperative launch: one block an SM, all resident) then
//   lets stage 3 split the work as fused2w_bwd does: each block takes one
//   channel group (of at most 4) of one chunk of cells over one slice of
//   all the queries and flushes it once, so the stack is flushed once a
//   slice, where a per-block splat of its own queries flushed it once a
//   block (132 times; 5.3 ms a step at C = 16 against the autograd
//   fallback's 4.5, PERF.md section 6).  The scratch
//   was chosen over shared memory: 10C floats a query leave a block too
//   few queries at C = 16 (every block flushes the whole stack once per
//   group), and over recomputing the blend in stage 3, which would redo
//   the coordinate math of every (query, cell) a second time.
// * f32 atomics (shared and global): not deterministic; results agree with
//   the plain version to rounding.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "fused_rows.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxHidden = 32;
enum Pde : int { kAllenCahn = 0, kHelmholtz = 1 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// Adds the warp's sum of v into *dst (shared memory).
__device__ __forceinline__ void block_add(float* dst, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) atomicAdd(dst, v);
}

// Gradient row layout (floats): dW1 (C, Hd) row-major, db1 (Hd), dw2 (Hd),
// db2, loss.  The MLP is staged in shared memory in the same order.
__host__ __device__ inline int row_len(int c, int hidden) {
  return (c + 2) * hidden + 2;
}

// The MLP and its gradient row in shared memory.
struct Mlp {
  const float* w1;  // (C, Hd)
  const float* b1;
  const float* w2;
  float bias2;
  float* dw1;
  float* db1;
  float* dw2;
  float* db2;
  float* loss;
};

// Stages the MLP at smem[0, len) and zeroes the gradient row at smem[len,
// 2 len); the caller syncs the block before use.
__device__ __forceinline__ Mlp stage_mlp(float* smem, int c, int hidden,
                                         const float* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ b2) {
  const int len = row_len(c, hidden);
  Mlp m;
  float* s_w1 = smem;
  float* s_b1 = s_w1 + c * hidden;
  float* s_w2 = s_b1 + hidden;
  for (int i = threadIdx.x; i < c * hidden; i += blockDim.x) s_w1[i] = w1[i];
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    s_b1[i] = b1[i];
    s_w2[i] = w2[i];
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) smem[len + i] = 0.0f;
  m.w1 = s_w1;
  m.b1 = s_b1;
  m.w2 = s_w2;
  m.bias2 = __ldg(b2);
  m.dw1 = smem + len;
  m.db1 = m.dw1 + c * hidden;
  m.dw2 = m.db1 + hidden;
  m.db2 = m.dw2 + hidden;
  m.loss = m.db2 + 1;
  return m;
}

// Stage 2 for one query with feature rows f: the MLP forward, the residual
// and the backward of the header note, in registers.  Adds the query's
// MLP gradients and loss into the block's row (every lane of the warp must
// call it; an invalid lane adds zeros) and returns the feature cotangent
// in gf.
template <int C>
__device__ __forceinline__ void mlp_query(const Mlp& m, int hidden, int pde,
                                          float inv_q, bool valid,
                                          const float (&f)[5][C],
                                          float (&gf)[5][C]) {
  // forward: u, u_k, u_kk (k = x, y)
  float u = m.bias2, ud[2] = {0.0f, 0.0f}, udd[2] = {0.0f, 0.0f};
  for (int j = 0; j < hidden; ++j) {
    float pre = m.b1[j], a[2] = {0.0f, 0.0f}, b[2] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wc = m.w1[c * hidden + j];
      pre = fmaf(wc, f[0][c], pre);
      a[0] = fmaf(wc, f[1][c], a[0]);
      a[1] = fmaf(wc, f[2][c], a[1]);
      b[0] = fmaf(wc, f[3][c], b[0]);
      b[1] = fmaf(wc, f[4][c], b[1]);
    }
    const float h = tanhf(pre);
    const float d1 = 1.0f - h * h;
    const float d2 = -2.0f * h * d1;
    const float w2j = m.w2[j];
    u += w2j * h;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      ud[k] += w2j * (d1 * a[k]);
      udd[k] += w2j * (d2 * a[k] * a[k] + d1 * b[k]);
    }
  }

  // residual and its cotangents
  float r, gu, gud[2] = {0.0f, 0.0f}, gudd[2];
  if (pde == kAllenCahn) {
    r = 2.0f * ud[1] + 5.0f * u * u * u - 5.0f * u - 1e-4f * udd[0];
  } else {
    r = udd[0] + udd[1] + u;
  }
  const float gr = valid ? 2.0f * r * inv_q : 0.0f;
  if (pde == kAllenCahn) {
    gu = gr * (15.0f * u * u - 5.0f);
    gud[1] = 2.0f * gr;
    gudd[0] = -1e-4f * gr;
    gudd[1] = 0.0f;
  } else {
    gu = gr;
    gudd[0] = gr;
    gudd[1] = gr;
  }

  // backward through the MLP
#pragma unroll
  for (int rr = 0; rr < 5; ++rr)
#pragma unroll
    for (int c = 0; c < C; ++c) gf[rr][c] = 0.0f;
  for (int j = 0; j < hidden; ++j) {
    float pre = m.b1[j], a[2] = {0.0f, 0.0f}, b[2] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wc = m.w1[c * hidden + j];
      pre = fmaf(wc, f[0][c], pre);
      a[0] = fmaf(wc, f[1][c], a[0]);
      a[1] = fmaf(wc, f[2][c], a[1]);
      b[0] = fmaf(wc, f[3][c], b[0]);
      b[1] = fmaf(wc, f[4][c], b[1]);
    }
    const float h = tanhf(pre);
    const float d1 = 1.0f - h * h;
    const float d2 = -2.0f * h * d1;
    const float d3 = (6.0f * h * h - 2.0f) * d1;
    const float w2j = m.w2[j];
    float inner = gu * d1, dw2 = gu * h, ga[2], gb[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      inner += gud[k] * d2 * a[k] + gudd[k] * (d3 * a[k] * a[k] + d2 * b[k]);
      dw2 += gud[k] * d1 * a[k] + gudd[k] * (d2 * a[k] * a[k] + d1 * b[k]);
      ga[k] = w2j * (gud[k] * d1 + 2.0f * gudd[k] * d2 * a[k]);
      gb[k] = w2j * (gudd[k] * d1);
    }
    const float gpre = w2j * inner;
    block_add(m.db1 + j, gpre);
    block_add(m.dw2 + j, dw2);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wc = m.w1[c * hidden + j];
      block_add(m.dw1 + c * hidden + j,
                f[0][c] * gpre + f[1][c] * ga[0] + f[2][c] * ga[1] +
                    f[3][c] * gb[0] + f[4][c] * gb[1]);
      gf[0][c] = fmaf(wc, gpre, gf[0][c]);
      gf[1][c] = fmaf(wc, ga[0], gf[1][c]);
      gf[2][c] = fmaf(wc, ga[1], gf[2][c]);
      gf[3][c] = fmaf(wc, gb[0], gf[3][c]);
      gf[4][c] = fmaf(wc, gb[1], gf[4][c]);
    }
  }
  block_add(m.db2, gu);
  block_add(m.loss, valid ? r * r * inv_q : 0.0f);
}

// Cells too large to stage: block b owns queries [b * tile, (b + 1) *
// tile), blends each over all cells through L1/L2 into registers (stage
// 1), runs the MLP (stage 2), keeps the feature cotangents in shared
// memory and splats them with global atomics (stage 3).
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    mega2w_global_kernel(const float* __restrict__ cells,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ points,
                         float* __restrict__ dcells, float* __restrict__ grads,
                         int n, csm::CellGeom<2> geom, int q, int hidden,
                         int pde, int tile, csm::SamplerParams p) {
  extern __shared__ float smem[];
  const int len = row_len(C, hidden);
  const Mlp m = stage_mlp(smem, C, hidden, w1, b1, w2, b2);
  float* s_gf = smem + 2 * len;       // (5 * C, tile) feature cotangents
  __syncthreads();

  const int q0 = blockIdx.x * tile;
  const int nq = min(q, q0 + tile) - q0;
  const float inv_q = 1.0f / static_cast<float>(q);
  // stages 1 and 2; every thread runs every round (the warp sums need all
  // lanes), a lane past the block's queries with a zero cotangent
  for (int s = threadIdx.x; s - static_cast<int>(threadIdx.x) < tile;
       s += blockDim.x) {
    const bool valid = s < nq;
    float f[5][C];
    if (valid) {
      const float pt[2] = {points[2 * (q0 + s)], points[2 * (q0 + s) + 1]};
      csm::blend_query<2, C>(cells, geom, n, pt, p, f);
    } else {
#pragma unroll
      for (int r = 0; r < 5; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) f[r][c] = 0.0f;
    }
    float gf[5][C];
    mlp_query<C>(m, hidden, pde, inv_q, valid, f, gf);
    if (valid) {
#pragma unroll
      for (int rr = 0; rr < 5; ++rr)
#pragma unroll
        for (int c = 0; c < C; ++c) s_gf[(rr * C + c) * tile + s] = gf[rr][c];
    }
  }
  __syncthreads();

  for (int s = threadIdx.x; s < nq; s += blockDim.x) {
    float gv[5][C];
#pragma unroll
    for (int rr = 0; rr < 5; ++rr)
#pragma unroll
      for (int c = 0; c < C; ++c) gv[rr][c] = s_gf[(rr * C + c) * tile + s];
    const float pt[2] = {points[2 * (q0 + s)], points[2 * (q0 + s) + 1]};
    csm::splat_query<2, C>(dcells, geom, 0, n, n, pt, p, gv);
  }

  for (int i = threadIdx.x; i < len; i += blockDim.x)
    atomicAdd(grads + i, m.dw1[i]);
}

// One staged launch's work units (ops/cuda/mega2w.py geometry): chunk k
// of `cells` cells (the last may hold fewer) over query slice s of
// q_per_slice queries, unit k + chunks * s.
struct MegaGeom {
  int chunks;
  int cells;
  int stride;       // floats of one cell in shared memory (a multiple of 4)
  int slices;
  int q_per_slice;
  int lanes;        // cells a warp's lanes split over in the splat
  bool bulk;        // bulk copies and reductions (16-byte aligned cells)
};

// Floats of shared memory ahead of a staged block's cells: the MLP, its
// gradient row, and the mbarrier (4 floats), 16-byte aligned.
__host__ __device__ inline int staged_head(int c, int hidden) {
  return (2 * row_len(c, hidden) + 3) / 4 * 4 + 4;
}

// The register path over cells that a block can stage, in three phases
// separated by grid-wide barriers (a cooperative launch, all blocks
// resident).  Phase 1: a unit stages its chunk (bulk copies) and blends
// its slice's queries over the chunk from shared memory into partial rows
// (partial: chunks x 5C x Q floats, query order).  Phase 2: a thread a
// query sums its partial rows and runs the MLP; the feature cotangents go
// to gfeats (5C x Q).  Phase 3: a unit zeroes its chunk in shared memory,
// splats its slice's cotangents with a warp's lanes split over `lanes`
// cells (strides in distinct bank quads) and flushes each cell with one
// bulk reduction.  Two blocks an SM up to 4 channels (64 registers a
// thread), one above.
template <int C>
__global__ void __launch_bounds__(kThreads, C <= 4 ? 2 : 1)
    mega2w_staged_kernel(const float* __restrict__ cells,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ points,
                         float* __restrict__ dcells, float* __restrict__ grads,
                         float* __restrict__ partial,
                         float* __restrict__ gfeats, int n,
                         csm::CellGeom<2> geom, int q, int hidden, int pde,
                         MegaGeom g, csm::SamplerParams p) {
  extern __shared__ __align__(16) float smem[];
  const int len = row_len(C, hidden);
  const Mlp m = stage_mlp(smem, C, hidden, w1, b1, w2, b2);
  const int head = staged_head(C, hidden);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + head - 4);
  float* s_cells = smem + head;
  if (threadIdx.x == 0 && g.bulk) csm::barrier_init(bar);
  __syncthreads();

  const int cell_elems = C * geom.texels;
  const int units = g.chunks * g.slices;
  const int64_t rows_q = static_cast<int64_t>(5 * C) * q;
  uint32_t parity = 0;
  // phase 1: partial rows of each unit
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int k = u % g.chunks;
    const int n0 = k * g.cells;
    const int n1 = min(n, n0 + g.cells);
    const int qa = u / g.chunks * g.q_per_slice;
    const int qb = min(q, qa + g.q_per_slice);
    const float* src = cells + static_cast<int64_t>(n0) * cell_elems;
    if (g.bulk) {
      if (threadIdx.x == 0) {
        // the previous unit's shared loads are done (the block synced)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t bytes = static_cast<uint32_t>(cell_elems) * 4u;
        csm::barrier_expect(bar, bytes * (n1 - n0));
        for (int ln = 0; ln < n1 - n0; ++ln)
          csm::bulk_load(s_cells + ln * g.stride,
                         src + static_cast<int64_t>(ln) * cell_elems, bytes,
                         bar);
      }
      csm::barrier_wait(bar, parity);
      parity ^= 1u;
    } else {
      for (int e = threadIdx.x; e < (n1 - n0) * cell_elems; e += blockDim.x) {
        const int ln = e / cell_elems;
        s_cells[ln * g.stride + (e - ln * cell_elems)] = __ldg(src + e);
      }
      __syncthreads();
    }
    float* part = partial + k * rows_q;
    for (int qi = qa + threadIdx.x; qi < qb; qi += blockDim.x) {
      const float pt[2] = {points[2 * qi], points[2 * qi + 1]};
      float f[5][C];
#pragma unroll
      for (int r = 0; r < 5; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) f[r][c] = 0.0f;
      csm::blend_query_range<2, C>(s_cells, g.stride, geom, n0, n1, n, C, pt,
                                   p, f);
#pragma unroll
      for (int r = 0; r < 5; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c)
          part[static_cast<int64_t>(r * C + c) * q + qi] = f[r][c];
    }
    __syncthreads();
  }
  cooperative_groups::this_grid().sync();

  // phase 2: the MLP of each query; every thread of a block runs every
  // round (the warp sums need all lanes)
  const float inv_q = 1.0f / static_cast<float>(q);
  for (int base = blockIdx.x * kThreads; base < q;
       base += gridDim.x * kThreads) {
    const int qi = base + threadIdx.x;
    const bool valid = qi < q;
    float f[5][C];
#pragma unroll
    for (int r = 0; r < 5; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) f[r][c] = 0.0f;
    if (valid) {
      for (int k = 0; k < g.chunks; ++k)
#pragma unroll
        for (int r = 0; r < 5; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c)
            f[r][c] += partial[k * rows_q +
                               static_cast<int64_t>(r * C + c) * q + qi];
    }
    float gf[5][C];
    mlp_query<C>(m, hidden, pde, inv_q, valid, f, gf);
    if (valid) {
#pragma unroll
      for (int r = 0; r < 5; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c)
          gfeats[static_cast<int64_t>(r * C + c) * q + qi] = gf[r][c];
    }
  }
  cooperative_groups::this_grid().sync();

  // phase 3: each unit's splat, accumulated in shared memory
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane % g.lanes, lj = lane / g.lanes;
  const int runs = 32 / g.lanes;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int k = u % g.chunks;
    const int n0 = k * g.cells;
    const int n1 = min(n, n0 + g.cells);
    const int qa = u / g.chunks * g.q_per_slice;
    const int qb = min(q, qa + g.q_per_slice);
    float4* acc4 = reinterpret_cast<float4*>(s_cells);
    for (int e = threadIdx.x; e < (n1 - n0) * g.stride / 4; e += blockDim.x)
      acc4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    for (int qi = qa + warp * runs + lj; qi < qb;
         qi += (kThreads / 32) * runs) {
      float gv[5][C];
#pragma unroll
      for (int r = 0; r < 5; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c)
          gv[r][c] = gfeats[static_cast<int64_t>(r * C + c) * q + qi];
      const float pt[2] = {points[2 * qi], points[2 * qi + 1]};
      for (int ni = n0 + li; ni < n1; ni += g.lanes) {
        float* cell = s_cells + (ni - n0) * g.stride;
        csm::for_each_corner<2>(
            geom, pt, ni, n, p, [&](int idx, const float (&wr)[5]) {
#pragma unroll
              for (int c = 0; c < C; ++c) {
                float v = 0.0f;
#pragma unroll
                for (int r = 0; r < 5; ++r) v = fmaf(wr[r], gv[r][c], v);
                atomicAdd(cell + c * geom.texels + idx, v);
              }
            });
      }
    }
    float* dst = dcells + static_cast<int64_t>(n0) * cell_elems;
    if (g.bulk) {
      // the shared-memory atomics are generic-proxy writes: fence them
      // before the async proxy reads the chunk; one bulk reduction a cell
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int ln = 0; ln < n1 - n0; ++ln)
          csm::bulk_reduce_add(dst + static_cast<int64_t>(ln) * cell_elems,
                               s_cells + ln * g.stride,
                               static_cast<uint32_t>(cell_elems) * 4u);
        csm::bulk_store_wait();
      }
    } else {
      __syncthreads();
      for (int e = threadIdx.x; e < (n1 - n0) * cell_elems; e += blockDim.x) {
        const int ln = e / cell_elems;
        const float v = s_cells[ln * g.stride + (e - ln * cell_elems)];
        if (v != 0.0f) atomicAdd(dst + e, v);
      }
    }
    // the chunk is read out before the next unit zeroes it
    __syncthreads();
  }

  for (int i = threadIdx.x; i < len; i += blockDim.x)
    atomicAdd(grads + i, m.dw1[i]);
}

// Hidden units per pass of the wide kernel's stage 2.
constexpr int kHiddenBlock = 8;

// C > kMaxChannels: the kernel above with the feature rows and their
// cotangents in global scratch (feats, gfeats: 5C x Q floats each, row
// r * C + c, in query order), the blend in channel groups of G, the
// splat in groups of GS (fused_rows.cuh kBlendGroup / kBwdGroup).
template <int G, int GS, bool SMEM>
__global__ void __launch_bounds__(kThreads, 1)
    mega2w_wide_kernel(const float* __restrict__ cells,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ points,
                       float* __restrict__ dcells, float* __restrict__ grads,
                       float* __restrict__ feats, float* __restrict__ gfeats,
                       int n, int c, csm::CellGeom<2> geom, int q, int hidden,
                       int pde, int tile, int cells_per_chunk,
                       csm::SamplerParams p) {
  constexpr int HB = kHiddenBlock;
  extern __shared__ float smem[];
  const int len = row_len(c, hidden);
  const Mlp m = stage_mlp(smem, c, hidden, w1, b1, w2, b2);
  const float* s_w1 = m.w1;
  const float* s_b1 = m.b1;
  const float* s_w2 = m.w2;
  const float bias2 = m.bias2;
  float* s_grad = m.dw1;              // gradient row
  float* s_dw1 = m.dw1;
  float* s_db1 = m.db1;
  float* s_dw2 = m.dw2;
  float* s_db2 = m.db2;
  float* s_loss = m.loss;
  float* s_chunk = smem + 2 * len;
  __syncthreads();

  const int q0 = blockIdx.x * tile;
  const int nq = min(q, q0 + tile) - q0;
  const float inv_q = 1.0f / static_cast<float>(q);
  // row r, channel cc of the scratch
  auto at = [&](int r, int cc, int qi) {
    return (static_cast<int64_t>(r) * c + cc) * q + qi;
  };

  // stages 1 and 2; every thread runs every round (the warp sums need all
  // lanes), a lane past the block's queries with a zero cotangent
  for (int s = threadIdx.x; s - static_cast<int>(threadIdx.x) < tile;
       s += blockDim.x) {
    const bool valid = s < nq;
    const int qi = q0 + s;
    if (valid) {
      const float pt[2] = {points[2 * qi], points[2 * qi + 1]};
      for (int c0 = 0; c0 < c; c0 += G) {
        const int cg = min(G, c - c0);
        float f[5][G];
#pragma unroll
        for (int r = 0; r < 5; ++r)
#pragma unroll
          for (int j = 0; j < G; ++j) f[r][j] = 0.0f;
        csm::blend_query_range<2, G>(
            cells + static_cast<int64_t>(c0) * geom.texels,
            static_cast<int64_t>(c) * geom.texels, geom, 0, n, n, cg, pt, p,
            f);
#pragma unroll
        for (int r = 0; r < 5; ++r)
#pragma unroll
          for (int j = 0; j < G; ++j)
            if (j < cg) feats[at(r, c0 + j, qi)] = f[r][j];
      }
    }

    // pre, a_k, b_k of hidden units [j0, j0 + HB), summed over the channels
    auto hidden_rows = [&](int j0, float (&pre)[HB], float (&a)[2][HB],
                           float (&b)[2][HB]) {
#pragma unroll
      for (int jj = 0; jj < HB; ++jj) {
        pre[jj] = j0 + jj < hidden ? s_b1[j0 + jj] : 0.0f;
        a[0][jj] = a[1][jj] = b[0][jj] = b[1][jj] = 0.0f;
      }
      for (int cc = 0; cc < c; ++cc) {
        float f[5];
#pragma unroll
        for (int r = 0; r < 5; ++r) f[r] = valid ? feats[at(r, cc, qi)] : 0.0f;
#pragma unroll
        for (int jj = 0; jj < HB; ++jj) {
          if (j0 + jj < hidden) {
            const float wc = s_w1[cc * hidden + j0 + jj];
            pre[jj] = fmaf(wc, f[0], pre[jj]);
            a[0][jj] = fmaf(wc, f[1], a[0][jj]);
            a[1][jj] = fmaf(wc, f[2], a[1][jj]);
            b[0][jj] = fmaf(wc, f[3], b[0][jj]);
            b[1][jj] = fmaf(wc, f[4], b[1][jj]);
          }
        }
      }
    };

    // forward: u, u_k, u_kk (k = x, y)
    float u = bias2, ud[2] = {0.0f, 0.0f}, udd[2] = {0.0f, 0.0f};
    for (int j0 = 0; j0 < hidden; j0 += HB) {
      float pre[HB], a[2][HB], b[2][HB];
      hidden_rows(j0, pre, a, b);
#pragma unroll
      for (int jj = 0; jj < HB; ++jj) {
        if (j0 + jj >= hidden) continue;
        const float h = tanhf(pre[jj]);
        const float d1 = 1.0f - h * h;
        const float d2 = -2.0f * h * d1;
        const float w2j = s_w2[j0 + jj];
        u += w2j * h;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          ud[k] += w2j * (d1 * a[k][jj]);
          udd[k] += w2j * (d2 * a[k][jj] * a[k][jj] + d1 * b[k][jj]);
        }
      }
    }

    // residual and its cotangents
    float r, gu, gud[2] = {0.0f, 0.0f}, gudd[2];
    if (pde == kAllenCahn) {
      r = 2.0f * ud[1] + 5.0f * u * u * u - 5.0f * u - 1e-4f * udd[0];
    } else {
      r = udd[0] + udd[1] + u;
    }
    const float gr = valid ? 2.0f * r * inv_q : 0.0f;
    if (pde == kAllenCahn) {
      gu = gr * (15.0f * u * u - 5.0f);
      gud[1] = 2.0f * gr;
      gudd[0] = -1e-4f * gr;
      gudd[1] = 0.0f;
    } else {
      gu = gr;
      gudd[0] = gr;
      gudd[1] = gr;
    }

    // backward through the MLP, HB hidden units at a time: their
    // cotangents, then dW1 and g_f channel by channel
    for (int j0 = 0; j0 < hidden; j0 += HB) {
      float pre[HB], a[2][HB], b[2][HB];
      hidden_rows(j0, pre, a, b);
      float gpre[HB], ga[2][HB], gb[2][HB];
#pragma unroll
      for (int jj = 0; jj < HB; ++jj) {
        gpre[jj] = ga[0][jj] = ga[1][jj] = gb[0][jj] = gb[1][jj] = 0.0f;
        if (j0 + jj >= hidden) continue;
        const float h = tanhf(pre[jj]);
        const float d1 = 1.0f - h * h;
        const float d2 = -2.0f * h * d1;
        const float d3 = (6.0f * h * h - 2.0f) * d1;
        const float w2j = s_w2[j0 + jj];
        float inner = gu * d1, dw2 = gu * h;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float ak = a[k][jj], bk = b[k][jj];
          inner += gud[k] * d2 * ak + gudd[k] * (d3 * ak * ak + d2 * bk);
          dw2 += gud[k] * d1 * ak + gudd[k] * (d2 * ak * ak + d1 * bk);
          ga[k][jj] = w2j * (gud[k] * d1 + 2.0f * gudd[k] * d2 * ak);
          gb[k][jj] = w2j * (gudd[k] * d1);
        }
        gpre[jj] = w2j * inner;
        block_add(s_db1 + j0 + jj, gpre[jj]);
        block_add(s_dw2 + j0 + jj, dw2);
      }
      for (int cc = 0; cc < c; ++cc) {
        float f[5], gf[5];
#pragma unroll
        for (int rr = 0; rr < 5; ++rr) {
          f[rr] = valid ? feats[at(rr, cc, qi)] : 0.0f;
          gf[rr] = valid && j0 > 0 ? gfeats[at(rr, cc, qi)] : 0.0f;
        }
#pragma unroll
        for (int jj = 0; jj < HB; ++jj) {
          if (j0 + jj >= hidden) continue;
          const float wc = s_w1[cc * hidden + j0 + jj];
          block_add(s_dw1 + cc * hidden + j0 + jj,
                    f[0] * gpre[jj] + f[1] * ga[0][jj] + f[2] * ga[1][jj] +
                        f[3] * gb[0][jj] + f[4] * gb[1][jj]);
          gf[0] = fmaf(wc, gpre[jj], gf[0]);
          gf[1] = fmaf(wc, ga[0][jj], gf[1]);
          gf[2] = fmaf(wc, ga[1][jj], gf[2]);
          gf[3] = fmaf(wc, gb[0][jj], gf[3]);
          gf[4] = fmaf(wc, gb[1][jj], gf[4]);
        }
        if (valid) {
#pragma unroll
          for (int rr = 0; rr < 5; ++rr) gfeats[at(rr, cc, qi)] = gf[rr];
        }
      }
    }
    block_add(s_db2, gu);
    block_add(s_loss, valid ? r * r * inv_q : 0.0f);
  }
  // every block's feature cotangents are in gfeats past here
  cooperative_groups::this_grid().sync();

  // stage 3: the cells cotangent of all queries, one work item a block: a
  // channel group of one chunk of cells over one slice of the queries,
  // accumulated in shared memory and flushed once
  const int64_t cell_stride = static_cast<int64_t>(c) * geom.texels;
  const int chunks = (n + cells_per_chunk - 1) / cells_per_chunk;
  const int units = (c + GS - 1) / GS * chunks;
  const int slices = max(1, static_cast<int>(gridDim.x) / units);
  const int q_per_slice = (q + slices - 1) / slices;
  for (int item = blockIdx.x; item < units * slices; item += gridDim.x) {
    const int unit = item % units;
    const int c0 = unit / chunks * GS;
    const int cg = min(GS, c - c0);
    const int group_elems = cg * geom.texels;
    const int n0 = unit % chunks * cells_per_chunk;
    const int n1 = min(n, n0 + cells_per_chunk);
    const int chunk_elems = (n1 - n0) * group_elems;
    float* chunk_out = dcells + n0 * cell_stride +
                       static_cast<int64_t>(c0) * geom.texels;
    const int qa = item / units * q_per_slice;
    const int qb = min(q, qa + q_per_slice);
    if (SMEM) {
      for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x)
        s_chunk[e] = 0.0f;
      __syncthreads();
    }
    for (int qi = qa + threadIdx.x; qi < qb; qi += blockDim.x) {
      float gv[5][GS];
#pragma unroll
      for (int rr = 0; rr < 5; ++rr)
#pragma unroll
        for (int j = 0; j < GS; ++j)
          gv[rr][j] = j < cg ? gfeats[at(rr, c0 + j, qi)] : 0.0f;
      const float pt[2] = {points[2 * qi], points[2 * qi + 1]};
      if (SMEM) {
        csm::splat_query_range<2, GS>(s_chunk, group_elems, geom, n0, n1, n,
                                      cg, pt, p, gv);
      } else {
        csm::splat_query_range<2, GS>(chunk_out, cell_stride, geom, n0, n1,
                                      n, cg, pt, p, gv);
      }
    }
    if (SMEM) {
      __syncthreads();
      for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) {
        const float v = s_chunk[e];
        if (v != 0.0f) {
          const int ln = e / group_elems;
          atomicAdd(chunk_out + ln * cell_stride + (e - ln * group_elems), v);
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < len; i += blockDim.x)
    atomicAdd(grads + i, s_grad[i]);
}

template <int G, int GS>
cudaError_t launch_wide(const float* cells, const float* w1, const float* b1,
                        const float* w2, const float* b2, const float* points,
                        float* dcells, float* grads, float* scratch, int n,
                        int c, int h, int w, int q, int hidden, int pde,
                        const csm::SamplerParams& p, cudaStream_t stream) {
  if (q == 0 || n == 0 || h == 0 || w == 0) return cudaGetLastError();
  if (scratch == nullptr) return cudaErrorInvalidValue;
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  csm::CellGeom<2> geom;
  geom.size[0] = w;
  geom.size[1] = h;
  geom.texels = h * w;

  const int64_t head = 2 * static_cast<int64_t>(row_len(c, hidden)) * 4;
  if (head > lim.smem_optin) return cudaErrorInvalidValue;
  // one block per SM, each at least one round of threads; the rest of the
  // shared memory holds chunks of one channel group of cells
  const int tile = std::max(csm::cdiv(q, lim.sms), kThreads);
  const int blocks = csm::cdiv(q, tile);
  const int64_t space = lim.smem_optin - head;
  const int64_t group_bytes = static_cast<int64_t>(GS) * geom.texels * 4;
  const bool smem = group_bytes <= space;
  const int cells_per_chunk =
      smem ? static_cast<int>(std::min<int64_t>(n, space / group_bytes)) : n;
  const size_t bytes = static_cast<size_t>(
      head + (smem ? cells_per_chunk * group_bytes : 0));
  float* feats = scratch;
  float* gfeats = scratch + static_cast<int64_t>(5) * c * q;
  auto* kernel = smem ? &mega2w_wide_kernel<G, GS, true>
                      : &mega2w_wide_kernel<G, GS, false>;
  err = csm::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  // a cooperative launch: stage 3 waits for every block's stage 2
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (blocks > per_sm * lim.sms) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&cells, &w1,     &b1,     &w2,   &b2,
                  &points, &dcells, &grads, &feats, &gfeats,
                  &n,      &c,      &geom,  &q,     &hidden,
                  &pde,    const_cast<int*>(&tile),
                  const_cast<int*>(&cells_per_chunk),
                  const_cast<csm::SamplerParams*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(blocks), dim3(kThreads), args,
                                     bytes, stream);
}

// chunks 0: the global path; otherwise the staged kernel over the given
// work units, with scratch holding chunks x 5C x Q partial rows and then
// 5C x Q feature cotangents.
template <int C>
cudaError_t launch(const float* cells, const float* w1, const float* b1,
                   const float* w2, const float* b2, const float* points,
                   float* dcells, float* grads, float* scratch, int n, int h,
                   int w, int q, int hidden, int pde, MegaGeom g,
                   const csm::SamplerParams& p, cudaStream_t stream) {
  if (q == 0 || n == 0 || h == 0 || w == 0) return cudaGetLastError();
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  csm::CellGeom<2> geom;
  geom.size[0] = w;
  geom.size[1] = h;
  geom.texels = h * w;
  const int cell_elems = C * geom.texels;

  if (g.chunks == 0) {
    const int64_t head = 2 * static_cast<int64_t>(row_len(C, hidden)) * 4;
    const int64_t per_query = 5 * C * 4;
    // one block per SM, each at least one round of threads, its cotangent
    // tile within the opted-in shared memory
    const int max_tile =
        static_cast<int>((lim.smem_optin - head) / per_query);
    const int tile =
        std::min(max_tile, std::max(csm::cdiv(q, lim.sms), kThreads));
    const size_t bytes = static_cast<size_t>(head + tile * per_query);
    auto* kernel = &mega2w_global_kernel<C>;
    err = csm::allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<csm::cdiv(q, tile), kThreads, bytes, stream>>>(
        cells, w1, b1, w2, b2, points, dcells, grads, n, geom, q, hidden, pde,
        tile, p);
    return cudaGetLastError();
  }

  const size_t bytes =
      (static_cast<size_t>(staged_head(C, hidden)) +
       static_cast<size_t>(g.cells) * g.stride) * sizeof(float);
  if (scratch == nullptr || g.chunks < 1 || g.cells < 1 ||
      static_cast<int64_t>(g.chunks) * g.cells < n ||
      static_cast<int64_t>(g.chunks - 1) * g.cells >= n || g.slices < 1 ||
      g.q_per_slice < 1 ||
      static_cast<int64_t>(g.slices) * g.q_per_slice < q ||
      g.stride < cell_elems || g.stride % 4 != 0 ||
      (g.lanes != 1 && g.lanes != 2 && g.lanes != 4 && g.lanes != 8) ||
      bytes > static_cast<size_t>(lim.smem_optin))
    return cudaErrorInvalidValue;
  // bulk copies and reductions take 16-byte aligned addresses and sizes
  g.bulk = cell_elems % 4 == 0 &&
           reinterpret_cast<uintptr_t>(cells) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(dcells) % 16 == 0;
  auto* kernel = &mega2w_staged_kernel<C>;
  err = csm::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  // a cooperative launch: as many blocks as the card holds at once
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = per_sm * lim.sms;
  float* partial = scratch;
  float* gfeats = scratch + static_cast<int64_t>(g.chunks) * 5 * C * q;
  void* args[] = {&cells,   &w1,     &b1,    &w2,      &b2,
                  &points,  &dcells, &grads, &partial, &gfeats,
                  &n,       &geom,   &q,     &hidden,  &pde,
                  &g,       const_cast<csm::SamplerParams*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(blocks), dim3(kThreads), args,
                                     bytes, stream);
}

}  // namespace

extern "C" {

// dcells (N, C, H, W) and grads ((C + 2) * Hd + 2 floats: dW1 (C, Hd),
// db1, dw2, db2, loss) must be zeroed.  The work units (chunks, cells,
// stride, slices, q_per_slice, lanes) of ops/cuda/mega2w.py geometry;
// chunks 0: the global path, and above kMaxChannels channels the wide
// kernel, which ignores them.  scratch (uninitialized): 10 * C * Q floats
// above kMaxChannels channels, (chunks + 1) * 5 * C * Q on the staged
// path, unused (may be null) on the global path.
int mega2w_step(const void* cells, const void* w1, const void* b1,
                const void* w2, const void* b2, const void* points,
                void* dcells, void* grads, void* scratch, int n, int c, int h,
                int w, int q, int hidden, int pde, int chunks, int cells_per,
                int stride, int slices, int q_per_slice, int lanes,
                int kernel, int padding, int align, int multicell, int strict,
                float off_step, float off_stop, void* stream) {
  if (hidden < 1 || hidden > kMaxHidden || (pde != kAllenCahn &&
                                            pde != kHelmholtz))
    return cudaErrorInvalidValue;
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  if (c > csm::kMaxChannels) {
    using csm::fused::kBlendGroup;
    using csm::fused::kBwdGroup;
    return csm::dispatch_channels(
        csm::group_width(c, kBlendGroup), [&](auto gw) -> cudaError_t {
          constexpr int G = decltype(gw)::value;
          return csm::dispatch_channels(
              csm::group_width(c, kBwdGroup), [&](auto sw) -> cudaError_t {
                constexpr int GS = decltype(sw)::value;
                if constexpr (G > kBlendGroup / 2 && GS > kBwdGroup / 2 &&
                              GS <= kBwdGroup) {
                  return launch_wide<G, GS>(
                      static_cast<const float*>(cells),
                      static_cast<const float*>(w1),
                      static_cast<const float*>(b1),
                      static_cast<const float*>(w2),
                      static_cast<const float*>(b2),
                      static_cast<const float*>(points),
                      static_cast<float*>(dcells), static_cast<float*>(grads),
                      static_cast<float*>(scratch), n, c, h, w, q, hidden,
                      pde, p, static_cast<cudaStream_t>(stream));
                } else {
                  return cudaErrorInvalidValue;
                }
              });
        });
  }
  const MegaGeom g{chunks, cells_per, stride, slices, q_per_slice, lanes,
                   false};
  return csm::dispatch_channels(c, [&](auto cc) {
    return launch<decltype(cc)::value>(
        static_cast<const float*>(cells), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(points),
        static_cast<float*>(dcells), static_cast<float*>(grads),
        static_cast<float*>(scratch), n, h, w, q, hidden, pde, g, p,
        static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
