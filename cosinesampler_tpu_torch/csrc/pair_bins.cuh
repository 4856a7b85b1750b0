// A counting sort of the (cell, query) pairs of one grid by a per-cell key,
// on the card with no host sync, shared by the slab bins (csrc/slab.cu,
// key: the floor row of the leading axis) and the percell plan
// (csrc/percell.cu, key: the z row and y row of the floor corner, or
// coarser rows where a cell has too many).
//
// Output: perm (N * Q,) int32, the pair n * Q + q of each slot, ordered by
// (cell, key), and starts (N * K + 1,) int32, the first slot of each
// (cell, key) and the pair count last.  Three kernels:
// * count: each block counts kPerThread queries a thread of one cell in a
//   shared-memory histogram of the cell's K keys (the atomics' return
//   values rank each pair within the block) and adds each key's count to
//   the global one once (the return value is the block's base), four
//   adds in flight a thread; one global atomic a pair took most of the
//   build's time.  Blocks of kThreads (2048 queries) up to kWideKeys
//   keys, of kWideThreads (8192 queries) above it: the percell plan's
//   row keys (16 384 a 128^3 cell) outnumber a small block's queries, so
//   its histogram's zeroing and flush would cost more than its queries;
// * scan: an exclusive scan of the N * K counts: one block's, or, given
//   a scratch for them and more than kScanThreads * kScanSerial counts,
//   in chunks of kScanChunk, a block each (their sums, one block's scan of
//   those, each chunk's scan from its base: the percell plan's hundreds
//   of thousands of row keys would leave one block 256 serial loads a
//   thread);
// * scatter: perm[starts[key] + rank] = pair; above kWideKeys keys each
//   block takes 8192 pairs of one cell and first
//   copies the cell's starts into shared memory, in place of a random L2
//   read a pair.
// The order within a key is that of the atomics: not deterministic.
//
// A key functor has `int keys` (K, at most the shared-memory histogram's
// room) and `__device__ int operator()(const PairShape&, const float* grid,
// int ni, int qi, const SamplerParams&) const` in [0, K); it takes its
// floors from csrc/pair_corners.cuh's pair_floor, the kernels' own, so a
// pair's bin holds its corners.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "pair_corners.cuh"

namespace csm {
namespace bins {

constexpr int kThreads = 256;
// queries of one cell a count thread takes
constexpr int kPerThread = 8;
// the count's blocks above kWideKeys keys, and the threads of such a
// scatter block and the queries each takes
constexpr int kWideThreads = 1024;
constexpr int kWideKeys = 4096;
constexpr int kScatterThreads = 512;
constexpr int kScatterPerThread = 16;
constexpr int kScanThreads = 1024;
// counts a thread of the one-block scan takes in turn, at most, where the
// chunked scan may serve
constexpr int kScanSerial = 32;
// counts a block of the chunked scan takes, 4 a thread
constexpr int kChunkThreads = 256;
constexpr int kScanChunk = 4 * kChunkThreads;

// Block b counts queries [(b % qb) * kT * kPerThread, ...) of cell b / qb.
template <class Key, int kT>
__global__ void __launch_bounds__(kT)
    count_kernel(const float* __restrict__ grid, int* __restrict__ key,
                 int* __restrict__ rank, int* __restrict__ counts,
                 PairShape s, SamplerParams p, Key kf, int qb) {
  extern __shared__ int hist[];
  const int ni = blockIdx.x / qb;
  const int q0 = (blockIdx.x - ni * qb) * kT * kPerThread + threadIdx.x;
  int* cell_counts = counts + static_cast<int64_t>(ni) * kf.keys;
  for (int k = threadIdx.x; k < kf.keys; k += kT) hist[k] = 0;
  __syncthreads();
  int kk[kPerThread], local[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int qi = q0 + i * kT;
    kk[i] = -1;
    if (qi < s.q) {
      kk[i] = kf(s, grid, ni, qi, p);
      local[i] = atomicAdd(hist + kk[i], 1);
    }
  }
  __syncthreads();
  // four keys a thread at a time, their global adds in flight together
  for (int k0 = threadIdx.x; k0 < kf.keys; k0 += 4 * kT) {
    int c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * kT;
      c[j] = k < kf.keys ? hist[k] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c[j] != 0) c[j] = atomicAdd(cell_counts + k0 + j * kT, c[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + j * kT < kf.keys) hist[k0 + j * kT] = c[j];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (kk[i] < 0) continue;
    const int pair = ni * s.q + q0 + i * kT;
    key[pair] = ni * kf.keys + kk[i];
    rank[pair] = local[i] + hist[kk[i]];
  }
}

// counts[0, m) -> their exclusive prefix sums in place, counts[m] = total:
// one block, each thread over a contiguous chunk
static __global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* __restrict__ counts, int m) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int per = (m + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, m), hi = min(lo + per, m);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = (warp > 0 ? warp_sums[warp - 1] : 0) + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (t == kScanThreads - 1) counts[m] = run;
}

// An exclusive scan of the values of one block's threads (t = threadIdx.x)
// in shared memory of blockDim.x / 32 ints; returns the block total in
// *total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int s = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  *total = warp_sums[(blockDim.x >> 5) - 1];
  return (warp > 0 ? warp_sums[warp - 1] : 0) + incl - v;
}

// The four counts of thread t of chunk blockIdx.x (0 past m).
__device__ __forceinline__ int4 chunk_counts(const int* counts, int m) {
  const int i = blockIdx.x * kScanChunk + 4 * threadIdx.x;
  if (i + 3 < m) return *reinterpret_cast<const int4*>(counts + i);
  return make_int4(i < m ? counts[i] : 0, i + 1 < m ? counts[i + 1] : 0,
                   i + 2 < m ? counts[i + 2] : 0, 0);
}

// sums[b] = the sum of chunk b of counts[0, m)
static __global__ void __launch_bounds__(kChunkThreads)
    chunk_sum_kernel(const int* __restrict__ counts, int* __restrict__ sums,
                     int m) {
  __shared__ int warp_sums[kChunkThreads / 32];
  const int4 v = chunk_counts(counts, m);
  int total;
  block_exclusive_scan(v.x + v.y + v.z + v.w, warp_sums, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// chunk b of counts[0, m) -> its exclusive prefix sums from base[b] (the
// scanned chunk sums), in place; counts[m] = base[chunks], the total
static __global__ void __launch_bounds__(kChunkThreads)
    chunk_scan_kernel(int* __restrict__ counts,
                      const int* __restrict__ base, int m) {
  __shared__ int warp_sums[kChunkThreads / 32];
  const int4 v = chunk_counts(counts, m);
  int total;
  int run = __ldg(base + blockIdx.x) +
            block_exclusive_scan(v.x + v.y + v.z + v.w, warp_sums, &total);
  const int i = blockIdx.x * kScanChunk + 4 * threadIdx.x;
  const int vals[4] = {v.x, v.y, v.z, v.w};
  if (i + 3 < m) {
    int4 out;
    out.x = run;
    out.y = run + v.x;
    out.z = out.y + v.y;
    out.w = out.z + v.z;
    *reinterpret_cast<int4*>(counts + i) = out;
  } else {
    for (int j = 0; j < 4 && i + j < m; ++j) {
      counts[i + j] = run;
      run += vals[j];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    counts[m] = __ldg(base + gridDim.x);
}

static __global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int* __restrict__ key, const int* __restrict__ rank,
                   const int* __restrict__ starts, int* __restrict__ perm,
                   int pairs) {
  const int pair = blockIdx.x * blockDim.x + threadIdx.x;
  if (pair >= pairs) return;
  perm[__ldg(starts + key[pair]) + rank[pair]] = pair;
}

// Block b scatters the pairs of queries [(b % qb) * kScatterThreads *
// kScatterPerThread, ...) of cell b / qb, its cell's keys' starts in
// shared memory.
static __global__ void __launch_bounds__(kScatterThreads)
    scatter_cell_kernel(const int* __restrict__ key,
                        const int* __restrict__ rank,
                        const int* __restrict__ starts,
                        int* __restrict__ perm, int q, int keys, int qb) {
  extern __shared__ int cell_starts[];
  const int ni = blockIdx.x / qb;
  const int* src = starts + static_cast<int64_t>(ni) * keys;
  for (int k = threadIdx.x; k < keys; k += kScatterThreads)
    cell_starts[k] = __ldg(src + k);
  __syncthreads();
  const int q0 =
      (blockIdx.x - ni * qb) * kScatterThreads * kScatterPerThread;
  const int q1 = min(q0 + kScatterThreads * kScatterPerThread, q);
  const int base = ni * keys;
  for (int qi = q0 + threadIdx.x; qi < q1; qi += kScatterThreads) {
    const int pair = ni * q + qi;
    perm[cell_starts[__ldg(key + pair) - base] + __ldg(rank + pair)] = pair;
  }
}

// The scratch of the chunked scan of m counts: cdiv(m, kScanChunk) + 1
// ints.
inline int scan_scratch(int m) { return cdiv(m, kScanChunk) + 1; }

// counts[0, m) -> their exclusive prefix sums in place, counts[m] =
// total; sums: null, or scan_scratch(m) ints of scratch for the chunked
// scan, which serves above kScanThreads * kScanSerial counts.
inline cudaError_t scan_counts(int* counts, int* sums, int m,
                               cudaStream_t stream) {
  if (sums == nullptr || m <= kScanThreads * kScanSerial) {
    scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, m);
    return cudaGetLastError();
  }
  const int chunks = cdiv(m, kScanChunk);
  chunk_sum_kernel<<<chunks, kChunkThreads, 0, stream>>>(counts, sums, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_kernel<<<1, kScanThreads, 0, stream>>>(sums, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_scan_kernel<<<chunks, kChunkThreads, 0, stream>>>(counts, sums, m);
  return cudaGetLastError();
}

// key and rank (N * Q,) int32 scratch, starts (N * K + 1,) int32 zeroed,
// perm (N * Q,) int32; sums null or scan_scratch(N * K) ints of scratch
// (scan_counts).  The key count must fit a block's shared memory.
template <class Key>
cudaError_t sort_pairs(const float* grid, int* key, int* rank, int* starts,
                       int* perm, int* sums, const PairShape& s,
                       const SamplerParams& p, const Key& kf,
                       cudaStream_t stream) {
  if (s.n == 0 || s.q == 0) return cudaGetLastError();
  DeviceLimits lim;
  cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return err;
  const int64_t hist_bytes = static_cast<int64_t>(kf.keys) * sizeof(int);
  const bool wide = kf.keys > kWideKeys;
  const int threads = wide ? kWideThreads : kThreads;
  const int qb = cdiv(s.q, threads * kPerThread);
  if (kf.keys < 1 || hist_bytes > lim.smem_optin ||
      static_cast<int64_t>(s.n) * qb > 0x7fffffff)
    return cudaErrorInvalidValue;
  auto* count = wide ? &count_kernel<Key, kWideThreads>
                     : &count_kernel<Key, kThreads>;
  err = allow_smem(count, static_cast<size_t>(hist_bytes));
  if (err != cudaSuccess) return err;
  count<<<s.n * qb, threads, hist_bytes, stream>>>(grid, key, rank, starts,
                                                   s, p, kf, qb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = scan_counts(starts, sums, s.n * kf.keys, stream);
  if (err != cudaSuccess) return err;
  if (wide) {
    err = allow_smem(&scatter_cell_kernel, static_cast<size_t>(hist_bytes));
    if (err != cudaSuccess) return err;
    const int sqb = cdiv(s.q, kScatterThreads * kScatterPerThread);
    scatter_cell_kernel<<<s.n * sqb, kScatterThreads, hist_bytes, stream>>>(
        key, rank, starts, perm, s.q, kf.keys, sqb);
  } else {
    const int pairs = s.n * s.q;
    scatter_kernel<<<cdiv(pairs, kThreads), kThreads, 0, stream>>>(
        key, rank, starts, perm, pairs);
  }
  return cudaGetLastError();
}

}  // namespace bins
}  // namespace csm
