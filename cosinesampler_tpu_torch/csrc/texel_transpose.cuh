// The tiled transpose of a (rows, cols) matrix of 4- or 8-byte elements,
// bit for bit: the layout move between the cells (N * C, *S) and the
// texel-major (*S, N * C) copy of them, and the (Q, R * C) rows of the
// gathers to (R * C, Q).  Shared by fused3s (csrc/fused3s.cu, also the
// texel_transpose entry point of ops/cuda/fused3b.py's layout move) and
// the v1 pair (csrc/fused.cu).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace csm {

constexpr int kTile = 32;      // transpose tile: kTile x kTile elements
constexpr int kTileRows = 8;   // thread rows a transpose block

// out (cols, rows) = in (rows, cols) transposed, T a 4- or 8-byte element
// copied bit for bit: the cells (N * C, D * H * W) to the texel-major
// (D * H * W, N * C) and back.  A shared-memory tile makes both the reads
// and the writes rows of kTile elements a warp.  The longer of the two
// axes goes on grid axis x (2^31 - 1 blocks), the shorter on y (65 535):
// at 128^3, D * H * W needs 65 536 tiles.
template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
    transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                     int64_t rows, int64_t cols, bool rows_on_x) {
  __shared__ T tile[kTile][kTile + 1];
  const int64_t r0 = (rows_on_x ? blockIdx.x : blockIdx.y) *
                     static_cast<int64_t>(kTile);
  const int64_t c0 = (rows_on_x ? blockIdx.y : blockIdx.x) *
                     static_cast<int64_t>(kTile);
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kTileRows)
    if (r0 + i < rows && c0 + tx < cols)
      tile[i][tx] = in[(r0 + i) * cols + c0 + tx];
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += kTileRows)
    if (c0 + i < cols && r0 + tx < rows)
      out[(c0 + i) * rows + r0 + tx] = tile[tx][i];
}

// Launches transpose_kernel over (rows, cols) elements of elem_bytes (4 or
// 8) bytes on the stream.
inline cudaError_t transpose(const void* in, void* out, int64_t rows,
                             int64_t cols, int elem_bytes, cudaStream_t s) {
  if (rows == 0 || cols == 0) return cudaGetLastError();
  const bool rows_on_x = rows >= cols;
  const int64_t tx = (std::max(rows, cols) + kTile - 1) / kTile;
  const int64_t ty = (std::min(rows, cols) + kTile - 1) / kTile;
  if (tx > 2147483647 || ty > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tx), static_cast<unsigned>(ty));
  const dim3 block(kTile, kTileRows);
  if (elem_bytes == 4)
    transpose_kernel<uint32_t><<<grid, block, 0, s>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows,
        cols, rows_on_x);
  else if (elem_bytes == 8)
    transpose_kernel<uint64_t><<<grid, block, 0, s>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), rows,
        cols, rows_on_x);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace csm
