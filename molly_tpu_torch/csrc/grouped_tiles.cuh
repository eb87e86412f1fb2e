// The group-aligned row tiles of the persistent grouped-GEMM kernels
// (grouped_gemm_int8_tma.cu, grouped_gemm_f32_tc.cu): a tile holds rows of
// ONE group, so the prefix sums of the group sizes (scanned once a block,
// kept in shared memory) say where each group's rows and tiles start.
#pragma once

#include <cuda_runtime.h>

namespace molly {

// s_row[g] is group g's first row (s_row[G] the first row no group owns,
// s_row[G + 1] = M), s_tile[g] its first row tile of BM rows (s_tile[G] the
// first tile of the rows no group owns, s_tile[G + 1] the tile count).
// Sizes are clipped to the rows that exist. One thread scans: a hundred
// groups cost about a microsecond a block. Ends with __syncthreads().
template <int BM, int THREADS>
__device__ __forceinline__ void scan_group_tiles(const int* group_sizes,
                                                 int G, int M, int* s_row,
                                                 int* s_tile) {
  for (int i = threadIdx.x; i < G; i += THREADS) s_row[i] = group_sizes[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int row = 0, tiles = 0;
    for (int g = 0; g < G; ++g) {
      const int sz = min(max(s_row[g], 0), M - row);
      s_row[g] = row;
      s_tile[g] = tiles;
      row += sz;
      tiles += (sz + BM - 1) / BM;
    }
    s_row[G] = row;
    s_row[G + 1] = M;
    s_tile[G] = tiles;
    s_tile[G + 1] = tiles + (M - row + BM - 1) / BM;
  }
  __syncthreads();
}

// Row tile `slot`'s group (G: rows no group owns) and its rows [b, e).
template <int BM>
__device__ __forceinline__ int locate_tile(const int* s_row,
                                           const int* s_tile, int G,
                                           int slot, int* b, int* e) {
  int lo = 0, hi = G;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_tile[mid + 1] > slot)
      hi = mid;
    else
      lo = mid + 1;
  }
  *b = s_row[lo] + (slot - s_tile[lo]) * BM;
  *e = min(s_row[lo + 1], *b + BM);
  return lo;
}

}  // namespace molly
