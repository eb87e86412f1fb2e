// Grouped GEMMs of the mixture-of-experts FFN for Hopper (sm_90a).
//
// Replaces: the megablox kernels that molly_tpu/ops/moe.py:_grouped_dot
// launches (jax.experimental.pallas.ops.tpu.megablox): `gmm`, also with
// transpose_rhs for the lhs gradient, and `tgmm`, the weight gradient that
// gmm's VJP reaches. Same semantics:
//   forward  out[r, :] = lhs[r, :] @ rhs[g(r)]     lhs [M, K], rhs [G, K, N]
//            (TRANS: rhs is [G, N, K] and is walked through its strides, no
//            transposed copy of the stack is made)
//   tgmm     out[g] = lhs[rows_g]^T @ dout[rows_g]  -> [G, K, N]
// Row r belongs to the group whose row range holds it; the ranges are the
// prefix sums of group_sizes [G] (int32, on the device, never read by the
// host). fp32 accumulation. Rows past sum(group_sizes) are written as
// zeros; tgmm writes exact zeros for an empty group.
//
// What the TPU kernel's shape was, and what this one does instead. megablox
// needs m % 128 == 0 and masks the stores of a tile that straddles two
// groups, because its grid walks fixed 128-row tiles in order. Here tiles
// are aligned to GROUPS: the grid has ceil(M / BM) + G row-tile slots (an
// upper bound on sum_g ceil(size_g / BM), plus the rows past the last
// group), times the column tiles. Each block stages group_sizes in shared
// memory, finds its (group, tile within the group) from the prefix sums,
// and covers rows start_g + t*BM .. min(start_g + (t+1)*BM, end_g): no
// padding, no straddling, and a slot past the real tile count exits at
// once. An empty group owns no tile, so it reads no weights.
//
// What bounds it on this card, and which kernel takes what. Prefill and
// training send hundreds of rows to each expert (M = 98,304 over 128 experts
// at qwen3-30b-a3b width): the product is bound by operations. At 64 rows a
// group and more, with aligned shapes, it is not in this file: bf16 experts
// (and the bf16 tgmm) run on TMA and wgmma in grouped_gemm_tma.cu, int8
// experts in grouped_gemm_int8_tma.cu, the fp32 expert adapters in
// grouped_gemm_f32_tc.cu. Decode and the serving tick (a bf16 lhs over bf16
// or int8 experts, few rows a group) run the split weight stream of
// grouped_gemm_decode.cu; ops/grouped_gemm.py picks the source. What stays
// here is everything else: the transposed product at few rows a group,
// fp32 products those rules exclude (an fp32 lhs in the forward, few rows a
// group), the fp32 tgmm, unaligned shapes. Two forward kernels sit behind
// the one entry point:
//   - anything in bf16 (mma.sync m16n8k16, bf16 operands, fp32
//     accumulators, 128-column tiles of 32 rows, or 128 at 64 rows a group
//     and more): the tile is converted to bf16 (int8 exactly) on its way to
//     shared memory, the next tile's loads started before the current
//     tile's products; the int8 per-(group, column) scale multiplies the
//     accumulator in the epilogue;
//   - nothing in bf16 (the fp32 test models, fp32 adapters): fp32 SIMT tiles.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GROUPS = 1024;
constexpr int kInt8 = 2;

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

// Which rows does row-tile slot `slot` cover? Returns the group (G for the
// rows past the last group, -1 for a slot past the real tile count) and the
// row range. `sizes` is the staged copy of group_sizes in shared memory.
// Branch-free over the groups so the loads pipeline.
__device__ __forceinline__ int find_tile(const int* sizes, int G, int M,
                                         int bm, int slot, int* begin,
                                         int* end) {
  int row = 0, tiles = 0, g_hit = -1, b = 0, e = 0;
  for (int g = 0; g < G; ++g) {
    const int sz = min(max(sizes[g], 0), M - row);
    const int nt = (sz + bm - 1) / bm;
    const bool hit = (g_hit < 0) && (slot < tiles + nt);
    if (hit) {
      g_hit = g;
      b = row + (slot - tiles) * bm;
      e = min(row + sz, b + bm);
    }
    tiles += nt;
    row += sz;
  }
  if (g_hit < 0) {  // rows no group owns
    const int nt = (M - row + bm - 1) / bm;
    if (slot < tiles + nt) {
      g_hit = G;
      b = row + (slot - tiles) * bm;
      e = min(M, b + bm);
    }
  }
  *begin = b;
  *end = e;
  return g_hit;
}

__device__ __forceinline__ void stage_sizes(int* dst, const int* group_sizes,
                                            int G) {
  for (int i = threadIdx.x; i < G; i += THREADS) dst[i] = group_sizes[i];
}

__device__ __forceinline__ void store_out(void* out, int out_f32,
                                          long long idx, float v) {
  if (out_f32)
    static_cast<float*>(out)[idx] = v;
  else
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
}

// 8 consecutive elements of a row as 8 bf16 (one 16-byte word)
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(molly::pack_bf16(a.x, a.y), molly::pack_bf16(a.z, a.w),
                    molly::pack_bf16(b.x, b.y), molly::pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const int8_t* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  return make_uint4(molly::pack_bf16((float)b[0], (float)b[1]),
                    molly::pack_bf16((float)b[2], (float)b[3]),
                    molly::pack_bf16((float)b[4], (float)b[5]),
                    molly::pack_bf16((float)b[6], (float)b[7]));
}

__device__ __forceinline__ float elem(const float* p) { return *p; }
__device__ __forceinline__ float elem(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float elem(const int8_t* p) { return (float)*p; }

// A ROWS x COLS tile of a row-major matrix on its way to shared memory as
// bf16, in two steps so that the loads of the NEXT tile are in flight while
// the current one is multiplied: fetch() reads this thread's 8-element
// chunks from device memory into registers (converting fp32 / int8 to bf16),
// stash() writes them to dst[r * LS + c]. Rows row0 .. are valid below
// row_lim, columns col0 .. below col_lim, zeros elsewhere. `vec`: the
// leading dimension is a multiple of 8 and src is 16-byte aligned, so every
// chunk is one aligned load that lies wholly inside or outside the matrix.
template <int ROWS, int COLS, int LS>
struct Tile {
  static constexpr int CHUNKS = COLS / 8;
  static constexpr int PER = (ROWS * CHUNKS + THREADS - 1) / THREADS;
  uint4 v[PER];

  template <typename T>
  __device__ __forceinline__ void fetch(const T* src, long long ld,
                                        long long row0, long long row_lim,
                                        int col0, int col_lim, bool vec) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
      const long long row = row0 + r;
      const int col = col0 + c;
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < ROWS * CHUNKS && row < row_lim && col < col_lim) {
        const T* p = src + row * ld + col;
        if (vec) {
          v[i] = load8(p);
        } else {
          float f[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = (col + e < col_lim) ? elem(p + e) : 0.f;
          v[i] = make_uint4(molly::pack_bf16(f[0], f[1]),
                            molly::pack_bf16(f[2], f[3]),
                            molly::pack_bf16(f[4], f[5]),
                            molly::pack_bf16(f[6], f[7]));
        }
      }
    }
  }

  __device__ __forceinline__ void stash(__nv_bfloat16* dst) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
      if (idx < ROWS * CHUNKS)
        *reinterpret_cast<uint4*>(&dst[r * LS + c]) = v[i];
    }
  }
};

// ldmatrix with .trans: the tile is stored [k][n] (n contiguous) and the
// mma wants its B fragment as pairs along k. Lanes 0-7 give the row
// addresses of the k 0-7 matrix, lanes 8-15 those of the k 8-15 matrix;
// lane (g = lane / 4, t = lane % 4) receives b0 = {B[2t][g], B[2t+1][g]},
// b1 = {B[2t+8][g], B[2t+9][g]}.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// Four 8 x 8 matrices, transposed: lanes 8j .. 8j+7 give matrix j's rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---------------------------------------------------------------------------
// Forward on the tensor cores. A block owns one group-aligned row tile of
// BM = 32 * WM rows and 128 columns; 8 warps as 2 (rows) x 4 (columns), each
// a (16 * WM) x 32 sub-tile. K advances 32 at a time: the lhs tile is staged
// [m][k], the rhs tile [k][n] (read with ldmatrix.trans) or, for TRANS,
// [n][k] as it lies in memory.
// ---------------------------------------------------------------------------

constexpr int BN = 128, BK = 32, PAD = 8;

template <typename TB, bool TRANS, int WM>
__global__ void __launch_bounds__(THREADS)
    grouped_gemm_mma_kernel(const void* __restrict__ lhs, int lhs_f32,
                            const TB* __restrict__ rhs,
                            const float* __restrict__ scale,
                            void* __restrict__ out, int out_f32,
                            const int* __restrict__ group_sizes, int G, int M,
                            int K, int N, int vec_a, int vec_b) {
  constexpr int BM = 32 * WM;
  constexpr int LSA = BK + PAD;                  // lhs tile row stride
  constexpr int LSB = TRANS ? BK + PAD : BN + PAD;
  constexpr int A_ELEMS = BM * LSA;
  constexpr int B_ELEMS = TRANS ? BN * LSB : BK * LSB;
  __shared__ __align__(16) __nv_bfloat16 As2[2 * A_ELEMS];  // two buffers
  __shared__ __align__(16) __nv_bfloat16 Bs2[2 * B_ELEMS];
  __shared__ int s_sizes[MAX_GROUPS];
  __shared__ int s_tile[3];

  stage_sizes(s_sizes, group_sizes, G);
  __syncthreads();
  if (threadIdx.x == 0) {
    int b, e;
    s_tile[0] = find_tile(s_sizes, G, M, BM, blockIdx.y, &b, &e);
    s_tile[1] = b;
    s_tile[2] = e;
  }
  __syncthreads();
  const int grp = s_tile[0];
  if (grp < 0) return;
  const int row_begin = s_tile[1], row_end = s_tile[2];
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  if (grp == G) {  // rows past the last group: zeros
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int r = row_begin + idx / BN, n = n0 + idx % BN;
      if (r < row_end && n < N)
        store_out(out, out_f32, (long long)r * N + n, 0.f);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const TB* rhs_g = rhs + (long long)grp * K * N;

  float acc[WM][4][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  Tile<BM, BK, LSA> ta;
  Tile<TRANS ? BN : BK, TRANS ? BK : BN, LSB> tb;
  auto fetch = [&](int k0) {
    if (lhs_f32)
      ta.fetch(static_cast<const float*>(lhs), K, row_begin, row_end, k0, K,
               vec_a);
    else
      ta.fetch(static_cast<const __nv_bfloat16*>(lhs), K, row_begin, row_end,
               k0, K, vec_a);
    if constexpr (TRANS)  // rhs_g is [N, K]: rows n, columns k
      tb.fetch(rhs_g, K, n0, N, k0, K, vec_b);
    else                  // rhs_g is [K, N]: rows k, columns n
      tb.fetch(rhs_g, N, k0, K, n0, N, vec_b);
  };

  // The next tile's loads are started before this tile's products and land
  // in the other buffer after them. The int8 forward keeps the plain
  // load-then-multiply loop: its conversions sit between the loads and the
  // products, and with the prefetch it measured 20% slower at prefill.
  constexpr bool PREFETCH = TRANS || !std::is_same<TB, int8_t>::value;
  const int nk = (K + BK - 1) / BK;
  if constexpr (PREFETCH) {
    fetch(0);
    ta.stash(As2);
    tb.stash(Bs2);
    __syncthreads();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = PREFETCH ? (kt & 1) : 0;
    const __nv_bfloat16* As = As2 + cur * A_ELEMS;
    const __nv_bfloat16* Bs = Bs2 + cur * B_ELEMS;
    const bool more = PREFETCH && kt + 1 < nk;
    if constexpr (!PREFETCH) {
      fetch(kt * BK);
      ta.stash(As2);
      tb.stash(Bs2);
      __syncthreads();
    }
    if (more) fetch((kt + 1) * BK);  // in flight during the products below
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[WM][4];
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const int r = wm * 16 * WM + i * 16 + g;
        af[i][0] = molly::ld32(&As[r * LSA + ks * 16 + t * 2]);
        af[i][1] = molly::ld32(&As[(r + 8) * LSA + ks * 16 + t * 2]);
        af[i][2] = molly::ld32(&As[r * LSA + ks * 16 + 8 + t * 2]);
        af[i][3] = molly::ld32(&As[(r + 8) * LSA + ks * 16 + 8 + t * 2]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8;
        uint32_t b0, b1;
        if constexpr (TRANS) {
          b0 = molly::ld32(&Bs[(c + g) * LSB + ks * 16 + t * 2]);
          b1 = molly::ld32(&Bs[(c + g) * LSB + ks * 16 + 8 + t * 2]);
        } else {
          ldmatrix_x2_trans(b0, b1, &Bs[(ks * 16 + (lane & 15)) * LSB + c]);
        }
#pragma unroll
        for (int i = 0; i < WM; ++i) molly::mma_bf16(acc[i][j], af[i], b0, b1);
      }
    }
    if (more) {  // the other buffer: nobody reads it in this iteration
      ta.stash(As2 + (cur ^ 1) * A_ELEMS);
      tb.stash(Bs2 + (cur ^ 1) * B_ELEMS);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * 32 + j * 8 + t * 2 + e;
      if (n >= N) continue;
      const float s = scale ? scale[(long long)grp * N + n] : 1.f;
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = row_begin + wm * 16 * WM + i * 16 + g + hr * 8;
          if (r < row_end)
            store_out(out, out_f32, (long long)r * N + n,
                      acc[i][j][2 * hr + e] * s);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward in fp32 on the SIMT units (nothing is bf16): 64 x 64 tiles, each
// of the 256 threads owns a 4 x 4 block of outputs. The lhs is fp32; the
// rhs fp32 or int8.
// ---------------------------------------------------------------------------

constexpr int SBM = 64, SBN = 64, SBK = 32;

template <typename TB, bool TRANS>
__global__ void __launch_bounds__(THREADS)
    grouped_gemm_simt_kernel(const float* __restrict__ lhs,
                             const TB* __restrict__ rhs,
                             const float* __restrict__ scale,
                             float* __restrict__ out,
                             const int* __restrict__ group_sizes, int G,
                             int M, int K, int N) {
  __shared__ __align__(16) float Xs[SBK][SBM + 4];  // lhs tile, transposed
  // rhs tile: [k][n] or, for TRANS, [n][k + 1] (it is loaded along k)
  constexpr int W_ELEMS = TRANS ? SBN * (SBK + 1) : SBK * SBN;
  __shared__ __align__(16) float Ws[W_ELEMS];
  __shared__ int s_sizes[MAX_GROUPS];
  __shared__ int s_tile[3];

  stage_sizes(s_sizes, group_sizes, G);
  __syncthreads();
  if (threadIdx.x == 0) {
    int b, e;
    s_tile[0] = find_tile(s_sizes, G, M, SBM, blockIdx.y, &b, &e);
    s_tile[1] = b;
    s_tile[2] = e;
  }
  __syncthreads();
  const int grp = s_tile[0];
  if (grp < 0) return;
  const int row_begin = s_tile[1], row_end = s_tile[2];
  const int n0 = blockIdx.x * SBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (grp < G) {
    const TB* rhs_g = rhs + (long long)grp * K * N;
    for (int k0 = 0; k0 < K; k0 += SBK) {
      for (int idx = tid; idx < SBM * SBK; idx += THREADS) {
        const int r = idx / SBK, kk = idx % SBK;
        const int m = row_begin + r, k = k0 + kk;
        Xs[kk][r] = (m < row_end && k < K) ? lhs[(long long)m * K + k] : 0.f;
      }
      for (int idx = tid; idx < SBK * SBN; idx += THREADS) {
        if (TRANS) {
          const int c = idx / SBK, kk = idx % SBK;
          const int k = k0 + kk, n = n0 + c;
          Ws[c * (SBK + 1) + kk] =
              (k < K && n < N) ? elem(&rhs_g[(long long)n * K + k]) : 0.f;
        } else {
          const int kk = idx / SBN, c = idx % SBN;
          const int k = k0 + kk, n = n0 + c;
          Ws[kk * SBN + c] =
              (k < K && n < N) ? elem(&rhs_g[(long long)k * N + n]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < SBK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
        const float a[4] = {av.x, av.y, av.z, av.w};
        float bw[4];
        if (TRANS) {
#pragma unroll
          for (int j = 0; j < 4; ++j) bw[j] = Ws[(tx * 4 + j) * (SBK + 1) + kk];
        } else {
          const float4 bv =
              *reinterpret_cast<const float4*>(&Ws[kk * SBN + tx * 4]);
          bw[0] = bv.x, bw[1] = bv.y, bw[2] = bv.z, bw[3] = bv.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = row_begin + ty * 4 + i;
    if (m >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const float s = (scale && grp < G) ? scale[(long long)grp * N + n] : 1.f;
      out[(long long)m * N + n] = acc[i][j] * s;
    }
  }
}

// ---------------------------------------------------------------------------
// tgmm. One block per (group, 128-row K tile, 128-column N tile) walks the
// group's rows 32 at a time: no atomics, the same bits on every run, and an
// empty group's block stores the zeros it started with. Both operands lie
// with the contraction (row) axis outermost, so both fragments are read with
// ldmatrix.trans.
// ---------------------------------------------------------------------------

// rows before group `grp`, summed by the whole block
__device__ __forceinline__ int rows_before(const int* group_sizes, int grp,
                                           int* s_red) {
  int part = 0;
  for (int i = threadIdx.x; i < grp; i += THREADS) part += max(group_sizes[i], 0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = part;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += s_red[w];
  return total;
}

constexpr int TBM = 128, TBN = 128, TBR = 32;

__global__ void __launch_bounds__(THREADS)
    tgmm_mma_kernel(const void* __restrict__ lhs, int lhs_f32,
                    const void* __restrict__ dout, int dout_f32,
                    void* __restrict__ out, int out_f32,
                    const int* __restrict__ group_sizes, int M, int K, int N,
                    int vec_a, int vec_b) {
  constexpr int LSA = TBM + PAD, LSB = TBN + PAD;
  constexpr int A_ELEMS = TBR * LSA, B_ELEMS = TBR * LSB;
  // two buffers each; lhs rows [r][k], dout rows [r][n]
  __shared__ __align__(16) __nv_bfloat16 As2[2 * A_ELEMS];
  __shared__ __align__(16) __nv_bfloat16 Bs2[2 * B_ELEMS];
  __shared__ int s_red[THREADS / 32];

  const int grp = blockIdx.z;
  const int i0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  const int row_begin = min(rows_before(group_sizes, grp, s_red), M);
  const int row_end = min(row_begin + max(group_sizes[grp], 0), M);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  Tile<TBR, TBM, LSA> ta;
  Tile<TBR, TBN, LSB> tb;
  auto fetch = [&](int r0) {
    if (lhs_f32)
      ta.fetch(static_cast<const float*>(lhs), K, r0, row_end, i0, K, vec_a);
    else
      ta.fetch(static_cast<const __nv_bfloat16*>(lhs), K, r0, row_end, i0, K,
               vec_a);
    if (dout_f32)
      tb.fetch(static_cast<const float*>(dout), N, r0, row_end, n0, N, vec_b);
    else
      tb.fetch(static_cast<const __nv_bfloat16*>(dout), N, r0, row_end, n0, N,
               vec_b);
  };

  const int nr = (row_end - row_begin + TBR - 1) / TBR;
  if (nr > 0) {
    fetch(row_begin);
    ta.stash(As2);
    tb.stash(Bs2);
  }
  __syncthreads();
  for (int rt = 0; rt < nr; ++rt) {
    const __nv_bfloat16* As = As2 + (rt & 1) * A_ELEMS;
    const __nv_bfloat16* Bs = Bs2 + (rt & 1) * B_ELEMS;
    const bool more = rt + 1 < nr;
    if (more) fetch(row_begin + (rt + 1) * TBR);
#pragma unroll
    for (int ks = 0; ks < TBR / 16; ++ks) {
      uint32_t af[4][4];
      // matrix j of the x4 load: rows r (j / 2) * 8 .., columns (j % 2) * 8
      const int mj = lane >> 3, mr = lane & 7;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = wm * 64 + i * 16 + (mj & 1) * 8;
        ldmatrix_x4_trans(
            af[i], &As[(ks * 16 + (mj >> 1) * 8 + mr) * LSA + col]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(
            b0, b1, &Bs[(ks * 16 + (lane & 15)) * LSB + wn * 32 + j * 8]);
#pragma unroll
        for (int i = 0; i < 4; ++i) molly::mma_bf16(acc[i][j], af[i], b0, b1);
      }
    }
    if (more) {
      ta.stash(As2 + ((rt + 1) & 1) * A_ELEMS);
      tb.stash(Bs2 + ((rt + 1) & 1) * B_ELEMS);
    }
    __syncthreads();
  }

  const long long base = (long long)grp * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kk = i0 + wm * 64 + i * 16 + g + hr * 8;
      if (kk >= K) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + t * 2 + e;
          if (n < N)
            store_out(out, out_f32, base + (long long)kk * N + n,
                      acc[i][j][2 * hr + e]);
        }
    }
}

// fp32 tgmm on the SIMT units: 64 x 64 output tiles, 4 x 4 a thread.
__global__ void __launch_bounds__(THREADS)
    tgmm_simt_kernel(const float* __restrict__ lhs,
                     const float* __restrict__ dout, float* __restrict__ out,
                     const int* __restrict__ group_sizes, int M, int K,
                     int N) {
  __shared__ __align__(16) float As[SBK][SBM];  // lhs rows: [r][k]
  __shared__ __align__(16) float Bs[SBK][SBN];  // dout rows: [r][n]
  __shared__ int s_red[THREADS / 32];

  const int grp = blockIdx.z;
  const int i0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row_begin = min(rows_before(group_sizes, grp, s_red), M);
  const int row_end = min(row_begin + max(group_sizes[grp], 0), M);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = row_begin; r0 < row_end; r0 += SBK) {
    for (int idx = tid; idx < SBK * SBM; idx += THREADS) {
      const int r = idx / SBM, c = idx % SBM;
      const int m = r0 + r;
      As[r][c] = (m < row_end && i0 + c < K) ? lhs[(long long)m * K + i0 + c] : 0.f;
      Bs[r][c] = (m < row_end && n0 + c < N) ? dout[(long long)m * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < SBK; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[r][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long long base = (long long)grp * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = i0 + ty * 4 + i;
    if (kk >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[base + (long long)kk * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TB, bool TRANS>
int launch_mma(const void* lhs, int lhs_dtype, const void* rhs,
               const float* scale, void* out, int out_dtype,
               const int* group_sizes, int M, int K, int N, int G,
               cudaStream_t stream) {
  const int lhs_f32 = lhs_dtype == molly::kFloat32;
  const int out_f32 = out_dtype == molly::kFloat32;
  const int vec_a = K % 8 == 0 && aligned16(lhs);
  // the rhs rows run along K (TRANS) or along N
  const int vec_b = (TRANS ? K : N) % 8 == 0 && aligned16(rhs) &&
                    ((long long)K * N * sizeof(TB)) % 16 == 0;
  const TB* w = static_cast<const TB*>(rhs);
  // many rows a group: 128-row tiles (bound by operations); few: 32-row
  // tiles, more blocks on the weight stream (bound by bytes)
  const bool big = (long long)M >= 64LL * G;
  if (big) {
    const dim3 grid((N + BN - 1) / BN, (M + 127) / 128 + G);
    grouped_gemm_mma_kernel<TB, TRANS, 4><<<grid, THREADS, 0, stream>>>(
        lhs, lhs_f32, w, scale, out, out_f32, group_sizes, G, M, K, N, vec_a,
        vec_b);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + 31) / 32 + G);
    grouped_gemm_mma_kernel<TB, TRANS, 1><<<grid, THREADS, 0, stream>>>(
        lhs, lhs_f32, w, scale, out, out_f32, group_sizes, G, M, K, N, vec_a,
        vec_b);
  }
  return cudaGetLastError();
}

template <typename TB, bool TRANS>
int launch_simt(const void* lhs, const void* rhs, const float* scale,
                void* out, const int* group_sizes, int M, int K, int N, int G,
                cudaStream_t stream) {
  const dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM + G);
  grouped_gemm_simt_kernel<TB, TRANS><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(lhs), static_cast<const TB*>(rhs), scale,
      static_cast<float*>(out), group_sizes, G, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// lhs [M, K] and out [M, N] row-major contiguous; rhs [G, K, N], or
// [G, N, K] with transpose_rhs, contiguous; scale [G, N] fp32 or null;
// group_sizes [G] int32 on the device. dtype codes: 0 fp32, 1 bf16, 2 int8
// (rhs only). With bf16 anywhere the product runs on the tensor cores (the
// rhs must then be bf16 or int8); with none it runs in fp32 (the lhs and
// out fp32, the rhs fp32 or int8).
extern "C" int molly_grouped_gemm(const void* lhs, const void* rhs,
                                  const float* scale, void* out,
                                  const int* group_sizes, int M, int K, int N,
                                  int G, int lhs_dtype, int rhs_dtype,
                                  int out_dtype, int transpose_rhs,
                                  void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > MAX_GROUPS)
    return cudaErrorInvalidValue;
  if ((lhs_dtype != molly::kFloat32 && lhs_dtype != molly::kBFloat16) ||
      (out_dtype != molly::kFloat32 && out_dtype != molly::kBFloat16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool any_bf16 = lhs_dtype == molly::kBFloat16 ||
                        rhs_dtype == molly::kBFloat16 ||
                        out_dtype == molly::kBFloat16;
#define MOLLY_GG(FN, TB, ...)                                              \
  (transpose_rhs ? FN<TB, true>(__VA_ARGS__) : FN<TB, false>(__VA_ARGS__))
  if (any_bf16) {
    if (rhs_dtype == molly::kBFloat16)
      return MOLLY_GG(launch_mma, __nv_bfloat16, lhs, lhs_dtype, rhs, scale,
                      out, out_dtype, group_sizes, M, K, N, G, s);
    if (rhs_dtype == kInt8)
      return MOLLY_GG(launch_mma, int8_t, lhs, lhs_dtype, rhs, scale, out,
                      out_dtype, group_sizes, M, K, N, G, s);
    return cudaErrorInvalidValue;
  }
  if (rhs_dtype == molly::kFloat32)
    return MOLLY_GG(launch_simt, float, lhs, rhs, scale, out, group_sizes, M,
                    K, N, G, s);
  if (rhs_dtype == kInt8)
    return MOLLY_GG(launch_simt, int8_t, lhs, rhs, scale, out, group_sizes, M,
                    K, N, G, s);
#undef MOLLY_GG
  return cudaErrorInvalidValue;
}

// lhs [M, K], dout [M, N], out [G, K, N], all row-major contiguous, fp32 or
// bf16 each; group_sizes [G] int32 on the device. All fp32: SIMT; else the
// tensor cores with fp32 operands rounded to bf16 as they are staged.
extern "C" int molly_grouped_gemm_tgmm(const void* lhs, const void* dout,
                                       void* out, const int* group_sizes,
                                       int M, int K, int N, int G,
                                       int lhs_dtype, int dout_dtype,
                                       int out_dtype, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || G <= 0 || G > MAX_GROUPS)
    return cudaErrorInvalidValue;
  auto is_float = [](int d) {
    return d == molly::kFloat32 || d == molly::kBFloat16;
  };
  if (!is_float(lhs_dtype) || !is_float(dout_dtype) || !is_float(out_dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f32 = molly::kFloat32;
  if (lhs_dtype == f32 && dout_dtype == f32 && out_dtype == f32) {
    const dim3 grid((N + SBN - 1) / SBN, (K + SBM - 1) / SBM, G);
    tgmm_simt_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(dout),
        static_cast<float*>(out), group_sizes, M, K, N);
    return cudaGetLastError();
  }
  const dim3 grid((N + TBN - 1) / TBN, (K + TBM - 1) / TBM, G);
  tgmm_mma_kernel<<<grid, THREADS, 0, s>>>(
      lhs, lhs_dtype == f32, dout, dout_dtype == f32, out, out_dtype == f32,
      group_sizes, M, K, N, K % 8 == 0 && aligned16(lhs),
      N % 8 == 0 && aligned16(dout));
  return cudaGetLastError();
}
