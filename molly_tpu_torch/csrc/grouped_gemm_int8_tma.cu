// Grouped GEMM over int8 experts for Hopper (sm_90a) at prefill and
// training shapes, on TMA and wgmma, the int8 tile converted to bf16 in
// registers, exactly.
//
// Replaces: megablox `gmm` (launched from molly_tpu/ops/moe.py:_grouped_dot
// over a quantize_experts dict: the int8 stack with its per-(group, column)
// scale), and `gmm` with transpose_rhs in its VJP (the lhs gradient of the
// QLoRA base), for the calls that ops/grouped_gemm.py:int8_takes_tma names:
// a bf16 product, at least 64 rows a group, K a multiple of 64, N of 16,
// 16-byte aligned bases. grouped_gemm_decode.cu keeps the forward at few
// rows a group, grouped_gemm.cu the rest.
//   forward  out[r, :] = (lhs[r, :] @ w[g(r)]) * scale[g(r)]
//            lhs [M, K] bf16, w [G, K, N] int8, scale [G, N] fp32
//   TRANS    out[r, :] = lhs[r, :] @ w[g(r)]^T,  w [G, N, K] int8: the
//            contraction runs along w's contiguous axis; the caller has
//            folded the scale into lhs's rows
// out [M, N] fp32 or bf16, fp32 accumulation. Rows past the last group are
// written as zeros; an empty group owns no tile and reads no weights.
//
// What bounds it: operations. The int8-experts prefill's fused gate-and-up
// ([98304, 2048] x [128, 2048, 1536]) does 618 GFLOP over 1.41 GB, three
// times the card's operations-per-byte ridge; the QLoRA base products at
// M = 32,768 likewise. So the products must run at the wgmma rate, the
// conversion must hide behind them, and the fp32 output (604 MB of the
// prefill's 1.41 GB) must leave in whole lines.
//
// The design joins int8_matmul_tma.cu's operand swap to grouped_gemm_tma.cu's
// group-aligned persistent pipeline. out^T = w^T lhs^T: a tile is 256 output
// columns (wgmma's m: two consumer warpgroups, each two m64 tiles) by 128
// lhs rows (wgmma's n) of ONE group: the prefix sums of the sizes (one scan
// a block, in shared memory) give each group's first row and first tile,
// and a tile covers rows b .. min(b + 128, group end). Rows of the lhs box
// past the group's end are multiplied and not stored. Persistent blocks, one
// an SM, walk the tiles group-major (a group's row tiles, each across its
// column tiles), so the blocks in flight share one group's weights (3 MB at
// the prefill) in L2. A producer thread keeps 4 stages of [128 x 64] bf16
// lhs and 16 KB of int8 weights in flight by TMA across tile boundaries, so
// a tile's epilogue overlaps the next tile's loads. The weight tile is the
// register A operand, converted from int8 in registers (exact: int8 values
// are bf16); each warpgroup converts the next stage while its products of
// this one run (two register sets). The lhs is the B operand, K-major as TMA
// brings it. A thread's four A rows (rows g and g + 8 of its two m64 tiles)
// are four ADJACENT output columns: the epilogue multiplies them by one
// float4 of scales and writes 16 bytes (fp32) of a row, 8 lanes a whole
// 128-byte line.
//
// The weights of a k step, per thread:
//   forward: w is [k][n]; one 32-bit load of row k gives the four columns
//     at one k (hopper.cuh int8_frags), 4 loads a k step, conflict-free
//     under the 128-byte swizzle (int8_matmul_tma.cu).
//   TRANS: w is [n][k], so a thread's four k of a row, {2t, 2t + 1, 2t + 8,
//     2t + 9} (wgmma's register layout), are not adjacent: two 16-bit loads
//     and a byte permute give them. The four output columns' rows come as
//     four sub-tiles, sub-tile i holding rows c0 + 4s + i (a tensor map over
//     every 4th row), so a thread's rows are row s of each and the 8
//     threads of a load read 8 consecutive rows: 64-byte rows in the 64-byte
//     swizzle put them on 32 different banks (two threads share a word).
//     The other way, one 32-bit load a row, needs the lhs's k permuted
//     within each 16 (4t .. 4t + 3 to 2t, 2t + 1, 2t + 8, 2t + 9) by the
//     pass that folds the scale; that pass, written through a permuted view,
//     cost more than the loads it saved (PERF.md), so the lhs is
//     taken as it lies.
// One block a tile, rows and k in order, no atomics: two runs give the same
// bits. The tensor maps are encoded at each launch and nothing is
// allocated, so a captured graph replays with new group sizes.

#include "common.cuh"
#include "grouped_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace molly::hopper;

constexpr int MAX_GROUPS = 1024;
constexpr int BM = 128;     // lhs rows of a tile (wgmma's n)
constexpr int BN = 256;     // output columns of a tile (2 warpgroups x 128)
constexpr int BK = 64;      // contraction elements a stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;               // consumers: warpgroups 0, 1
constexpr int X_BYTES = BM * BK * 2;       // 128 rows x 128 bytes
constexpr int W_BYTES = BN * BK;           // 256 columns x 64 k, int8
constexpr int SUB_BYTES = W_BYTES / 4;     // TRANS: one of four sub-tiles
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;           // 32 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment

struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// TRANS: the A fragments of two m64 tiles from one word a row: r_i holds row
// (column) c + i's int8 weights at k 2t, 2t + 1, 2t + 8, 2t + 9 (bytes 0-3).
// Tile 0 takes rows c (its row g) and c + 1 (g + 8), tile 1 c + 2 and c + 3.
__device__ __forceinline__ void int8_frags_rows(uint32_t r0, uint32_t r1,
                                                uint32_t r2, uint32_t r3,
                                                uint32_t (&a0)[4],
                                                uint32_t (&a1)[4]) {
  r0 ^= 0x80808080u;
  r1 ^= 0x80808080u;
  r2 ^= 0x80808080u;
  r3 ^= 0x80808080u;
  a0[0] = pack_exact_bf16(i8_biased_to_f32<0>(r0), i8_biased_to_f32<1>(r0));
  a0[1] = pack_exact_bf16(i8_biased_to_f32<0>(r1), i8_biased_to_f32<1>(r1));
  a0[2] = pack_exact_bf16(i8_biased_to_f32<2>(r0), i8_biased_to_f32<3>(r0));
  a0[3] = pack_exact_bf16(i8_biased_to_f32<2>(r1), i8_biased_to_f32<3>(r1));
  a1[0] = pack_exact_bf16(i8_biased_to_f32<0>(r2), i8_biased_to_f32<1>(r2));
  a1[1] = pack_exact_bf16(i8_biased_to_f32<0>(r3), i8_biased_to_f32<1>(r3));
  a1[2] = pack_exact_bf16(i8_biased_to_f32<2>(r2), i8_biased_to_f32<3>(r2));
  a1[3] = pack_exact_bf16(i8_biased_to_f32<2>(r3), i8_biased_to_f32<3>(r3));
}

template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
    grouped_gemm_int8_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                                 const __grid_constant__ CUtensorMap map_w0,
                                 const __grid_constant__ CUtensorMap map_w1,
                                 const __grid_constant__ CUtensorMap map_w2,
                                 const __grid_constant__ CUtensorMap map_w3,
                                 const float* __restrict__ scale,
                                 void* __restrict__ out, int out_f32,
                                 const int* __restrict__ group_sizes, int G,
                                 int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_row[MAX_GROUPS + 2], s_tile[MAX_GROUPS + 2];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  molly::scan_group_tiles<BM, THREADS>(group_sizes, G, M, s_row, s_tile);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&s_full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&s_empty[s], 8);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_ct = (N + BN - 1) / BN;
  const int total = s_tile[G + 1] * n_ct;
  const int n_k = K / BK;
  // the tile's group (G: rows no group owns) and rows [b, e)
  auto locate = [&](int tile, int* b, int* e) {
    return molly::locate_tile<BM>(s_row, s_tile, G, tile / n_ct, b, e);
  };

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // launched at 168 registers a thread: the producer warpgroup gives back
    // exactly the 64 more each consumer thread takes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      Ring r;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        int b, e;
        const int grp = locate(tile, &b, &e);
        if (grp == G) continue;
        const int c0 = (tile % n_ct) * BN;
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(&s_empty[r.stage], r.phase ^ 1);
          uint64_t* bar = &s_full[r.stage];
          mbar_expect_tx(bar, STAGE_BYTES);
          unsigned char* st = ring + r.stage * STAGE_BYTES;
          unsigned char* w = st + X_BYTES;
          tma_load_2d(st, &map_x, bar, kt * BK, b);  // 128 rows x 64 k
          if (!TRANS) {  // [G * K, N]: 64 k x 128 columns, twice
            tma_load_2d(w, &map_w0, bar, c0, grp * K + kt * BK);
            tma_load_2d(w + W_BYTES / 2, &map_w0, bar, c0 + 128,
                        grp * K + kt * BK);
          } else {       // [G * N, K] as four maps of every 4th row
            const int row = (grp * N + c0) >> 2;
            tma_load_2d(w, &map_w0, bar, kt * BK, row);
            tma_load_2d(w + SUB_BYTES, &map_w1, bar, kt * BK, row);
            tma_load_2d(w + 2 * SUB_BYTES, &map_w2, bar, kt * BK, row);
            tma_load_2d(w + 3 * SUB_BYTES, &map_w3, bar, kt * BK, row);
          }
          r.advance();
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ring_u32 = smem_u32(ring);
  Ring r;
  float acc0[64], acc1[64];
  // forward: this thread's four columns, 4 (8 warp + g) .. + 3 of its
  // warpgroup's 128-column box: their 16-byte chunk and the swizzled byte
  // offsets at the even (2t, 2t + 8) and odd (2t + 1, 2t + 9) rows
  const int chunk = 2 * warp + (g >> 2);
  const int off_e = ((chunk ^ (2 * t)) << 4) + 4 * (g & 3);
  const int off_o = ((chunk ^ (2 * t + 1)) << 4) + 4 * (g & 3);
  // TRANS: this thread's row of each sub-tile (64-byte rows, the 64-byte
  // swizzle XORs the 16-byte chunk with bits 1-2 of the row)
  const int srow = wg * 32 + 8 * warp + g;
  const int sw = (srow >> 1) & 3;
  // k step ks: a[2 ks] tile 0, a[2 ks + 1] tile 1
  auto convert = [&](uint32_t(&a)[8][4], int stage) {
    const unsigned char* wb = ring + stage * STAGE_BYTES + X_BYTES;
    if constexpr (!TRANS) {
      wb += wg * (W_BYTES / 2);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const unsigned char* row = wb + (16 * ks + 2 * t) * 128;
        int8_frags(*reinterpret_cast<const uint32_t*>(row + off_e),
                   *reinterpret_cast<const uint32_t*>(row + 128 + off_o),
                   *reinterpret_cast<const uint32_t*>(row + 8 * 128 + off_e),
                   *reinterpret_cast<const uint32_t*>(row + 9 * 128 + off_o),
                   a[2 * ks], a[2 * ks + 1]);
      }
    } else {
      const unsigned char* rb = wb + srow * 64;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned char* p = rb + i * SUB_BYTES + ((ks ^ sw) << 4);
          w[i] = __byte_perm(*reinterpret_cast<const uint16_t*>(p + 2 * t),
                             *reinterpret_cast<const uint16_t*>(p + 2 * t + 8),
                             0x5410u);
        }
        int8_frags_rows(w[0], w[1], w[2], w[3], a[2 * ks], a[2 * ks + 1]);
      }
    }
  };
  auto products = [&](uint32_t(&a)[8][4], int stage) {
    const uint32_t xb = ring_u32 + stage * STAGE_BYTES;
    fence_acc(acc0);
    fence_acc(acc1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t desc = smem_desc(xb + ks * 32, X_BYTES);
      wgmma_m64n128k16_rs<0>(acc0, a[2 * ks], desc);
      wgmma_m64n128k16_rs<0>(acc1, a[2 * ks + 1], desc);
    }
    wgmma_commit();
  };
  // products of stage r with `cur`; meanwhile stage r + 1 (if any) is
  // converted into `nxt`; then stage r is released
  auto step = [&](uint32_t(&cur)[8][4], uint32_t(&nxt)[8][4], bool more) {
    products(cur, r.stage);
    Ring n = r;
    n.advance();
    if (more) {
      mbar_wait(&s_full[n.stage], n.phase);
      convert(nxt, n.stage);
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    fence_regs(cur);
    if (lane == 0) mbar_arrive(&s_empty[r.stage]);
    r = n;
  };
  uint32_t a0[8][4], a1[8][4];
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int b, end;
    const int grp = locate(tile, &b, &end);
    const int c0 = (tile % n_ct) * BN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    if (grp < G) {
      mbar_wait(&s_full[r.stage], r.phase);
      convert(a0, r.stage);
      for (int kt = 0; kt < n_k; kt += 2) {
        step(a0, a1, kt + 1 < n_k);
        if (kt + 1 < n_k) step(a1, a0, kt + 2 < n_k);
      }
    }
    // out^T row 16 warp + g of tile i is column col + 2i, row + 8 is col +
    // 2i + 1; accumulator 4j + e (+ 2) is lhs row b + 8j + 2t + e
    const int col = c0 + wg * 128 + 4 * (8 * warp + g);
    if (col < N) {  // N % 16 == 0: the four columns lie in or out together
      float4 s = make_float4(1.f, 1.f, 1.f, 1.f);
      if (!TRANS && grp < G)
        s = *reinterpret_cast<const float4*>(scale + (long long)grp * N +
                                             col);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = b + 8 * j + 2 * t + e;
          if (row >= end) continue;
          const float v0 = acc0[4 * j + e] * s.x;
          const float v1 = acc0[4 * j + 2 + e] * s.y;
          const float v2 = acc1[4 * j + e] * s.z;
          const float v3 = acc1[4 * j + 2 + e] * s.w;
          const long long at = (long long)row * N + col;
          if (out_f32)
            *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
                make_float4(v0, v1, v2, v3);
          else
            *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) +
                                      at) =
                make_uint2(molly::pack_bf16(v0, v1),
                           molly::pack_bf16(v2, v3));
        }
    }
    __syncwarp();
  }
}

// A [rows, cols] matrix of 1- or 2-byte elements whose rows lie
// `row_bytes` apart, as boxes of box_rows x box_cols, zeros out of bounds
bool make_map(CUtensorMap* map, const void* ptr, int elem_bytes,
              long long rows, long long cols, long long row_bytes,
              int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map,
                elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TRANS>
int launch(const void* lhs, const int8_t* w, const float* scale, void* out,
           int out_f32, const int* group_sizes, int M, int K, int N, int G,
           cudaStream_t stream) {
  alignas(64) CUtensorMap map_x, map_w[4];
  if (!make_map(&map_x, lhs, 2, M, K, 2LL * K, BM, BK,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (!TRANS) {
    if (!make_map(&map_w[0], w, 1, (long long)G * K, N, N, BK, 128,
                  CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    map_w[1] = map_w[2] = map_w[3] = map_w[0];
  } else {
    // sub-tile i: rows i, 4 + i, 8 + i, ... of [G * N, K]
    for (int i = 0; i < 4; ++i)
      if (!make_map(&map_w[i], w + (long long)i * K, 1, (long long)G * N / 4,
                    K, 4LL * K, 64, BK, CU_TENSOR_MAP_SWIZZLE_64B))
        return cudaErrorInvalidValue;
  }
  auto kernel = grouped_gemm_int8_tma_kernel<TRANS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles =
      ((long long)(M + BM - 1) / BM + G) * ((N + BN - 1) / BN);
  const int sms = current_sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      map_x, map_w[0], map_w[1], map_w[2], map_w[3], scale, out, out_f32,
      group_sizes, G, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// lhs [M, K] bf16, w [G, K, N] int8 with
// scale [G, N] fp32, or (transpose_rhs) w [G, N, K] int8 without a scale;
// out [M, N] fp32 or bf16 (dtype codes of common.cuh); all contiguous and
// 16-byte aligned; K a multiple of 64, N of 16.
extern "C" int molly_grouped_gemm_int8_tma(const void* lhs, const int8_t* w,
                                           const float* scale, void* out,
                                           const int* group_sizes, int M,
                                           int K, int N, int G, int out_dtype,
                                           int transpose_rhs, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > MAX_GROUPS || K % BK ||
      N % 16 || !aligned16(lhs) || !aligned16(w) || !aligned16(out))
    return cudaErrorInvalidValue;
  if (transpose_rhs ? scale != nullptr
                    : (scale == nullptr || !aligned16(scale)))
    return cudaErrorInvalidValue;
  if (out_dtype != molly::kFloat32 && out_dtype != molly::kBFloat16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f32 = out_dtype == molly::kFloat32;
  return transpose_rhs ? launch<true>(lhs, w, nullptr, out, f32,
                                      group_sizes, M, K, N, G, s)
                       : launch<false>(lhs, w, scale, out, f32, group_sizes,
                                       M, K, N, G, s);
}
