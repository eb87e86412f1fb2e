// Int8 weight-only GEMM at decode shapes for Hopper (sm_90a): a stream of
// the weights, out = (x @ w_q) * scale for bf16 x with at most 16 rows.
//
// Replaces: molly_tpu/ops/quant.py:_kernel (launched from int8_matmul) for
// the calls that ops/quant.py:int8_takes_stream names: bf16 x, 1 <= M <= 16,
// K a multiple of 64, N of 16, 16-byte aligned bases. Same semantics: x [M,
// K] as given (no rounding), w_q [K, N] int8 row-major as quantize_int8
// gives it, products summed in fp32, the per-column fp32 scale applied once,
// out [M, N] bf16.
//
// What bounds it: bytes. A decode step multiplies 4 rows by every weight:
// 2 M operations a weight byte, far below the card's ridge. The call must
// keep every SM streaming with tens of KB in flight, read each weight byte
// once, and convert the int8 tile to bf16 fast enough not to fall behind
// the loads (the conversion, not the products, is the consumers' work).
//
// The design.
//   - A static plan (ops/quant.py:gemv_plan, from K, N and the SM count,
//     never from data, so a captured graph replays with new x): the grid is
//     (split, column tile of 128); K splits into whole 64-element stages
//     only while the blocks stay within three quarters of the SMs (the lm
//     head's 1,187 tiles take one split, decode down's 16 take 6): a
//     cluster's blocks must share a GPC, so a grid near the SM count left
//     some SMs two blocks, and the call waits for those.
//   - Operands swapped, as in grouped_gemm_decode.cu: out^T = w^T x^T on
//     mma.sync m16n8k16, the weight's columns on m, x's rows on n (one n8
//     chunk at M <= 8, two at M <= 16). The int8 tile stays bytes in shared
//     memory and is converted to bf16 in registers, exactly
//     (hopper.cuh: int8_frags).
//   - A producer warp keeps STAGES stages in flight by TMA (128-byte
//     swizzle): the weight tile [64 k x 128 columns] and x [16 rows x 64 k]
//     (rows past M arrive as zeros). Consumer warps: four column groups of
//     32 times K_PARTS stage residues: warp (c, r) takes the stages i = r
//     mod K_PARTS. A warp's work on a stage is one dependent chain (wait,
//     loads, conversion, products), so the stages a warp walks set the
//     time, not the instructions: K_PARTS warps a column group walk 1 /
//     K_PARTS of them each. Their sums are added in the fixed order r = 0 ..
//     K_PARTS-1 in shared memory.
//   - The splits of one column tile are the blocks of one cluster. Each
//     writes its fp32 partial to its shared memory; after a cluster barrier,
//     block s sums its share of the tile's columns over the splits in order
//     0 .. S-1 through distributed shared memory (all S loads issued before
//     the first add), applies the scale and writes bf16. One launch, no
//     workspace, no atomics: two runs give the same bits.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace molly::hopper;

constexpr int MAX_SPLITS = 8;  // a portable cluster
constexpr int MAX_M = 16;      // ops/quant.py:SMALL_M
constexpr int BN = 128;        // weight columns of a block
constexpr int BK = 64;         // contraction elements a stage
constexpr int RB = 16;         // rows of x a stage: two n8 chunks
constexpr int COL_WARPS = BN / 32;  // 32 columns a consumer warp
constexpr int K_PARTS = 2;          // stage residues a column group
constexpr int NCW = COL_WARPS * K_PARTS;  // consumer warps
constexpr int THREADS = (NCW + 1) * 32;   // + the producer warp
constexpr int W_BYTES = BK * BN;          // int8 box [64 k x 128 columns]
constexpr int X_BYTES = RB * 128;         // bf16 box [16 rows x 64 k]
constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
constexpr int STAGES = 6;  // 48 KB of weights in flight a block
constexpr int PART_LD = BN + 4;  // floats a partial row (padded)
constexpr int PART_BYTES = RB * PART_LD * 4;
constexpr int SMEM = STAGES * STAGE_BYTES + PART_BYTES + 1024;  // 69 KB

__global__ void __launch_bounds__(THREADS, 3)
    int8_gemv_stream_kernel(const __grid_constant__ CUtensorMap map_w,
                            const __grid_constant__ CUtensorMap map_x,
                            const float* __restrict__ scale,
                            __nv_bfloat16* __restrict__ out, int M, int K,
                            int N, int per) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* part = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);

  const int split = blockIdx.x, S = gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == NCW * 32) {  // the producer: its maps into the cache
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_w) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_x) : "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&s_full[s], 1);     // the producer's arrive, plus the bytes
      mbar_init(&s_empty[s], COL_WARPS);  // one lane of each warp of the
                                          // stage's residue
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int k_first = split * per;
  const int n_st = max(0, min(per, K / BK - k_first));

  // stage i of this split lies in ring slot i % STAGES, in its (i / STAGES)
  // -th round (the parity its full and empty barriers wait on)
  if (warp == NCW) {
    if (lane == 0) {
      for (int i = 0; i < n_st; ++i) {
        const int slot = i % STAGES;
        mbar_wait(&s_empty[slot], ((i / STAGES) & 1) ^ 1);
        uint64_t* bar = &s_full[slot];
        mbar_expect_tx(bar, STAGE_BYTES);
        unsigned char* st = ring + slot * STAGE_BYTES;
        const int k = (k_first + i) * BK;
        tma_load_2d(st, &map_w, bar, n0, k);
        tma_load_2d(st + W_BYTES, &map_x, bar, k, 0);
      }
    }
  } else {
    const int cw = warp % COL_WARPS, kp = warp / COL_WARPS;
    const int g = lane >> 2, t = lane & 3;
    float acc[2][RB / 8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < RB / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    const int nch = (M + 7) / 8;
    // this thread's four columns 32 cw + 4g .. + 3 (one 16-byte chunk of
    // the 128-byte row) at the even and odd rows of a k step
    const int chunk = 2 * cw + (g >> 2);
    const int off_e = ((chunk ^ (2 * t)) << 4) + 4 * (g & 3);
    const int off_o = ((chunk ^ (2 * t + 1)) << 4) + 4 * (g & 3);
    for (int i = kp; i < n_st; i += K_PARTS) {
      const int slot = i % STAGES;
      mbar_wait(&s_full[slot], (i / STAGES) & 1);
      const unsigned char* w = ring + slot * STAGE_BYTES;
      const unsigned char* x = w + W_BYTES;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t a[2][4];
        const unsigned char* row = w + (16 * ks + 2 * t) * 128;
        int8_frags(lds32(row + off_e), lds32(row + 128 + off_o),
                   lds32(row + 8 * 128 + off_e), lds32(row + 9 * 128 + off_o),
                   a[0], a[1]);
#pragma unroll
        for (int c = 0; c < RB / 8; ++c) {
          if (c < nch) {
            const unsigned char* xr = x + 4 * t;
            const uint32_t b0 = lds32(xr + swz(8 * c + g, 2 * ks));
            const uint32_t b1 = lds32(xr + swz(8 * c + g, 2 * ks + 1));
            molly::mma_bf16(acc[0][c], a[0], b0, b1);
            molly::mma_bf16(acc[1][c], a[1], b0, b1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&s_empty[slot]);
    }
    // the partial, [row][column]: out^T row g (+8) of m tile i is column
    // 32 cw + 4 g + 2 i (+1); residue 0 writes, the others add in order
#pragma unroll
    for (int half = 0; half < K_PARTS; ++half) {
      if (kp == half) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int col = 32 * cw + 4 * g + 2 * i + hi;
#pragma unroll
            for (int c = 0; c < RB / 8; ++c)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float* p = part + (8 * c + 2 * t + e) * PART_LD + col;
                *p = (half ? *p : 0.f) + acc[i][c][2 * hi + e];
              }
          }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(NCW * 32) : "memory");
    }
  }
  __syncwarp();
  cluster_sync();  // every split's partial is in its shared memory
  // this block's share of the tile: 4-column groups [q0, q1) of 32
  const int q0 = split * (BN / 4) / S, q1 = (split + 1) * (BN / 4) / S;
  const uint32_t part_u32 = smem_u32(part);
  for (int i = threadIdx.x; i < M * (q1 - q0); i += THREADS) {
    const int row = i / (q1 - q0), c = 4 * (q0 + i % (q1 - q0));
    const int n = n0 + c;
    if (n >= N) continue;  // N % 16 == 0: four columns lie in or out
    const uint32_t at = part_u32 + (row * PART_LD + c) * 4;
    float4 u[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < S) u[s] = ld_cluster_f4(at, s);
    float4 v = u[0];
#pragma unroll
    for (int s = 1; s < MAX_SPLITS; ++s)
      if (s < S) {
        v.x += u[s].x;
        v.y += u[s].y;
        v.z += u[s].z;
        v.w += u[s].w;
      }
    const float4 sc = *reinterpret_cast<const float4*>(scale + n);
    *reinterpret_cast<uint2*>(out + (long long)row * N + n) =
        make_uint2(molly::pack_bf16(v.x * sc.x, v.y * sc.y),
                   molly::pack_bf16(v.z * sc.z, v.w * sc.w));
  }
  cluster_sync();  // nobody reads a partial any more
}

}  // namespace

// x [M, K] bf16, w_q [K, N] int8, scale [N] fp32, out [M, N] bf16, all
// contiguous with 16-byte aligned bases; 1 <= M <= 16, K % 64 == 0, N % 16
// == 0. The plan (column tiles, splits, stages a split) comes from
// ops/quant.py:gemv_plan.
extern "C" int molly_int8_gemv_stream(const void* x, const int8_t* w,
                                      const float* scale, void* out, int M,
                                      int K, int N, int tiles, int splits,
                                      int per, void* stream) {
  if (M < 1 || M > MAX_M || K <= 0 || K % BK || N <= 0 || N % 16 ||
      !aligned16(x) || !aligned16(w) || !aligned16(scale) || !aligned16(out))
    return cudaErrorInvalidValue;
  // the plan must cover every column and stage
  if ((long long)tiles * BN < N || tiles > 65535 || splits < 1 ||
      splits > MAX_SPLITS || per < 1 || (long long)splits * per * BK < K)
    return cudaErrorInvalidValue;
  alignas(64) CUtensorMap map_w, map_x;
  if (!map_2d(&map_w, w, 1, K, N, BK, BN) ||
      !map_2d(&map_x, x, 2, M, K, RB, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemv_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_gemv_stream_kernel, map_w, map_x,
                           scale, static_cast<__nv_bfloat16*>(out), M, K, N,
                           per);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
