// Int8 weight-only GEMM for Hopper (sm_90a) at prefill and training shapes:
// out = (x @ w_q) * scale for bf16 x with more than 16 rows, on TMA and
// wgmma, the int8 weights converted to bf16 on the way, exactly.
//
// Replaces: molly_tpu/ops/quant.py:_kernel (launched from int8_matmul) for
// the calls that ops/quant.py:int8_takes_tma names: bf16 x, M > 16, K a
// multiple of 64, N of 16, 16-byte aligned bases. Decode (M <= 16) runs on
// int8_matmul_stream.cu, fp32 x and unaligned views on the SIMT GEMM of
// int8_matmul.cu. Same semantics: x [M, K] bf16 as given, w_q [K, N] int8 in the
// layout quantize_int8 gives (row-major, nothing reordered at quantize
// time), fp32 accumulation, the per-column fp32 scale applied once in the
// epilogue, out [M, N] bf16.
//
// What bounds it: operations. The --int8 prefill's qkv product (M 12,288,
// K 2048, N 4096) does 206 GFLOP over 158 MB, four times the card's
// operations-per-byte ridge; the QLoRA base products (M 4096) likewise. So
// the products must run at the wgmma rate and the conversion of the weights
// must hide behind them.
//
// The design. Persistent blocks, one an SM, walk 128 x 256 output tiles
// (128 rows of x, 256 weight columns) in row-major order: the blocks in
// flight share a band of x rows and every weight column, and the weights
// (12.6 MB at most here) stay in L2. A producer thread keeps STAGES stages
// of [128 x 64] bf16 x and [64 x 256] int8 w in flight by TMA (128-byte
// swizzle; a 128-column int8 row is one swizzle span), across tile
// boundaries. Two consumer warpgroups compute out^T = w^T x^T with wgmma
// m64n128k16 and fp32 accumulators (128 a thread), each 128 weight columns
// as two m64 tiles: the weight tile is the register A operand, converted
// from int8 in registers (hopper.cuh: int8_frags, exact), and x the B
// operand, K-major as it lies, so nothing is transposed or written back to
// shared memory. A thread's four A rows (rows g and g + 8 of the two tiles)
// are four ADJACENT weight columns: one 32-bit shared load gives all four
// at one k, free of bank conflicts under the swizzle, and in the epilogue a
// thread writes four adjacent outputs of a row (8 bytes) after one float4
// read of the scales. Each warpgroup converts the next stage while its
// products of this one run (two register sets). Converter warps that write
// the bf16 tile to shared memory for wgmma to read MN-major measured twice
// as slow at these shapes (PERF.md, PR 10).

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace molly::hopper;

constexpr int BM = 128;   // x rows of a tile
constexpr int BN = 256;   // weight columns of a tile
constexpr int BK = 64;    // contraction elements a stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;           // consumers: warpgroups 0, 1; producer: 2
constexpr int X_BYTES = BM * BK * 2;   // one box: 128 rows x 128 bytes
constexpr int W_BOX = BK * 128;        // 64 k rows x 128 int8 columns
constexpr int STAGE_BYTES = X_BYTES + 2 * W_BOX;         // 32 KB
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

__global__ void __launch_bounds__(THREADS, 1)
    int8_matmul_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           const float* __restrict__ scale,
                           __nv_bfloat16* __restrict__ out, int M, int N,
                           int K) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&s_full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&s_empty[s], 8);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_nt = (N + BN - 1) / BN;
  const int total = ((M + BM - 1) / BM) * n_nt;
  const int n_k = K / BK;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;

  if (wg == 2) {
    // launched at 168 registers a thread: the producer warpgroup gives back
    // exactly the 64 more each consumer thread takes (a smaller gift leaves
    // the consumers' setmaxnreg.inc waiting for ever)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      Ring r;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int m0 = (tile / n_nt) * BM, n0 = (tile % n_nt) * BN;
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(&s_empty[r.stage], r.phase ^ 1);
          uint64_t* bar = &s_full[r.stage];
          mbar_expect_tx(bar, STAGE_BYTES);
          unsigned char* st = ring + r.stage * STAGE_BYTES;
          tma_load_2d(st, &map_x, bar, kt * BK, m0);
          tma_load_2d(st + X_BYTES, &map_w, bar, n0, kt * BK);
          tma_load_2d(st + X_BYTES + W_BOX, &map_w, bar, n0 + 128, kt * BK);
          r.advance();
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ring_u32 = smem_u32(ring);
  Ring r;
  float acc0[64], acc1[64];
  // this thread's four columns, 4 (8 warp + g) .. + 3 of its warpgroup's
  // box: their 16-byte chunk and the swizzled byte offsets at the even
  // (2t, 2t + 8) and odd (2t + 1, 2t + 9) rows of a k step
  const int chunk = 2 * warp + (g >> 2);
  const int off_e = ((chunk ^ (2 * t)) << 4) + 4 * (g & 3);
  const int off_o = ((chunk ^ (2 * t + 1)) << 4) + 4 * (g & 3);
  // k step ks: a[2 ks] tile 0, a[2 ks + 1] tile 1
  auto convert = [&](uint32_t(&a)[8][4], int stage) {
    const unsigned char* wb =
        ring + stage * STAGE_BYTES + X_BYTES + wg * W_BOX;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const unsigned char* row = wb + (16 * ks + 2 * t) * 128;
      int8_frags(*reinterpret_cast<const uint32_t*>(row + off_e),
                 *reinterpret_cast<const uint32_t*>(row + 128 + off_o),
                 *reinterpret_cast<const uint32_t*>(row + 8 * 128 + off_e),
                 *reinterpret_cast<const uint32_t*>(row + 9 * 128 + off_o),
                 a[2 * ks], a[2 * ks + 1]);
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
    const int m0 = (tile / n_nt) * BM, n0 = (tile % n_nt) * BN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    mbar_wait(&s_full[r.stage], r.phase);
    convert(a0, r.stage);
    for (int kt = 0; kt < n_k; kt += 2) {
      step(a0, a1, kt + 1 < n_k);
      if (kt + 1 < n_k) step(a1, a0, kt + 2 < n_k);
    }
    // out^T row 16 warp + g of tile i is column c + 2i, row + 8 is c + 2i
    // + 1; accumulator 4j + e (+ 2) is x row 8j + 2t + e
    const int col = n0 + wg * 128 + 4 * (8 * warp + g);
    if (col < N) {  // N % 16 == 0: the four columns lie in or out together
      const float4 s = *reinterpret_cast<const float4*>(scale + col);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * j + 2 * t + e;
          if (row < M)
            *reinterpret_cast<uint2*>(out + (long long)row * N + col) =
                make_uint2(
                    molly::pack_bf16(acc0[4 * j + e] * s.x,
                                     acc0[4 * j + 2 + e] * s.y),
                    molly::pack_bf16(acc1[4 * j + e] * s.z,
                                     acc1[4 * j + 2 + e] * s.w));
        }
    }
    __syncwarp();
  }
}

}  // namespace

// x [M, K] bf16, w [K, N] int8, out [M, N] bf16, all row-major contiguous;
// scale [N] fp32; K a multiple of 64, N of 16; every base 16-byte aligned.
extern "C" int molly_int8_matmul_tma(const void* x, const int8_t* w,
                                     const float* scale, void* out, int M,
                                     int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || N % 16 || !aligned16(x) ||
      !aligned16(w) || !aligned16(scale) || !aligned16(out))
    return cudaErrorInvalidValue;
  alignas(64) CUtensorMap map_x, map_w;
  if (!map_2d(&map_x, x, 2, M, K, BM, BK) ||
      !map_2d(&map_w, w, 1, K, N, BK, 128))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int sms = current_sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  int8_matmul_tma_kernel<<<grid, THREADS, SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, scale, static_cast<__nv_bfloat16*>(out), M, N, K);
  return cudaGetLastError();
}
