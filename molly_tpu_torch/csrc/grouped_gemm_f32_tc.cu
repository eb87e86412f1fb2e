// Grouped GEMMs over fp32 experts (the expert-LoRA adapters) for Hopper
// (sm_90a) at prefill and training shapes, on TMA and wgmma, held at fp32
// accuracy by splitting operands.
//
// Replaces: megablox `gmm` (launched from molly_tpu/ops/moe.py:_grouped_dot,
// which _lora_grouped calls with an fp32 adapter stack), `gmm` with
// transpose_rhs in its VJP, and `tgmm` (megablox/gmm.py, reached through
// gmm's VJP: the adapters' weight gradients), for the calls that
// ops/grouped_gemm.py:f32_takes_tc and tgmm_takes_tc name (at least 64 rows
// a group, aligned shapes). grouped_gemm.cu keeps fp32 products at few rows
// a group, the forward over an fp32 lhs, and an all-fp32 tgmm.
//   forward  out[r, :] = lhs[r, :] @ w[g(r)]      lhs [M, K] bf16 (widened
//            exactly), w [G, K, N] fp32, out [M, N] fp32
//   TRANS    out[r, :] = lhs[r, :] @ w[g(r)]^T    lhs [M, K] fp32,
//            w [G, N, K] fp32, out [M, N] fp32 or bf16 (rounded once)
//   tgmm     out[g] = lhs[rows_g]^T @ dout[rows_g]  lhs [M, K] bf16 (the
//            adapters' activations, exact), dout [M, N] fp32, out [G, K, N]
//            fp32
// Forward and TRANS: rows past the last group are written as zeros; an
// empty group owns no tile and reads no weights. Tiles are aligned to
// groups as in grouped_gemm_int8_tma.cu (grouped_tiles.cuh), persistent
// blocks walk them group-major, a producer thread keeps 4 stages in flight
// by TMA across tile boundaries, two consumer warpgroups multiply.
//
// What bounds them: bytes. With the adapters' rank (64) on one side every
// MoE QLoRA shape is below the card's operations-per-byte ridge once the
// products leave the SIMT cores: LoRA A at K 2048 moves 210 MB over 8.6
// GFLOP, LoRA B at N 768 134 MB over 3.2. So the design streams each lhs
// row tile once, keeps a whole 64-wide rank tile in one block, writes whole
// lines, and spends tensor-core operations on accuracy.
//
// Accuracy. A bf16 or TF32 product keeps about three decimal digits; the
// plain version is fp32. So every fp32 operand is split:
//   forward: the lhs is bf16, exact as a bf16 operand. The weights are
//     split into three bf16 parts, w = w0 + w1 + w2 + O(2^-24 w) (each the
//     rounded remainder of the one before), and the product is three bf16
//     wgmmas, x w0 + x w1 + x w2: fp32 accuracy at the bf16 rate.
//   TRANS: both operands are fp32 (the lhs is a gradient): x = hi + lo with
//     hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi is exact in
//     fp32), the same for w, and three TF32 wgmmas, hi hi + hi lo + lo hi
//     (the lo lo term is below 2^-22 of the product).
//   tgmm: the lhs is bf16 and exact; dout is split into three bf16 parts as
//     the forward's weights are, and the product is three bf16 wgmmas.
// An lhs that came from bf16 has lo = 0; the forward takes such an lhs as
// bf16 and needs no lhs split; the lhs gradients arrive in fp32 and take
// all three TF32 products.
//
// Layouts. wgmma reads TF32 from shared memory only K-major, and reads its
// A operand from registers in any order a thread loads it.
//   forward: the weights [k][n] are N-major, so out^T = w^T lhs^T: the
//     weight tile is the register A operand (64 or 128 output columns on
//     wgmma's m), loaded and split by each thread; the lhs rows are the
//     bf16 B operand, K-major as TMA brings them (each warpgroup 64 of a
//     tile's 128 rows). A thread's A rows (g and g + 8 of each m64 tile)
//     are adjacent output columns, so one 16-byte (8-byte for one m tile)
//     load of a weight row gives its values at one k, conflict-free under
//     the 128-byte swizzle, and the epilogue writes 16 (8) bytes of a row.
//   TRANS: both operands are K-major as they lie, so out = lhs w^T: the lhs
//     rows are the register A operand (each warpgroup one m64 tile of a
//     tile's 128 rows), split by each thread; the weight tile (64 or 128
//     output columns on wgmma's n) is the B operand from shared memory: the
//     consumers split each stage's tile in place (hi) and into a second
//     buffer (lo) before its products, while the previous stage's products
//     run.
//   tgmm: the contraction runs over a group's rows, the outermost axis of
//     both operands, so both are MN-major, and TF32 cannot read that from
//     shared memory: hence bf16 parts. out^T = dout^T lhs: the fp32 dout
//     tile is the register A operand (64 dout columns a warpgroup on
//     wgmma's m), loaded and split by each thread exactly as the forward's
//     weight tile; the lhs rows are the bf16 B operand, MN-major as TMA
//     brings them. A tile is one group's rows against 256 lhs columns and
//     all 64 columns of a rank-64 dout (the A gradients), or 64 lhs
//     columns of a rank-64 lhs against 128 dout columns (the B
//     gradients), so every lhs row tile is streamed once. The last stage of
//     a group reaches into the next group's rows: each thread zeroes those
//     rows of its dout fragments, and each warpgroup those rows of its lhs
//     boxes, so they add exactly nothing. An empty group's tiles write the
//     zeros the accumulators start with. Random routers are uneven (a group
//     may hold several times the mean), so every block orders the groups by
//     size, largest first, and the persistent grid takes the tiles in that
//     order, every other round backwards: each block's rounds pair a long
//     tile with a short one.
// One block a tile, k (tgmm: rows) in order, no atomics: two runs give the
// same bits. The tensor maps are encoded at each launch, the group sizes
// are read on the device only, and nothing is allocated, so a captured
// graph replays with new group sizes.

#include "common.cuh"
#include "grouped_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace molly::hopper;

constexpr int MAX_GROUPS = 1024;
constexpr int BM = 128;        // lhs rows of a tile
constexpr int STAGES = 4;
constexpr int THREADS = 384;   // consumers: warpgroups 0, 1; producer: 2
constexpr int BOX = 64 * 128;  // a TMA box of 64 rows x 128 bytes

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

__device__ __forceinline__ void init_barriers(uint64_t* full,
                                              uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&empty[s], 8);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// the 256 consumer threads
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> three bf16 pairs whose sum is (x, y) within 2^-24 of each:
// each part is the remainder of the ones before, rounded (the remainders
// are exact in fp32)
__device__ __forceinline__ void split3(float x, float y, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  p0 = bf16x2_bits(h);
  p1 = bf16x2_bits(m);
  p2 = bf16x2_bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d[64 x 64] += a[64 x 8] * b[8 x 64], TF32, a from registers: thread (q,
// g, t) holds a[0] = A[16q + g][t], a[1] = A[16q + g + 8][t], a[2] =
// A[16q + g][t + 4], a[3] = A[16q + g + 8][t + 4]; b K-major in shared
// memory; d as in hopper.cuh with j = 0 .. 7
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : MOLLY_R16(d, 0), MOLLY_R16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// the same with n = 128, j = 0 .. 15
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : MOLLY_R16(d, 0), MOLLY_R16(d, 16), MOLLY_R16(d, 32), MOLLY_R16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// Forward: bf16 lhs x fp32 weights, three bf16 products
// ---------------------------------------------------------------------------

// MT m64 tiles of output columns a tile (1: N <= 64, the LoRA A product's
// rank; 2: 128 columns a tile)
template <int MT>
struct Fwd {
  static constexpr int BK = 64;                   // k a stage
  static constexpr int COLS = 64 * MT;            // output columns a tile
  static constexpr int X_BYTES = BM * BK * 2;     // 128 rows x 128 bytes
  static constexpr int W_BOXES = COLS / 32;       // 64 k x 32 fp32 each
  static constexpr int STAGE_BYTES = X_BYTES + W_BOXES * BOX;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
};

template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
    tc_fwd_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  float* __restrict__ out,
                  const int* __restrict__ group_sizes, int G, int M, int K,
                  int N) {
  using P = Fwd<MT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_row[MAX_GROUPS + 2], s_tile[MAX_GROUPS + 2];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  molly::scan_group_tiles<BM, THREADS>(group_sizes, G, M, s_row, s_tile);
  init_barriers(s_full, s_empty);
  __syncthreads();

  const int n_ct = (N + P::COLS - 1) / P::COLS;
  const int total = s_tile[G + 1] * n_ct;
  const int n_k = K / P::BK;
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      Ring r;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        int b, e;
        const int grp =
            molly::locate_tile<BM>(s_row, s_tile, G, tile / n_ct, &b, &e);
        if (grp == G) continue;
        const int c0 = (tile % n_ct) * P::COLS;
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(&s_empty[r.stage], r.phase ^ 1);
          uint64_t* bar = &s_full[r.stage];
          mbar_expect_tx(bar, P::STAGE_BYTES);
          unsigned char* st = ring + r.stage * P::STAGE_BYTES;
          tma_load_2d(st, &map_x, bar, kt * P::BK, b);  // 128 rows x 64 k
          for (int q = 0; q < P::W_BOXES; ++q)  // [G * K, N]: 64 k x 32 n
            tma_load_2d(st + P::X_BYTES + q * BOX, &map_w, bar, c0 + 32 * q,
                        grp * K + kt * P::BK);
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
  // this thread's output columns: MT = 2: 4 (8 warp + g) .. + 3, chunk g of
  // box `warp`; MT = 1: 2 (8 warp + g), + 1, half g & 1 of chunk 4 (warp &
  // 1) + g / 2 of box warp / 2
  const int box = MT == 2 ? warp : warp >> 1;
  const int chunk = MT == 2 ? g : 4 * (warp & 1) + (g >> 1);
  const int half = MT == 2 ? 0 : 8 * (g & 1);
  // the weight tile's k row k, this thread's values (swizzled)
  auto w_at = [&](int stage, int k) {
    return ring + stage * P::STAGE_BYTES + P::X_BYTES + box * BOX + k * 128 +
           ((chunk ^ (k & 7)) << 4) + half;
  };
  using Frag = uint32_t[3 * MT][4];  // [3 i + part]: tile i's A fragments
  // the A fragments of k16 step ks: rows 16 ks + 2t, + 1, + 8, + 9
  auto convert = [&](Frag& a, int stage, int ks) {
    const int k = 16 * ks + 2 * t;
    if constexpr (MT == 2) {
      const float4 v0 = *reinterpret_cast<const float4*>(w_at(stage, k));
      const float4 v1 = *reinterpret_cast<const float4*>(w_at(stage, k + 1));
      const float4 v8 = *reinterpret_cast<const float4*>(w_at(stage, k + 8));
      const float4 v9 = *reinterpret_cast<const float4*>(w_at(stage, k + 9));
      split3(v0.x, v1.x, a[0][0], a[1][0], a[2][0]);
      split3(v0.y, v1.y, a[0][1], a[1][1], a[2][1]);
      split3(v8.x, v9.x, a[0][2], a[1][2], a[2][2]);
      split3(v8.y, v9.y, a[0][3], a[1][3], a[2][3]);
      split3(v0.z, v1.z, a[3][0], a[4][0], a[5][0]);
      split3(v0.w, v1.w, a[3][1], a[4][1], a[5][1]);
      split3(v8.z, v9.z, a[3][2], a[4][2], a[5][2]);
      split3(v8.w, v9.w, a[3][3], a[4][3], a[5][3]);
    } else {
      const float2 v0 = *reinterpret_cast<const float2*>(w_at(stage, k));
      const float2 v1 = *reinterpret_cast<const float2*>(w_at(stage, k + 1));
      const float2 v8 = *reinterpret_cast<const float2*>(w_at(stage, k + 8));
      const float2 v9 = *reinterpret_cast<const float2*>(w_at(stage, k + 9));
      split3(v0.x, v1.x, a[0][0], a[1][0], a[2][0]);
      split3(v0.y, v1.y, a[0][1], a[1][1], a[2][1]);
      split3(v8.x, v9.x, a[0][2], a[1][2], a[2][2]);
      split3(v8.y, v9.y, a[0][3], a[1][3], a[2][3]);
    }
  };
  float acc[MT][32];
  auto products = [&](Frag& a, int stage, int ks) {
    // this warpgroup's 64 lhs rows, K-major, 128-byte swizzle
    const uint64_t desc = smem_desc(
        ring_u32 + stage * P::STAGE_BYTES + wg * 64 * 128 + ks * 32,
        P::X_BYTES);
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_acc(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int p = 0; p < 3; ++p)
        wgmma_m64n64k16_rs<0>(acc[i], a[3 * i + p], desc);
    wgmma_commit();
  };
  Ring r;
  int n_steps = 0;
  // k16 step s of the tile with `cur`; meanwhile step s + 1 (if any) is
  // converted into `nxt`; the stage is released after its last step
  auto step = [&](Frag& cur, Frag& nxt, int s) {
    products(cur, r.stage, s & 3);
    Ring n = r;
    if ((s & 3) == 3) n.advance();
    if (s + 1 < n_steps) {
      if ((s & 3) == 3) mbar_wait(&s_full[n.stage], n.phase);
      convert(nxt, n.stage, (s + 1) & 3);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_acc(acc[i]);
    fence_regs(cur);
    if ((s & 3) == 3 && lane == 0) mbar_arrive(&s_empty[r.stage]);
    r = n;
  };
  Frag f0, f1;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int b, end;
    const int grp =
        molly::locate_tile<BM>(s_row, s_tile, G, tile / n_ct, &b, &end);
    const int c0 = (tile % n_ct) * P::COLS;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;
    if (grp < G) {
      n_steps = 4 * n_k;
      mbar_wait(&s_full[r.stage], r.phase);
      convert(f0, r.stage, 0);
      for (int s = 0; s < n_steps; s += 2) {
        step(f0, f1, s);
        step(f1, f0, s + 1);
      }
    }
    // out^T row 16 warp + g of tile i is column col + MT i, row + 8 is col
    // + MT i + 1; accumulator 4j + e (+ 2) is lhs row 64 wg + 8j + 2t + e
    const int col = c0 + MT * 2 * (8 * warp + g);
    if (col < N) {  // N % 8 == 0: a thread's columns lie in or out together
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = b + 64 * wg + 8 * j + 2 * t + e;
          if (row >= end) continue;
          float* o = out + (long long)row * N + col;
          if constexpr (MT == 2)
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                            acc[1][4 * j + e], acc[1][4 * j + 2 + e]);
          else
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[0][4 * j + e], acc[0][4 * j + 2 + e]);
        }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Transposed: fp32 lhs x fp32 weights^T, three TF32 products
// ---------------------------------------------------------------------------

// NT output columns a tile (64: N <= 64, the rank; else 128)
template <int NT>
struct Trans {
  static constexpr int BK = 32;                   // k a stage: 128 bytes
  static constexpr int X_BYTES = BM * 128;        // 128 rows x 32 fp32
  static constexpr int W_BYTES = NT * 128;        // NT rows x 32 fp32
  static constexpr int STAGE_BYTES = X_BYTES + 2 * W_BYTES;  // + the lo tile
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
};

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    tc_trans_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    void* __restrict__ out, int out_f32,
                    const int* __restrict__ group_sizes, int G, int M, int K,
                    int N) {
  using P = Trans<NT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_row[MAX_GROUPS + 2], s_tile[MAX_GROUPS + 2];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  molly::scan_group_tiles<BM, THREADS>(group_sizes, G, M, s_row, s_tile);
  init_barriers(s_full, s_empty);
  __syncthreads();

  const int n_ct = (N + NT - 1) / NT;
  const int total = s_tile[G + 1] * n_ct;
  const int n_k = K / P::BK;
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      Ring r;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        int b, e;
        const int grp =
            molly::locate_tile<BM>(s_row, s_tile, G, tile / n_ct, &b, &e);
        if (grp == G) continue;
        const int c0 = (tile % n_ct) * NT;
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(&s_empty[r.stage], r.phase ^ 1);
          uint64_t* bar = &s_full[r.stage];
          mbar_expect_tx(bar, P::X_BYTES + P::W_BYTES);
          unsigned char* st = ring + r.stage * P::STAGE_BYTES;
          tma_load_2d(st, &map_x, bar, kt * P::BK, b);  // 128 rows x 32 k
          // [G * N, K]: NT rows x 32 k
          tma_load_2d(st + P::X_BYTES, &map_w, bar, kt * P::BK, grp * N + c0);
          r.advance();
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ctid = threadIdx.x;  // 0 .. 255
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ring_u32 = smem_u32(ring);
  // this thread's A rows: 64 wg + 16 warp + g and + 8 (row % 8 == g)
  const int arow = 64 * wg + 16 * warp + g;
  using Frag = uint32_t[8][4];  // [2 ks + {hi, lo}]
  // the stage's weight tile: hi in place, lo into the second buffer; the
  // 256 consumers split it between them
  auto split_w = [&](int stage) {
    uint4* w = reinterpret_cast<uint4*>(ring + stage * P::STAGE_BYTES +
                                        P::X_BYTES);
    uint4* lo = w + P::W_BYTES / 16;
#pragma unroll
    for (int c = ctid; c < P::W_BYTES / 16; c += 256) {
      const float4 v = *reinterpret_cast<const float4*>(&w[c]);
      const uint4 h = make_uint4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                                 tf32_rna(v.w));
      lo[c] = make_uint4(tf32_rna(v.x - __uint_as_float(h.x)),
                         tf32_rna(v.y - __uint_as_float(h.y)),
                         tf32_rna(v.z - __uint_as_float(h.z)),
                         tf32_rna(v.w - __uint_as_float(h.w)));
      w[c] = h;
    }
    fence_async_shared();
  };
  // the A fragments (hi, lo) of the stage's four k8 steps
  auto load_a = [&](Frag& a, int stage) {
    const unsigned char* x = ring + stage * P::STAGE_BYTES + arow * 128;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows + 8 (i & 1), k 8 ks + t + 4 (i / 2)
        const int ch = (2 * ks + (i >> 1)) ^ g;
        v[i] = *reinterpret_cast<const float*>(x + (i & 1) * 8 * 128 +
                                               (ch << 4) + 4 * t);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[2 * ks][i] = tf32_rna(v[i]);
        a[2 * ks + 1][i] = tf32_rna(v[i] - __uint_as_float(a[2 * ks][i]));
      }
    }
  };
  float acc[NT / 2];
  auto products = [&](Frag& a, int stage) {
    const uint32_t w = ring_u32 + stage * P::STAGE_BYTES + P::X_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t hi = smem_desc(w + ks * 32, P::W_BYTES);
      const uint64_t lo = smem_desc(w + P::W_BYTES + ks * 32, P::W_BYTES);
      if constexpr (NT == 64) {
        wgmma_m64n64k8_tf32(acc, a[2 * ks], hi);
        wgmma_m64n64k8_tf32(acc, a[2 * ks], lo);
        wgmma_m64n64k8_tf32(acc, a[2 * ks + 1], hi);
      } else {
        wgmma_m64n128k8_tf32(acc, a[2 * ks], hi);
        wgmma_m64n128k8_tf32(acc, a[2 * ks], lo);
        wgmma_m64n128k8_tf32(acc, a[2 * ks + 1], hi);
      }
    }
    wgmma_commit();
  };
  Ring r;
  int n_stages = 0;
  // products of stage r with `cur`; meanwhile stage r + 1 (if any) is split
  // and its A fragments loaded into `nxt`; then stage r is released
  auto step = [&](Frag& cur, Frag& nxt, int i) {
    products(cur, r.stage);
    Ring n = r;
    n.advance();
    const bool more = i + 1 < n_stages;
    if (more) {
      mbar_wait(&s_full[n.stage], n.phase);
      split_w(n.stage);
      load_a(nxt, n.stage);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(cur);
    if (lane == 0) mbar_arrive(&s_empty[r.stage]);
    if (more) consumers_sync();  // both halves of stage r + 1 are split
    r = n;
  };
  Frag f0, f1;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int b, end;
    const int grp =
        molly::locate_tile<BM>(s_row, s_tile, G, tile / n_ct, &b, &end);
    const int c0 = (tile % n_ct) * NT;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    if (grp < G) {
      n_stages = n_k;
      mbar_wait(&s_full[r.stage], r.phase);
      split_w(r.stage);
      load_a(f0, r.stage);
      consumers_sync();
      for (int i = 0; i < n_k; i += 2) {
        step(f0, f1, i);
        if (i + 1 < n_k) step(f1, f0, i + 1);
      }
    }
    // accumulator 4j + e is row arow, column 8j + 2t + e; 4j + 2 + e is row
    // arow + 8
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col >= N) continue;  // N % 8 == 0: a pair lies in or out together
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = b + arow + 8 * h;
        if (row >= end) continue;
        const long long at = (long long)row * N + col;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) +
                                       at) = molly::pack_bf16(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Weight gradient: bf16 lhs, fp32 dout, three bf16 products
// ---------------------------------------------------------------------------

// A tile of out[g] is CK lhs columns (out's rows k) by CN dout columns
// (out's columns n), computed as out^T = dout^T lhs: dout^T is the register
// A operand (n on wgmma's m, one m64 tile a warpgroup), the lhs rows the
// bf16 B operand (k on wgmma's n, NB a warpgroup), both over the group's
// rows. WM = 1: the two warpgroups take NB lhs columns each of the same 64
// dout columns (CN 64, CK 2 NB: the LoRA A gradients, N = 64; NB = 128,
// as 128-column tiles measured 10-25% slower); WM = 2: 64 dout columns
// each of the same NB lhs columns (CN 128, CK NB: the LoRA B gradients,
// K = 64).
template <int NB, int WM>
struct Tg {
  static constexpr int CN = 64 * WM;
  static constexpr int CK = NB * (3 - WM);
  static constexpr int D_BOXES = CN / 32;  // 64 rows x 32 fp32 each
  static constexpr int X_BOXES = CK / 64;  // 64 rows x 64 bf16 each
  static constexpr int D_BYTES = D_BOXES * BOX;
  static constexpr int STAGE_BYTES = (D_BOXES + X_BOXES) * BOX;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
};

// s_order lists the G groups by size, largest first (ties by index), from
// the row starts of scan_group_tiles, so that the grid starts on the
// longest tiles. Ends with __syncthreads().
__device__ __forceinline__ void order_by_size(const int* s_row, int G,
                                              int* s_order) {
  for (int g = threadIdx.x; g < G; g += THREADS) {
    const int sz = s_row[g + 1] - s_row[g];
    int rank = 0;
    for (int h = 0; h < G; ++h) {
      const int o = s_row[h + 1] - s_row[h];
      rank += o > sz || (o == sz && h < g);
    }
    s_order[rank] = g;
  }
  __syncthreads();
}

template <int NB, int WM>
__global__ void __launch_bounds__(THREADS, 1)
    tc_tgmm_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_d,
                   float* __restrict__ out,
                   const int* __restrict__ group_sizes, int G, int M, int K,
                   int N) {
  using P = Tg<NB, WM>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_row[MAX_GROUPS + 2], s_tile[MAX_GROUPS + 2];
  __shared__ int s_order[MAX_GROUPS];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // group g owns rows [s_row[g], s_row[g + 1]) (s_tile is not used)
  molly::scan_group_tiles<64, THREADS>(group_sizes, G, M, s_row, s_tile);
  order_by_size(s_row, G, s_order);
  init_barriers(s_full, s_empty);
  __syncthreads();

  const int n_cb = (N + P::CN - 1) / P::CN, n_kb = (K + P::CK - 1) / P::CK;
  const int per_group = n_cb * n_kb;
  const int total = G * per_group;
  // the block's i-th tile: rounds of gridDim.x tiles in the groups' size
  // order, every other round walked backwards, so that a block that took
  // one of the largest tiles in a round takes one of the smallest in the
  // next
  auto tile_of = [&](int i) {
    const int pos = (i & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return i * (int)gridDim.x + pos;
  };
  // tile -> group, first dout column, first lhs column
  auto locate = [&](int tile, int* c0, int* k0) {
    const int rem = tile % per_group;
    *c0 = (rem / n_kb) * P::CN;
    *k0 = (rem % n_kb) * P::CK;
    return s_order[tile / per_group];
  };

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      Ring r;
      for (int i = 0;; ++i) {
        const int tile = tile_of(i);
        if (tile >= total) break;
        int c0, k0;
        const int grp = locate(tile, &c0, &k0);
        // boxes wholly past N or K are not loaded: they feed only outputs
        // that are not stored
        const int nd = min(P::D_BOXES, (N - c0 + 31) / 32);
        const int nx = min(P::X_BOXES, (K - k0 + 63) / 64);
        for (int row = s_row[grp]; row < s_row[grp + 1]; row += 64) {
          mbar_wait(&s_empty[r.stage], r.phase ^ 1);
          uint64_t* bar = &s_full[r.stage];
          mbar_expect_tx(bar, (nd + nx) * BOX);
          unsigned char* st = ring + r.stage * P::STAGE_BYTES;
          for (int q = 0; q < nd; ++q)  // 64 rows x 32 dout columns
            tma_load_2d(st + q * BOX, &map_d, bar, c0 + 32 * q, row);
          for (int q = 0; q < nx; ++q)  // 64 rows x 64 lhs columns
            tma_load_2d(st + P::D_BYTES + q * BOX, &map_x, bar, k0 + 64 * q,
                        row);
          r.advance();
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ring_u32 = smem_u32(ring);
  // this warpgroup's dout columns [cw, cw + 64) and lhs columns
  // [kw, kw + NB) of the tile
  const int cw = WM == 2 ? 64 * wg : 0;
  const int kw = WM == 2 ? 0 : NB * wg;
  // this thread's dout columns cw + 2 (8 warp + g), + 1 (its A rows 16 warp
  // + g and + 8): half g & 1 of chunk 4 (warp & 1) + g / 2 of box
  // cw / 32 + warp / 2
  const int box = cw / 32 + (warp >> 1);
  const int chunk = 4 * (warp & 1) + (g >> 1);
  const int half = 8 * (g & 1);
  auto d_at = [&](int stage, int row) {
    return ring + stage * P::STAGE_BYTES + box * BOX + row * 128 +
           ((chunk ^ (row & 7)) << 4) + half;
  };
  using Frag = uint32_t[3][4];  // [part]: the A fragments of one k16 step
  // the A fragments of k16 step ks: dout rows 16 ks + 2t, + 1, + 8, + 9 at
  // this thread's two columns, rows at or past `valid` taken as zero
  auto convert = [&](Frag& a, int stage, int ks, int valid) {
    const int k = 16 * ks + 2 * t;
    float2 v0 = *reinterpret_cast<const float2*>(d_at(stage, k));
    float2 v1 = *reinterpret_cast<const float2*>(d_at(stage, k + 1));
    float2 v8 = *reinterpret_cast<const float2*>(d_at(stage, k + 8));
    float2 v9 = *reinterpret_cast<const float2*>(d_at(stage, k + 9));
    if (valid < 64) {  // rows of the next group, or that no group owns
      const float2 z = make_float2(0.f, 0.f);
      if (k >= valid) v0 = z;
      if (k + 1 >= valid) v1 = z;
      if (k + 8 >= valid) v8 = z;
      if (k + 9 >= valid) v9 = z;
    }
    split3(v0.x, v1.x, a[0][0], a[1][0], a[2][0]);
    split3(v0.y, v1.y, a[0][1], a[1][1], a[2][1]);
    split3(v8.x, v9.x, a[0][2], a[1][2], a[2][2]);
    split3(v8.y, v9.y, a[0][3], a[1][3], a[2][3]);
  };
  // the lhs rows at or past `valid` of this warpgroup's boxes of the stage
  // are zeroed too (an Inf or NaN there would survive a zero dout); with
  // WM = 2 both warpgroups write the same zeros into the one box
  auto clear_lhs = [&](int stage, int valid) {
    uint4* x = reinterpret_cast<uint4*>(ring + stage * P::STAGE_BYTES +
                                        P::D_BYTES + (kw / 64) * BOX);
#pragma unroll
    for (int q = 0; q < NB / 64; ++q)
      for (int c = valid * 8 + tid; c < 64 * 8; c += 128)
        x[q * (BOX / 16) + c] = make_uint4(0u, 0u, 0u, 0u);
    fence_async_shared();
    warpgroup_sync(wg);
  };
  float acc[NB / 2];
  auto products = [&](Frag& a, int stage, int ks) {
    // this warpgroup's lhs columns, MN-major: 16 rows further is +2048
    // bytes, the next 64 columns the next box
    const uint64_t desc = smem_desc(ring_u32 + stage * P::STAGE_BYTES +
                                        P::D_BYTES + (kw / 64) * BOX +
                                        ks * 2048,
                                    BOX);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if constexpr (NB == 128)
        wgmma_m64n128k16_rs<1>(acc, a[p], desc);
      else
        wgmma_m64n64k16_rs<1>(acc, a[p], desc);
    }
    wgmma_commit();
  };
  Ring r;
  int n_steps = 0, b = 0, end = 0;
  // rows of the group in the stage of k16 step s
  auto valid_of = [&](int s) { return end - b - 64 * (s >> 2); };
  // k16 step s of the tile with `cur`; meanwhile step s + 1 (if any) is
  // converted into `nxt` (its stage waited for, and cleared if ragged); the
  // stage is released after its last step
  auto step = [&](Frag& cur, Frag& nxt, int s) {
    products(cur, r.stage, s & 3);
    Ring n = r;
    if ((s & 3) == 3) n.advance();
    if (s + 1 < n_steps) {
      if ((s & 3) == 3) {
        mbar_wait(&s_full[n.stage], n.phase);
        if (valid_of(s + 1) < 64) clear_lhs(n.stage, valid_of(s + 1));
      }
      convert(nxt, n.stage, (s + 1) & 3, valid_of(s + 1));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(cur);
    if ((s & 3) == 3 && lane == 0) mbar_arrive(&s_empty[r.stage]);
    r = n;
  };
  Frag f0, f1;
  for (int i = 0;; ++i) {
    const int tile = tile_of(i);
    if (tile >= total) break;
    int c0, k0;
    const int grp = locate(tile, &c0, &k0);
    b = s_row[grp];
    end = s_row[grp + 1];
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) acc[j] = 0.f;
    n_steps = 4 * ((end - b + 63) / 64);
    if (n_steps) {
      mbar_wait(&s_full[r.stage], r.phase);
      if (valid_of(0) < 64) clear_lhs(r.stage, valid_of(0));
      convert(f0, r.stage, 0, valid_of(0));
      for (int s = 0; s < n_steps; s += 2) {
        step(f0, f1, s);
        step(f1, f0, s + 1);
      }
    }
    // out^T row 16 warp + g is dout column c, row + 8 is c + 1;
    // accumulator 4j + e (+ 2) is lhs column k + e: out[k + e][c (+ 1)]
    const int c = c0 + cw + 2 * (8 * warp + g);
    if (c < N) {  // N % 8 == 0: a thread's two columns lie in or out together
      float* o = out + (long long)grp * K * N + c;
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + kw + 8 * j + 2 * t + e;
          if (k < K)
            *reinterpret_cast<float2*>(o + (long long)k * N) =
                make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// A row-major [rows, cols] matrix of bf16 (2) or fp32 (4) elements as boxes
// of box_rows x box_cols (128 bytes a box row), 128-byte swizzle, zeros out
// of bounds
bool make_map(CUtensorMap* map, const void* ptr, int elem_bytes,
              long long rows, long long cols, int box_rows, int box_cols) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map,
                elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// lhs [M, K], w [G, K, N] (or [G, N, K] with transpose_rhs) fp32, out
// [M, N]; the forward takes a bf16 lhs into fp32 out, K a multiple of 64;
// the transposed product an fp32 lhs into fp32 or bf16 out, K a multiple of
// 32; N a multiple of 8; all contiguous and 16-byte aligned.
extern "C" int molly_grouped_gemm_f32_tc(const void* lhs, const float* w,
                                         void* out, const int* group_sizes,
                                         int M, int K, int N, int G,
                                         int out_dtype, int transpose_rhs,
                                         void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > MAX_GROUPS || N % 8 ||
      K % (transpose_rhs ? 32 : 64) || !aligned16(lhs) || !aligned16(w) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  if (out_dtype != molly::kFloat32 &&
      (out_dtype != molly::kBFloat16 || !transpose_rhs))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int out_f32 = out_dtype == molly::kFloat32;
  const bool narrow = N <= 64;
  const int cols = narrow ? 64 : 128;
  alignas(64) CUtensorMap map_x, map_w;
  cudaError_t err;
  if (!transpose_rhs) {
    if (!make_map(&map_x, lhs, 2, M, K, BM, 64) ||
        !make_map(&map_w, w, 4, (long long)G * K, N, 64, 32))
      return cudaErrorInvalidValue;
    auto kernel = narrow ? tc_fwd_kernel<1> : tc_fwd_kernel<2>;
    const int smem = narrow ? Fwd<1>::SMEM_BYTES : Fwd<2>::SMEM_BYTES;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const long long tiles =
        ((long long)(M + BM - 1) / BM + G) * ((N + cols - 1) / cols);
    const int sms = current_sm_count();
    if (sms <= 0) return cudaErrorInvalidValue;
    kernel<<<(int)(tiles < sms ? tiles : sms), THREADS, smem, s>>>(
        map_x, map_w, static_cast<float*>(out), group_sizes, G, M, K, N);
    return cudaGetLastError();
  }
  if (!make_map(&map_x, lhs, 4, M, K, BM, 32) ||
      !make_map(&map_w, w, 4, (long long)G * N, K, cols, 32))
    return cudaErrorInvalidValue;
  auto kernel = narrow ? tc_trans_kernel<64> : tc_trans_kernel<128>;
  const int smem = narrow ? Trans<64>::SMEM_BYTES : Trans<128>::SMEM_BYTES;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      ((long long)(M + BM - 1) / BM + G) * ((N + cols - 1) / cols);
  const int sms = current_sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  kernel<<<(int)(tiles < sms ? tiles : sms), THREADS, smem, s>>>(
      map_x, map_w, out, out_f32, group_sizes, G, M, K, N);
  return cudaGetLastError();
}

// The weight gradient out[g] = lhs[rows_g]^T dout[rows_g]: lhs [M, K] bf16,
// dout [M, N] fp32, out [G, K, N] fp32, K and N multiples of 8, all
// contiguous and 16-byte aligned. `plan` (ops/grouped_gemm.py:tgmm_tc_plan)
// picks the tile: 0: 256 lhs x 64 dout columns, 1: 64 x 128.
extern "C" int molly_grouped_gemm_tgmm_f32_tc(const void* lhs,
                                              const float* dout, float* out,
                                              const int* group_sizes, int M,
                                              int K, int N, int G, int plan,
                                              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > MAX_GROUPS || K % 8 ||
      N % 8 || plan < 0 || plan > 1 || !aligned16(lhs) || !aligned16(dout) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  alignas(64) CUtensorMap map_x, map_d;
  if (!make_map(&map_x, lhs, 2, M, K, 64, 64) ||
      !make_map(&map_d, dout, 4, M, N, 64, 32))
    return cudaErrorInvalidValue;
  const int sms = current_sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  auto launch = [&](auto kernel, auto shape) -> int {
    using P = decltype(shape);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const long long tiles = (long long)G * ((N + P::CN - 1) / P::CN) *
                            ((K + P::CK - 1) / P::CK);
    kernel<<<(int)(tiles < sms ? tiles : sms), THREADS, P::SMEM_BYTES,
             static_cast<cudaStream_t>(stream)>>>(map_x, map_d, out,
                                                  group_sizes, G, M, K, N);
    return cudaGetLastError();
  };
  if (plan == 0) return launch(tc_tgmm_kernel<128, 1>, Tg<128, 1>{});
  return launch(tc_tgmm_kernel<64, 2>, Tg<64, 2>{});
}
