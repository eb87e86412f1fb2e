// Flash-attention backward for bf16 on Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel, each with TMA loads into a ring of shared-memory stages,
// wgmma for every product, one producer warp and two consumer warpgroups.
//
// Replaces: molly_tpu/ops/flash_attention.py:_dq_kernel and :_dkv_kernel
// (the Pallas TPU kernels launched from _flash_bwd) for bf16 operands with
// 16-byte aligned bases and strides (ops/flash_attention.py:bwd_takes_tma is
// the rule; fp32 and unaligned views stay on flash_attention_bwd.cu's SIMT
// kernels). Same function: P = exp(S - LSE) recomputed from the forward's
// fp32 LSE, dS = P * (dO V^T - delta) with delta = rowsum(dO * O) handed in,
// P and dS rounded to bf16 before their second product, the softmax scale
// on the fp32 scores and once more on dQ and dK; GQA as kv head = h / (N /
// Nkv) with K and V never repeated, dK and dV summed over the q heads of
// the group. The Pallas split into a dQ and a dK/dV kernel stays: no
// atomics, a fixed order of sums, so two runs give the same bits.
//
// What bounds it on this card: 7 products of ~2 * D multiply-adds per
// allowed (query, key) pair (S and dP in both kernels, dQ; dV and dK), far
// above the ops-per-byte ridge at every training shape, so the tensor
// cores' rate (wgmma only) and the work done on keys the mask removes decide
// its time. The elementwise part (exp2 and the mask on 2 x 64 x 64 scores a
// tile) does not hide behind its own warpgroup's products; the other
// warpgroup's products run meanwhile.
//
// The design. Masked scores give P = 0 exactly (not exp of a large negative
// number), so a row without a valid key (the forward gave it LSE = 0) adds
// nothing to dK or dV, and its dQ is 0. Tensor maps are 4-D over the strided
// [B, S, heads, D] views, so q, k, v and dO are read in place; rows past Sq
// or Skv arrive as zeros and stores clip there. They are encoded on the host
// at each launch and passed as __grid_constant__; nothing is allocated and
// no value is read on the host, so CUDA-graph capture works.
//   - dQ: a block owns one (batch row, q head, 128-row q tile), the longest
//     causal blocks first. The producer warp loads Q and dO once, then walks
//     the 64-key tiles below the block's causal limit with the forward's
//     mask ballot: a tile without a valid key is never loaded. The others
//     arrive by TMA in a ring of 4 stages of K and V (128-byte swizzle, full
//     and empty mbarriers), with the tile's first key and validity bits; a
//     first key of -1 ends the loop. Two consumer warpgroups own 64 q rows
//     each: S = Q K^T and dP = dO V^T (A = Q, dO and B = K, V, all K-major in
//     shared memory) into 2 x 32 registers a thread, P and dS on that
//     accumulator layout, dS packed to bf16 pairs as the register A operand
//     of dQ += dS K, which reads K MN-major as it lies (no transposed copy).
//     That product stays in flight while the next tile's S and dP run. The
//     epilogue scales dQ, stages it in bf16 in the warpgroup's part of the Q
//     tile and stores it by TMA.
//   - dK/dV: a block owns one (batch row, kv head, 128-key tile), the first
//     key tiles (which every causal q tile sees) first. The block's 128 mask
//     entries are read once; a tile without a valid key loads nothing and
//     stores dK = dV = 0, and so does a warpgroup whose 64 keys are all
//     masked. The producer loads K and V once, then streams, for each q head
//     of the group and each 64-row q tile from the first causal one, Q and dO
//     by TMA and the tile's LSE * log2(e) and delta by its 32 lanes into the
//     stage (LSE = +inf past Sq, so such rows give P = 0). Two consumer
//     warpgroups own 64 keys each: S^T = K Q^T and dP^T = V dO^T (A = K, V
//     loaded once; B = Q, dO K-major), P^T and dS^T with each column's LSE
//     and delta read from the stage, then dV += P^T dO and dK += dS^T Q with
//     P^T and dS^T as register A operands and dO, Q read MN-major. dK and dV
//     (2 x D / 2 fp32 registers a thread) stay in registers across the whole
//     loop, so the sums over the group and the q tiles never leave the
//     block; to keep S^T and dP^T beside them, a tile's dK/dV products retire
//     before the next tile's S^T is issued. The epilogue stages dK (scaled)
//     and dV in bf16 in the warpgroup's rows of K and V and stores them by
//     TMA.
//   - Register budget: the consumers take 232 registers a thread
//     (setmaxnreg), the producer warpgroup 40. dQ holds S, dP (32 + 32) and
//     dQ (D / 2) with dS in flight (16); dK/dV holds dK, dV (D / 2 each),
//     S^T and dP^T (32 + 32), and P^T, dS^T (16 + 16) as they are packed.
//   - Tiles and occupancy: one block an SM (384 threads, ~193 KB of shared
//     memory). The training shape [4, 1024, 16, 128] over 8 kv heads gives
//     512 dQ and 256 dK/dV blocks; the MoE shape [4, 1024, 32, 128] over 4
//     kv heads 1024 dQ and 128 dK/dV blocks of 8 heads each. dQ takes
//     64-key tiles: 128-key tiles (S and dP at 64 registers each, dS retired
//     before the next tile) ran slower on the card. dK/dV keeps 128-key
//     blocks at the MoE shape too, though the first key tile's block loops
//     over 8 heads x 16 q tiles while the last one's loops over 8 x 2: a
//     64-key block would pay off only at two blocks an SM, which the
//     consumers' registers do not leave room for.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace molly::hopper;

constexpr int THREADS = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int ROW = 128;      // bytes of a shared row: 64 bf16, swizzled
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const int32_t* mask;  // [B, Skv] (strided) or null
  const float* lse;     // [B, N, Sq]
  const float* delta;   // [B, N, Sq]
  int B, N, Nkv, group, Sq, Skv;
  int n_qt;  // q tiles of the dQ kernel's 128 rows, or of the dK/dV's 64
  long long m_sb, m_ss;
  float scale, scale_log2;  // scale * log2(e): scores live in base 2
  int causal, q_offset;
};

template <int STAGES>
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

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

constexpr int DQ_BM = 128;  // q rows a block: two warpgroups of 64
constexpr int DQ_BN = 64;   // keys a tile

template <int D>
struct DqCfg {
  static constexpr int CH = D / 64;              // 64-wide head-dim chunks
  static constexpr int Q_CHUNK = DQ_BM * ROW;    // 16 KB
  static constexpr int KV_CHUNK = DQ_BN * ROW;   // 8 KB
  static constexpr int Q_BYTES = CH * Q_CHUNK;   // Q, and again dO
  static constexpr int STAGE_BYTES = 2 * CH * KV_CHUNK;  // K, then V
  static constexpr int STAGES = 4;
  static constexpr int W = DQ_BN / 32;  // validity words a tile
  static constexpr int SMEM = 2 * Q_BYTES + STAGES * STAGE_BYTES + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_dq,
                        const Args a) {
  using C = DqCfg<D>;
  constexpr int STAGES = C::STAGES, W = C::W;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES], s_qbar;
  __shared__ int s_key0[STAGES];
  __shared__ uint32_t s_bits[STAGES][W];

  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* q_sm = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* do_sm = q_sm + C::Q_BYTES;
  unsigned char* ring_sm = do_sm + C::Q_BYTES;

  // block -> (q tile, batch row, head); heads fastest, so the q heads of one
  // kv head run side by side and share its tiles in L2
  const int per_qt = a.N * a.B;
  int qt = blockIdx.x / per_qt;
  const int rest = blockIdx.x - qt * per_qt;
  if (a.causal) qt = a.n_qt - 1 - qt;  // the longest blocks first
  const int h = rest % a.N, b = rest / a.N;
  const int kvh = h / a.group;
  const int q0 = qt * DQ_BM;
  const int last_row = min(q0 + DQ_BM, a.Sq) - 1;
  // keys [0, kv_end) may be seen by some row of the block
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, a.q_offset + last_row + 1);
  const int active_wgs = q0 + 64 < a.Sq ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&s_full[s], 1);                // the producer's arrive + bytes
      mbar_init(&s_empty[s], 4 * active_wgs);  // one lane a consumer warp
    }
    mbar_init(&s_qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 288) return;  // one producer warp
    if (lane == 0) {
      mbar_expect_tx(&s_qbar, 2 * C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::CH; ++c) {
        tma_load_4d(q_sm + c * C::Q_CHUNK, &map_q, &s_qbar, c * 64, q0, h, b);
        tma_load_4d(do_sm + c * C::Q_CHUNK, &map_do, &s_qbar, c * 64, q0, h,
                    b);
      }
    }
    const int32_t* mp = a.mask ? a.mask + b * a.m_sb : nullptr;
    Ring<STAGES> ring;
    for (int base = 0; base < kv_end; base += 4 * DQ_BN) {
      // validity of keys base + 32 i + lane, 4 tiles' worth of loads in
      // flight; w[i] bit L = key base + 32 i + L
      int keep[4 * W];
#pragma unroll
      for (int i = 0; i < 4 * W; ++i) {
        const int key = base + 32 * i + lane;
        keep[i] = key < kv_end ? (mp ? mp[(long long)key * a.m_ss] : 1) : 0;
      }
      uint32_t w[4 * W];
#pragma unroll
      for (int i = 0; i < 4 * W; ++i)
        w[i] = __ballot_sync(0xffffffffu, keep[i]);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int k0 = base + tt * DQ_BN;
        uint32_t any = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) any |= w[W * tt + i];
        if (k0 >= kv_end || any == 0) continue;  // no valid key: not visited
        mbar_wait(&s_empty[ring.stage], ring.phase ^ 1);
        if (lane == 0) {
          s_key0[ring.stage] = k0;
#pragma unroll
          for (int i = 0; i < W; ++i) s_bits[ring.stage][i] = w[W * tt + i];
          uint64_t* bar = &s_full[ring.stage];
          mbar_expect_tx(bar, C::STAGE_BYTES);
          unsigned char* kt = ring_sm + ring.stage * C::STAGE_BYTES;
#pragma unroll
          for (int c = 0; c < C::CH; ++c) {
            tma_load_4d(kt + c * C::KV_CHUNK, &map_k, bar, c * 64, k0, kvh, b);
            tma_load_4d(kt + (C::CH + c) * C::KV_CHUNK, &map_v, bar, c * 64,
                        k0, kvh, b);
          }
        }
        __syncwarp();
        ring.advance();
      }
    }
    mbar_wait(&s_empty[ring.stage], ring.phase ^ 1);
    if (lane == 0) {
      s_key0[ring.stage] = -1;  // the end
      mbar_arrive(&s_full[ring.stage]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  if (wg >= active_wgs) return;  // all its rows lie past Sq
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 64 * wg;          // the warpgroup's first row
  const int row0 = wrow + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  // causal: keys <= pos0 for row0, <= pos0 + 8 for row0 + 8
  const int pos0 = a.causal ? a.q_offset + row0 : 0x7fffffff - 8;
  // keys past wg_last lie above the diagonal of every row of the warpgroup;
  // keys up to wg_first below that of every row
  const int wg_last =
      a.causal ? a.q_offset + min(wrow + 63, a.Sq - 1) : 0x7fffffff;
  const int wg_first = a.causal ? a.q_offset + wrow : 0x7fffffff;
  float lse2[2], dl[2];
  const long long bh = ((long long)b * a.N + h) * a.Sq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    lse2[hr] = row < a.Sq ? a.lse[bh + row] * LOG2E : 0.f;
    dl[hr] = row < a.Sq ? a.delta[bh + row] : 0.f;
  }

  constexpr int NQ = D / 2;      // dQ accumulators a thread: m64nDk16
  constexpr int NS = DQ_BN / 2;  // S and dP accumulators a thread
  float dq[NQ], s[NS], dp[NS];
  uint32_t da[DQ_BN / 16][4] = {};  // dS as the A operand, 16 keys a k-step
#pragma unroll
  for (int i = 0; i < NQ; ++i) dq[i] = 0.f;

  const uint32_t q_base = smem_u32(q_sm) + wg * 64 * ROW;
  const uint32_t do_base = smem_u32(do_sm) + wg * 64 * ROW;
  mbar_wait(&s_qbar, 0);
  Ring<STAGES> ring;
  int prev = -1;  // the stage whose dS K is in flight
  for (;;) {
    mbar_wait(&s_full[ring.stage], ring.phase);
    const int stage = ring.stage;
    const int k0 = s_key0[stage];
    if (k0 < 0) break;
    if (k0 > wg_last) {  // every key above this warpgroup's diagonal
      // so is every later tile's: release the stage still held too (the
      // producer may be waiting on it to write the end)
      if (prev >= 0) {
        wgmma_wait<0>();
        fence_acc(dq);
        fence_regs(da);
        if (lane == 0) mbar_arrive(&s_empty[prev]);
        prev = -1;
      }
      if (lane == 0) mbar_arrive(&s_empty[stage]);
      ring.advance();
      continue;
    }
    uint32_t bits[W];
#pragma unroll
    for (int i = 0; i < W; ++i) bits[i] = s_bits[stage][i];
    const uint32_t k_base = smem_u32(ring_sm + stage * C::STAGE_BYTES);
    const uint32_t v_base = k_base + C::CH * C::KV_CHUNK;

    // S = Q K^T and dP = dO V^T
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t oa = (ks >> 2) * C::Q_CHUNK + (ks & 3) * 32;
      const uint32_t ob = (ks >> 2) * C::KV_CHUNK + (ks & 3) * 32;
      wgmma_m64n64k16<0, 0>(s, smem_desc(q_base + oa, C::Q_CHUNK),
                            smem_desc(k_base + ob, C::KV_CHUNK), ks > 0);
      wgmma_m64n64k16<0, 0>(dp, smem_desc(do_base + oa, C::Q_CHUNK),
                            smem_desc(v_base + ob, C::KV_CHUNK), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // S and dP, and the dS K of the tile before
    fence_acc(s);
    fence_acc(dp);
    fence_acc(dq);
    fence_regs(da);
    if (prev >= 0 && lane == 0) mbar_arrive(&s_empty[prev]);

    // dS = P * (dP - delta); element 4j + e is row row0 + 8 (e >> 1), key
    // k0 + 8j + 2t + (e & 1). A masked key gives P = 0 exactly.
    uint32_t all = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < W; ++i) all &= bits[i];
    const bool whole = all == 0xffffffffu && k0 + DQ_BN - 1 <= wg_first;
#pragma unroll
    for (int j = 0; j < DQ_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 8 * j + 2 * t + (e & 1);
        const int hr = e >> 1;
        const bool ok = whole || (((bits[j >> 2] >> (kk & 31)) & 1u) &&
                                  k0 + kk <= pos0 + 8 * hr);
        const float p =
            ok ? exp2f(fmaf(s[4 * j + e], a.scale_log2, -lse2[hr])) : 0.f;
        s[4 * j + e] = p * (dp[4 * j + e] - dl[hr]);
      }
#pragma unroll
    for (int kk = 0; kk < DQ_BN / 16; ++kk) {
      da[kk][0] = molly::pack_bf16(s[8 * kk], s[8 * kk + 1]);
      da[kk][1] = molly::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      da[kk][2] = molly::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      da[kk][3] = molly::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // dQ += dS K, left in flight; B = K read MN-major as it lies
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BN / 16; ++kk) {
      const uint64_t kd = smem_desc(k_base + kk * 2048, C::KV_CHUNK);
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1>(dq, da[kk], kd);
      else
        wgmma_m64n64k16_rs<1>(dq, da[kk], kd);
    }
    wgmma_commit();
    prev = stage;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_acc(dq);
  fence_regs(da);
  if (prev >= 0 && lane == 0) mbar_arrive(&s_empty[prev]);

  // epilogue: dQ * scale in bf16, staged in this warpgroup's part of the Q
  // tile (its products have retired): 64-column chunk c at q_sm + c *
  // Q_CHUNK + wg * 8 KB, rows of 128 bytes in the swizzle the store reads
  warpgroup_sync(wg);
  unsigned char* stg = q_sm + wg * 64 * ROW;
  const int r = 16 * warp + g;  // and r + 8; both are g modulo 8
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* p =
        stg + (j >> 3) * C::Q_CHUNK + r * ROW + (((j & 7) ^ g) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(p) =
        molly::pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    *reinterpret_cast<uint32_t*>(p + 8 * ROW) =
        molly::pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
  }
  fence_async_shared();
  warpgroup_sync(wg);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int c = 0; c < C::CH; ++c)
      tma_store_4d(&map_dq, stg + c * C::Q_CHUNK, c * 64, wrow, h, b);
    tma_store_commit();
    tma_store_wait_all();
  }
}

// ---------------------------------------------------------------------------
// dK and dV
// ---------------------------------------------------------------------------

constexpr int KV_BK = 128;  // keys a block: two warpgroups of 64
constexpr int KV_BQ = 64;   // q rows a stage

constexpr int KV_STAGES = 4;

template <int D>
struct DkvCfg {
  static constexpr int CH = D / 64;
  static constexpr int K_CHUNK = KV_BK * ROW;  // 16 KB
  static constexpr int Q_CHUNK = KV_BQ * ROW;  // 8 KB
  static constexpr int K_BYTES = CH * K_CHUNK;  // K, and again V
  static constexpr int STAGE_BYTES = 2 * CH * Q_CHUNK;  // Q, then dO
  static constexpr int SMEM = 2 * K_BYTES + KV_STAGES * STAGE_BYTES + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dkv_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_dk,
                         const __grid_constant__ CUtensorMap map_dv,
                         const Args a) {
  using C = DkvCfg<D>;
  constexpr int STAGES = KV_STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES], s_kvbar;
  __shared__ int s_q0[STAGES];
  // LSE * log2(e) and delta of the stage's 64 q rows
  __shared__ __align__(16) float s_lse[STAGES][KV_BQ], s_dl[STAGES][KV_BQ];
  __shared__ uint32_t s_kbits[KV_BK / 32];

  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* k_sm = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* v_sm = k_sm + C::K_BYTES;
  unsigned char* ring_sm = v_sm + C::K_BYTES;

  // block -> (key tile, batch row, kv head); the first key tiles, which
  // every causal q tile sees, first
  const int per_kt = a.Nkv * a.B;
  const int kt = blockIdx.x / per_kt;
  const int rest = blockIdx.x - kt * per_kt;
  const int kvh = rest % a.Nkv, b = rest / a.Nkv;
  const int k0 = kt * KV_BK;
  const int lane = threadIdx.x & 31;

  // the validity of the block's keys, bit L of word i = key k0 + 32 i + L
  if (threadIdx.x < KV_BK) {
    const int key = k0 + threadIdx.x;
    const bool ok = key < a.Skv &&
                    (a.mask == nullptr ||
                     a.mask[b * a.m_sb + (long long)key * a.m_ss] != 0);
    const uint32_t w = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) s_kbits[threadIdx.x >> 5] = w;
  }
  __syncthreads();
  // a warpgroup whose 64 keys are all masked does no work and stores zeros
  const int n_act = ((s_kbits[0] | s_kbits[1]) != 0) +
                    ((s_kbits[2] | s_kbits[3]) != 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&s_full[s], 32);  // the producer warp's lanes (+ bytes)
      mbar_init(&s_empty[s], 4 * max(n_act, 1));  // a lane a consumer warp
    }
    mbar_init(&s_kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 288 || n_act == 0) return;  // one producer warp
    if (lane == 0) {
      mbar_expect_tx(&s_kvbar, 2 * C::K_BYTES);
#pragma unroll
      for (int c = 0; c < C::CH; ++c) {
        tma_load_4d(k_sm + c * C::K_CHUNK, &map_k, &s_kvbar, c * 64, k0, kvh,
                    b);
        tma_load_4d(v_sm + c * C::K_CHUNK, &map_v, &s_kvbar, c * 64, k0, kvh,
                    b);
      }
    }
    // q rows below the block's first key's diagonal see none of its keys
    const int qt0 = a.causal ? max(k0 - a.q_offset, 0) / KV_BQ : 0;
    Ring<STAGES> ring;
    for (int gi = 0; gi < a.group; ++gi) {
      const int h = kvh * a.group + gi;
      const long long bh = ((long long)b * a.N + h) * a.Sq;
      for (int qt = qt0; qt < a.n_qt; ++qt) {
        const int q0 = qt * KV_BQ;
        const int stage = ring.stage;
        mbar_wait(&s_empty[stage], ring.phase ^ 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = lane + 32 * i, q = q0 + rr;
          s_lse[stage][rr] = q < a.Sq ? a.lse[bh + q] * LOG2E : INFINITY;
          s_dl[stage][rr] = q < a.Sq ? a.delta[bh + q] : 0.f;
        }
        if (lane == 0) {
          s_q0[stage] = q0;
          uint64_t* bar = &s_full[stage];
          mbar_expect_tx(bar, C::STAGE_BYTES);
          unsigned char* qs = ring_sm + stage * C::STAGE_BYTES;
#pragma unroll
          for (int c = 0; c < C::CH; ++c) {
            tma_load_4d(qs + c * C::Q_CHUNK, &map_q, bar, c * 64, q0, h, b);
            tma_load_4d(qs + (C::CH + c) * C::Q_CHUNK, &map_do, bar, c * 64,
                        q0, h, b);
          }
        } else {
          mbar_arrive(&s_full[stage]);
        }
        ring.advance();
      }
    }
    mbar_wait(&s_empty[ring.stage], ring.phase ^ 1);
    if (lane == 0) s_q0[ring.stage] = -1;  // the end
    mbar_arrive(&s_full[ring.stage]);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wk = k0 + 64 * wg;  // the warpgroup's first key
  // this thread's keys: kr and kr + 8 of the block
  const int kr = 64 * wg + 16 * warp + g;
  const bool key_ok[2] = {
      ((s_kbits[kr >> 5] >> (kr & 31)) & 1u) != 0,
      ((s_kbits[(kr + 8) >> 5] >> ((kr + 8) & 31)) & 1u) != 0};
  const int key0 = k0 + kr;
  const bool act = (s_kbits[2 * wg] | s_kbits[2 * wg + 1]) != 0;

  constexpr int NA = D / 2;  // dK, dV accumulators a thread: m64nDk16
  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  if (act) {
    float st[32], dpt[32];
    uint32_t pa[KV_BQ / 16][4], da[KV_BQ / 16][4];
    const uint32_t k_base = smem_u32(k_sm) + wg * 64 * ROW;
    const uint32_t v_base = smem_u32(v_sm) + wg * 64 * ROW;
    mbar_wait(&s_kvbar, 0);
    Ring<STAGES> ring;
    for (;;) {
      mbar_wait(&s_full[ring.stage], ring.phase);
      const int stage = ring.stage;
      const int q0 = s_q0[stage];
      if (q0 < 0) break;
      if (a.causal && a.q_offset + q0 + KV_BQ - 1 < wk) {
        // every key of this warpgroup lies above every row's diagonal
        if (lane == 0) mbar_arrive(&s_empty[stage]);
        ring.advance();
        continue;
      }
      const uint32_t q_st = smem_u32(ring_sm + stage * C::STAGE_BYTES);
      const uint32_t do_st = q_st + C::CH * C::Q_CHUNK;

      // S^T = K Q^T and dP^T = V dO^T
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t oa = (ks >> 2) * C::K_CHUNK + (ks & 3) * 32;
        const uint32_t ob = (ks >> 2) * C::Q_CHUNK + (ks & 3) * 32;
        wgmma_m64n64k16<0, 0>(st, smem_desc(k_base + oa, C::K_CHUNK),
                              smem_desc(q_st + ob, C::Q_CHUNK), ks > 0);
        wgmma_m64n64k16<0, 0>(dpt, smem_desc(v_base + oa, C::K_CHUNK),
                              smem_desc(do_st + ob, C::Q_CHUNK), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      fence_acc(dk);
      fence_acc(dv);

      // P^T and dS^T; element 4j + e is key key0 + 8 (e >> 1), q row
      // q0 + 8j + 2t + (e & 1). A masked key gives P = 0 exactly.
      const int qpos = a.causal ? a.q_offset + q0 : 0x7fffffff - 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(&s_lse[stage][8 * j + 2 * t]);
        const float2 d2 =
            *reinterpret_cast<const float2*>(&s_dl[stage][8 * j + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const bool ok =
              key_ok[hr] && key0 + 8 * hr <= qpos + 8 * j + 2 * t + (e & 1);
          const float p =
              ok ? exp2f(fmaf(st[4 * j + e], a.scale_log2,
                              -((e & 1) ? l2.y : l2.x)))
                 : 0.f;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
          st[4 * j + e] = p;
        }
      }
#pragma unroll
      for (int kk = 0; kk < KV_BQ / 16; ++kk) {
        pa[kk][0] = molly::pack_bf16(st[8 * kk], st[8 * kk + 1]);
        pa[kk][1] = molly::pack_bf16(st[8 * kk + 2], st[8 * kk + 3]);
        pa[kk][2] = molly::pack_bf16(st[8 * kk + 4], st[8 * kk + 5]);
        pa[kk][3] = molly::pack_bf16(st[8 * kk + 6], st[8 * kk + 7]);
        da[kk][0] = molly::pack_bf16(dpt[8 * kk], dpt[8 * kk + 1]);
        da[kk][1] = molly::pack_bf16(dpt[8 * kk + 2], dpt[8 * kk + 3]);
        da[kk][2] = molly::pack_bf16(dpt[8 * kk + 4], dpt[8 * kk + 5]);
        da[kk][3] = molly::pack_bf16(dpt[8 * kk + 6], dpt[8 * kk + 7]);
      }

      // dV += P^T dO and dK += dS^T Q; B = dO, Q read MN-major as they lie
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV_BQ / 16; ++kk) {
        const uint64_t od = smem_desc(do_st + kk * 2048, C::Q_CHUNK);
        const uint64_t qd = smem_desc(q_st + kk * 2048, C::Q_CHUNK);
        if constexpr (D == 128) {
          wgmma_m64n128k16_rs<1>(dv, pa[kk], od);
          wgmma_m64n128k16_rs<1>(dk, da[kk], qd);
        } else {
          wgmma_m64n64k16_rs<1>(dv, pa[kk], od);
          wgmma_m64n64k16_rs<1>(dk, da[kk], qd);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();  // frees the registers S^T and dP^T take next
      fence_acc(dk);
      fence_acc(dv);
      fence_regs(pa);
      fence_regs(da);
      if (lane == 0) mbar_arrive(&s_empty[stage]);
      ring.advance();
    }
  } else if (n_act > 0) {
    mbar_wait(&s_kvbar, 0);  // K and V land in this warpgroup's rows too
  }

  // epilogue: dK * scale and dV in bf16, staged in this warpgroup's rows of
  // K and V (its products have retired), in the swizzle the stores read
  warpgroup_sync(wg);
  unsigned char* kst = k_sm + wg * 64 * ROW;
  unsigned char* vst = v_sm + wg * 64 * ROW;
  const int r = 16 * warp + g;  // and r + 8; both are g modulo 8
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int off =
        (j >> 3) * C::K_CHUNK + r * ROW + (((j & 7) ^ g) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(kst + off) =
        molly::pack_bf16(dk[4 * j] * a.scale, dk[4 * j + 1] * a.scale);
    *reinterpret_cast<uint32_t*>(kst + off + 8 * ROW) =
        molly::pack_bf16(dk[4 * j + 2] * a.scale, dk[4 * j + 3] * a.scale);
    *reinterpret_cast<uint32_t*>(vst + off) =
        molly::pack_bf16(dv[4 * j], dv[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(vst + off + 8 * ROW) =
        molly::pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
  }
  fence_async_shared();
  warpgroup_sync(wg);
  if ((threadIdx.x & 127) == 0 && wk < a.Skv) {
#pragma unroll
    for (int c = 0; c < C::CH; ++c) {
      tma_store_4d(&map_dk, kst + c * C::K_CHUNK, c * 64, wk, kvh, b);
      tma_store_4d(&map_dv, vst + c * C::K_CHUNK, c * 64, wk, kvh, b);
    }
    tma_store_commit();
    tma_store_wait_all();
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// the map of operand i of (q, k, v, dO, out1, out2), q-shaped ([B, Sq, N,
// D]) or kv-shaped ([B, Skv, Nkv, D]), boxes of `rows` positions; st holds
// the six operands' (batch, sequence, head) element strides
bool map_of(CUtensorMap* m, const void* p, int i, bool q_shaped,
            const long long* st, const Args& a, int D, int rows) {
  return make_bsnd_map(m, p, D, q_shaped ? a.Sq : a.Skv,
                       q_shaped ? a.N : a.Nkv, a.B, st[3 * i + 1],
                       st[3 * i + 2], st[3 * i], rows);
}

bool valid(const Args& a, const void* const (&ptrs)[6], const long long* st) {
  if (a.B <= 0 || a.N <= 0 || a.Nkv <= 0 || a.N % a.Nkv != 0 || a.Sq <= 0 ||
      a.Skv <= 0)
    return false;
  for (int i = 0; i < 6; ++i)
    if (ptrs[i] != nullptr && !aligned16(ptrs[i])) return false;
  for (int i = 0; i < 18; ++i)
    if (st[i] % 8 != 0 || st[i] <= 0) return false;
  return true;
}

Args make_args(const int32_t* mask, const float* lse, const float* delta,
               int B, int N, int Nkv, int Sq, int Skv, const long long* st,
               float scale, int causal, int q_offset, int q_tile) {
  Args a;
  a.mask = mask;
  a.lse = lse;
  a.delta = delta;
  a.B = B;
  a.N = N;
  a.Nkv = Nkv;
  a.group = Nkv > 0 ? N / Nkv : 1;
  a.Sq = Sq;
  a.Skv = Skv;
  a.n_qt = (Sq + q_tile - 1) / q_tile;
  a.m_sb = st[18];
  a.m_ss = st[19];
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  a.causal = causal;
  a.q_offset = q_offset;
  return a;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              void* dq, const long long* st, const Args& a,
              cudaStream_t stream) {
  alignas(64) CUtensorMap m[5];
  if (!map_of(&m[0], q, 0, true, st, a, D, DQ_BM) ||
      !map_of(&m[1], k, 1, false, st, a, D, DQ_BN) ||
      !map_of(&m[2], v, 2, false, st, a, D, DQ_BN) ||
      !map_of(&m[3], dout, 3, true, st, a, D, DQ_BM) ||
      !map_of(&m[4], dq, 4, true, st, a, D, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_tma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqCfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.n_qt * a.N * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_dq_tma_kernel<D><<<(unsigned)blocks, THREADS, DqCfg<D>::SMEM,
                           stream>>>(m[0], m[1], m[2], m[3], m[4], a);
  return cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               void* dk, void* dv, const long long* st, const Args& a,
               cudaStream_t stream) {
  alignas(64) CUtensorMap m[6];
  if (!map_of(&m[0], q, 0, true, st, a, D, KV_BQ) ||
      !map_of(&m[1], k, 1, false, st, a, D, KV_BK) ||
      !map_of(&m[2], v, 2, false, st, a, D, KV_BK) ||
      !map_of(&m[3], dout, 3, true, st, a, D, KV_BQ) ||
      !map_of(&m[4], dk, 4, false, st, a, D, 64) ||
      !map_of(&m[5], dv, 5, false, st, a, D, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_tma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DkvCfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((a.Skv + KV_BK - 1) / KV_BK) * a.Nkv * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_dkv_tma_kernel<D><<<(unsigned)blocks, THREADS, DkvCfg<D>::SMEM,
                            stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], a);
  return cudaGetLastError();
}

}  // namespace

// q, dO, dQ [B, Sq, N, D]; k, v [B, Skv, Nkv, D], all bf16 with the head dim
// contiguous, 16-byte aligned bases and strides of multiples of 8 elements;
// lse, delta [B, N, Sq] fp32 contiguous; D is 64 or 128. `strides`: 20
// element strides, q, k, v, dO, dQ and any valid triple by (batch,
// sequence, head), then the mask's (batch, key).
extern "C" int molly_flash_attention_dq_tma(
    const void* q, const void* k, const void* v, const void* dout,
    const int32_t* mask, const float* lse, const float* delta, void* dq,
    int B, int N, int Nkv, int Sq, int Skv, int D, const long long* strides,
    float scale, int causal, int q_offset, void* stream) {
  const Args a = make_args(mask, lse, delta, B, N, Nkv, Sq, Skv, strides,
                           scale, causal, q_offset, DQ_BM);
  const void* const ptrs[6] = {q, k, v, dout, dq, nullptr};
  if (!valid(a, ptrs, strides)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dq<64>(q, k, v, dout, dq, strides, a, s);
  if (D == 128) return launch_dq<128>(q, k, v, dout, dq, strides, a, s);
  return cudaErrorInvalidValue;
}

// as above; dk, dv [B, Skv, Nkv, D] by the fifth and sixth stride triples.
extern "C" int molly_flash_attention_dkv_tma(
    const void* q, const void* k, const void* v, const void* dout,
    const int32_t* mask, const float* lse, const float* delta, void* dk,
    void* dv, int B, int N, int Nkv, int Sq, int Skv, int D,
    const long long* strides, float scale, int causal, int q_offset,
    void* stream) {
  const Args a = make_args(mask, lse, delta, B, N, Nkv, Sq, Skv, strides,
                           scale, causal, q_offset, KV_BQ);
  const void* const ptrs[6] = {q, k, v, dout, dk, dv};
  if (!valid(a, ptrs, strides)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dkv<64>(q, k, v, dout, dk, dv, strides, a, s);
  if (D == 128) return launch_dkv<128>(q, k, v, dout, dk, dv, strides, a, s);
  return cudaErrorInvalidValue;
}
