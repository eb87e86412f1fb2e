// Flash-attention forward for bf16 on Hopper (sm_90a): TMA loads into a ring
// of shared-memory stages, wgmma for both products, one producer warp and
// two consumer warpgroups.
//
// Replaces: molly_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas TPU
// kernel launched from _flash_fwd) for bf16 operands with 16-byte aligned
// bases and strides (ops/flash_attention.py:fwd_takes_tma is the rule; fp32
// and unaligned views stay on flash_attention_fwd.cu's SIMT kernel). Same
// function: online softmax in fp32, GQA as kv head = h / (N / Nkv) with no
// repeated K/V, an optional [B, Skv] int mask, causal masking with a static
// q_offset, the kv_len guard, O in bf16 and an fp32 LSE [B, N, Sq] that the
// dQ and dK/dV kernels read.
//
// What bounds it on this card: ~4 * D multiply-adds per allowed (query,
// key) pair, far above the ops-per-byte ridge at every main-path shape, so
// the tensor cores' rate (wgmma only) and the work done on keys the mask
// removes decide its time.
//
// The design. A block owns one (batch row, q head, 128-row q tile); the
// grid walks q tiles slowest and, under the causal rule, from the last
// (longest) to the first. 3 warpgroups: two consumers of 64 q rows each
// (232 registers a thread), and a producer of which one warp runs.
//   - The producer loads Q once by TMA, then walks the key tiles of 128 keys
//     below the block's causal limit. For 4 tiles at a time its 32 lanes read
//     the mask entries and a warp ballot makes each tile's 128 validity bits
//     (mask, kv_len and the block's causal limit). A tile without a valid key
//     is not visited: nothing is loaded or computed for it. For the others
//     one lane writes the tile's first key and bits into the stage and starts
//     TMA loads of K and V into the ring (128-byte swizzle, full and empty
//     mbarriers); a first key of -1 ends the consumers' loop. The device
//     decides all this: no host read, so CUDA-graph capture works.
//   - Tensor maps are 4-D over the strided [B, S, heads, D] views, so the
//     head-major KV cache [B, Nkv, Smax, 2 * Dh] is read in place; rows past
//     Sq or Skv arrive as zeros. They are encoded on the host at each launch
//     and passed as __grid_constant__; the kernel allocates nothing.
//   - S = Q K^T is one wgmma chain (A = Q, B = K, both K-major in shared
//     memory) into 64 fp32 registers a thread. On that accumulator layout the
//     consumer masks (only tiles that are not wholly valid for its rows),
//     runs the online softmax in base 2 with the scale folded in (row maxima
//     reduced across the 4 lanes of a quad; row sums kept per lane and
//     reduced once at the end), and packs P to bf16 pairs, which is the
//     register A operand of O += P V; B = V is read MN-major as it lies, so
//     nothing is transposed. That product is left in flight while the next
//     tile's S is issued; the stage is released once it has retired.
//   - A warpgroup whose rows all lie past Sq does no work; one that lies
//     wholly below a tile's keys (the causal diagonal) skips that tile.
//   - The epilogue divides by the row sum, stages O in bf16 in the
//     warpgroup's own part of the Q tile (swizzled) and stores it by TMA,
//     which clips rows past Sq; one lane a row writes the LSE.
//   - A row with no valid key (a left-padded prompt position) gets O = 0 and
//     LSE = 0, whatever the tiling: masked scores are -inf and exp2 of a
//     masked score against a row maximum of -inf is taken against 0, so
//     such a row never gathers weight. LSE = 0 makes the backward's
//     exp(S - LSE) zero on every key of the row, as O is. For a row with a
//     valid key nothing differs from visiting every tile but the order of
//     fp32 sums: a masked key adds exactly zero.
//   - No atomics, a fixed order of sums: two runs give the same bits.
// Tiles of 128 keys for D = 64 too: S then fills the same 64 registers, and
// one tile shape keeps one producer; 2 ring stages for D = 128 (64 KB a
// stage, 160 KB with Q), 3 for D = 64 (32 KB a stage).
//
// The q.k head width DQK may exceed the v head width DV: multi-head latent
// attention (models/deepseek_v3.py) attends with q and k of 192 (128
// decompressed + 64 rotary) and v of 128. Q and K are then DQK / 64 chunks
// of 64 columns, V and O DV / 64; S = Q K^T takes DQK / 16 k-steps into the
// same 64 registers, O keeps DV / 2, so the register budget is D = 128's.
// At 192 / 128 a stage is 48 + 32 KB and Q 48 KB: 2 stages, 209 KB. O is
// staged in the first DV / 64 chunks of the Q tile, which has at least as
// many. The pairs built are 64 / 64, 128 / 128 and 192 / 128.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace molly::hopper;

constexpr int BM = 128;        // q rows a block: two warpgroups of 64
constexpr int BN = 128;        // keys a tile
constexpr int THREADS = 384;   // consumers: warpgroups 0, 1; producer: 2
constexpr int BOX = 128 * 128;  // 128 rows x 128 bytes (64 bf16): 16 KB
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DQK, int DV>
struct Cfg {
  static constexpr int CQ = DQK / 64;  // 64-wide chunks of a q or k row
  static constexpr int CV = DV / 64;   // of a v or o row
  static_assert(CV <= CQ, "O is staged in the Q tile");
  static constexpr int STAGES = DQK + DV > 192 ? 2 : 3;
  static constexpr int Q_BYTES = CQ * BOX;
  static constexpr int STAGE_BYTES = (CQ + CV) * BOX;  // K, then V
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024;  // + align
};

struct Args {
  const int32_t* mask;  // [B, Skv] (strided) or null
  float* lse;           // [B, N, Sq]
  int B, N, group, Sq, Skv, n_qt;
  long long m_sb, m_ss;
  float scale_log2;  // softmax scale * log2(e): scores live in base 2
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

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_o,
                         const Args a) {
  using C = Cfg<DQK, DV>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES], s_qbar;
  __shared__ int s_key0[STAGES];
  __shared__ uint32_t s_bits[STAGES][4];

  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* q_sm = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* ring_sm = q_sm + C::Q_BYTES;

  // block -> (q tile, batch row, head); heads fastest, so the q heads of one
  // kv head run side by side and share its tiles in L2
  const int per_qt = a.N * a.B;
  int qt = blockIdx.x / per_qt;
  const int rest = blockIdx.x - qt * per_qt;
  if (a.causal) qt = a.n_qt - 1 - qt;  // the longest blocks first
  const int h = rest % a.N, b = rest / a.N;
  const int kvh = h / a.group;
  const int q0 = qt * BM;
  const int last_row = min(q0 + BM, a.Sq) - 1;
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
      mbar_expect_tx(&s_qbar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::CQ; ++c)
        tma_load_4d(q_sm + c * BOX, &map_q, &s_qbar, c * 64, q0, h, b);
    }
    const int32_t* mp = a.mask ? a.mask + b * a.m_sb : nullptr;
    Ring<STAGES> ring;
    for (int base = 0; base < kv_end; base += 4 * BN) {
      // validity of keys base + 32 i + lane, 4 tiles' worth of loads in
      // flight; w[i] bit L = key base + 32 i + L
      int keep[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int key = base + 32 * i + lane;
        keep[i] = key < kv_end ? (mp ? mp[(long long)key * a.m_ss] : 1) : 0;
      }
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = __ballot_sync(0xffffffffu, keep[i]);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int k0 = base + tt * BN;
        if (k0 >= kv_end ||
            (w[4 * tt] | w[4 * tt + 1] | w[4 * tt + 2] | w[4 * tt + 3]) == 0)
          continue;  // no valid key: not visited
        mbar_wait(&s_empty[ring.stage], ring.phase ^ 1);
        if (lane == 0) {
          s_key0[ring.stage] = k0;
#pragma unroll
          for (int i = 0; i < 4; ++i) s_bits[ring.stage][i] = w[4 * tt + i];
          uint64_t* bar = &s_full[ring.stage];
          mbar_expect_tx(bar, C::STAGE_BYTES);
          unsigned char* kt = ring_sm + ring.stage * C::STAGE_BYTES;
#pragma unroll
          for (int c = 0; c < C::CQ; ++c)
            tma_load_4d(kt + c * BOX, &map_k, bar, c * 64, k0, kvh, b);
#pragma unroll
          for (int c = 0; c < C::CV; ++c)
            tma_load_4d(kt + (C::CQ + c) * BOX, &map_v, bar, c * 64, k0, kvh,
                        b);
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

  constexpr int NO = DV / 2;  // O accumulators a thread: m64nDVk16
  float o[NO], s[64];
  uint32_t pa[BN / 16][4] = {};  // P as the A operand, 16 keys a k-step
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_base = smem_u32(q_sm) + wg * 64 * 128;
  mbar_wait(&s_qbar, 0);
  Ring<STAGES> ring;
  int prev = -1;  // the stage whose P V is in flight
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
        fence_acc(o);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(&s_empty[prev]);
        prev = -1;
      }
      if (lane == 0) mbar_arrive(&s_empty[stage]);
      ring.advance();
      continue;
    }
    uint32_t bits[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) bits[i] = s_bits[stage][i];
    const uint32_t k_base = smem_u32(ring_sm + stage * C::STAGE_BYTES);
    const uint32_t v_base = k_base + C::CQ * BOX;

    // S = Q K^T
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DQK / 16; ++ks) {
      const uint32_t off = (ks >> 2) * BOX + (ks & 3) * 32;
      wgmma_m64n128k16<0, 0>(s, smem_desc(q_base + off, BOX),
                             smem_desc(k_base + off, BOX), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // S, and the P V of the tile before
    fence_acc(s);
    fence_acc(o);
    fence_regs(pa);
    if (prev >= 0 && lane == 0) mbar_arrive(&s_empty[prev]);

    // mask: element 4j + e is row row0 + 8 (e >> 1), key k0 + 8j + 2t + (e & 1)
    const bool whole = (bits[0] & bits[1] & bits[2] & bits[3]) == 0xffffffffu &&
                       k0 + BN - 1 <= wg_first;
    if (!whole) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 8 * j + 2 * t + (e & 1);
          const bool ok = ((bits[j >> 2] >> (kk & 31)) & 1u) &&
                          k0 + kk <= pos0 + 8 * (e >> 1);
          if (!ok) s[4 * j + e] = -INFINITY;
        }
    }

    // online softmax, base 2; rows row0 (e = 0, 1) and row0 + 8 (e = 2, 3),
    // a row's 128 scores spread over the 4 lanes that share g
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx * a.scale_log2);
      // no valid key so far: weigh against 0, so masked keys give exactly 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[hr] - m_use);
      m[hr] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float* p = &s[4 * j + 2 * hr];
        p[0] = exp2f(fmaf(p[0], a.scale_log2, -m_use));
        p[1] = exp2f(fmaf(p[1], a.scale_log2, -m_use));
        rs += p[0] + p[1];
      }
      l[hr] = l[hr] * alpha + rs;  // this lane's part of the row sum
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[4 * j + 2 * hr] *= alpha;
        o[4 * j + 2 * hr + 1] *= alpha;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = molly::pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = molly::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = molly::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = molly::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V, left in flight
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t vd = smem_desc(v_base + kk * 2048, BOX);
      if constexpr (DV == 128)
        wgmma_m64n128k16_rs<1>(o, pa[kk], vd);
      else
        wgmma_m64n64k16_rs<1>(o, pa[kk], vd);
    }
    wgmma_commit();
    prev = stage;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_acc(o);
  fence_regs(pa);
  if (prev >= 0 && lane == 0) mbar_arrive(&s_empty[prev]);

  // epilogue: row sums across the quad, O / l (0 on a row without a key)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
  // stage O in this warpgroup's part of the Q tile (its products have
  // retired): 64-column chunk c at q_sm + c * BOX + wg * 8 KB, rows of 128
  // bytes in the 128-byte swizzle the TMA store reads
  warpgroup_sync(wg);
  unsigned char* stg = q_sm + wg * 64 * 128;
  const int r = 16 * warp + g;  // and r + 8; both are g modulo 8
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    unsigned char* p =
        stg + (j >> 3) * BOX + r * 128 + (((j & 7) ^ g) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(p) =
        molly::pack_bf16(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(p + 8 * 128) =
        molly::pack_bf16(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
  }
  fence_async_shared();
  warpgroup_sync(wg);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int c = 0; c < C::CV; ++c)
      tma_store_4d(&map_o, stg + c * BOX, c * 64, wrow, h, b);
    tma_store_commit();
  }
  if (t == 0) {
    float* lp = a.lse + ((long long)b * a.N + h) * a.Sq;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row < a.Sq)
        lp[row] = l[hr] > 0.f ? (m[hr] + log2f(l[hr])) * LN2 : 0.f;
    }
  }
  if ((threadIdx.x & 127) == 0) tma_store_wait_all();
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long (&st)[12], const Args& a, int Nkv,
           cudaStream_t stream) {
  alignas(64) CUtensorMap map_q, map_k, map_v, map_o;
  if (!make_bsnd_map(&map_q, q, DQK, a.Sq, a.N, a.B, st[1], st[2], st[0],
                     BM) ||
      !make_bsnd_map(&map_k, k, DQK, a.Skv, Nkv, a.B, st[4], st[5], st[3],
                     BN) ||
      !make_bsnd_map(&map_v, v, DV, a.Skv, Nkv, a.B, st[7], st[8], st[6],
                     BN) ||
      !make_bsnd_map(&map_o, o, DV, a.Sq, a.N, a.B, st[10], st[11], st[9],
                     64))
    return cudaErrorInvalidValue;
  constexpr int smem = Cfg<DQK, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tma_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.n_qt * a.N * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_tma_kernel<DQK, DV><<<(unsigned)blocks, THREADS, smem, stream>>>(
      map_q, map_k, map_v, map_o, a);
  return cudaGetLastError();
}

}  // namespace

// q [B, Sq, N, D], k [B, Skv, Nkv, D], v [B, Skv, Nkv, Dv], o [B, Sq, N, Dv],
// all bf16, given by element strides (the head dim contiguous; bases 16-byte
// aligned, strides multiples of 8 elements); lse [B, N, Sq] fp32; (D, Dv) is
// (64, 64), (128, 128) or (192, 128).
extern "C" int molly_flash_attention_fwd_tma(
    const void* q, const void* k, const void* v, const int32_t* mask, void* o,
    float* lse, int B, int N, int Nkv, int Sq, int Skv, int D, int Dv,
    long long q_sb,
    long long q_ss, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn, long long m_sb,
    long long m_ss, float scale, int causal, int q_offset, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sn, k_sb, k_ss, k_sn,
                            v_sb, v_ss, v_sn, o_sb, o_ss, o_sn};
  if (B <= 0 || N <= 0 || Nkv <= 0 || N % Nkv != 0 || Sq <= 0 || Skv <= 0 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorInvalidValue;
  for (long long x : st)
    if (x % 8 != 0 || x <= 0) return cudaErrorInvalidValue;
  Args a{mask,       lse,          B,      N,       N / Nkv, Sq,
         Skv,        (Sq + BM - 1) / BM, m_sb, m_ss, scale * LOG2E,
         causal,     q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && Dv == 64) return launch<64, 64>(q, k, v, o, st, a, Nkv, s);
  if (D == 128 && Dv == 128)
    return launch<128, 128>(q, k, v, o, st, a, Nkv, s);
  if (D == 192 && Dv == 128)
    return launch<192, 128>(q, k, v, o, st, a, Nkv, s);
  return cudaErrorInvalidValue;
}
