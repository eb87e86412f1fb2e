// Flash-attention forward for Hopper (sm_90a), SIMT fp32 math.
//
// Replaces: molly_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas TPU
// kernel launched from _flash_fwd). Same semantics: online softmax in fp32,
// GQA as kv head = h / (N / Nkv) with no repeated K/V, an optional [B, Skv]
// int mask, causal masking with a static q_offset that skips key tiles lying
// wholly above the diagonal, the kv_len guard on the ragged tail, an O output
// in the input dtype and an fp32 LSE [B, N, Sq] for the backward pass.
// Masked scores are a finite -1e30 (not -inf) and the row sum is clamped as
// in the Pallas kernel's l_safe, so a query row with no valid key (the
// left-padded prompt rows) comes out finite instead of NaN.
//
// What bounds it on this card: at the main-path shapes (decoder prefill
// Sq = 3072 over a 3136-key cache, D = 128; encoders S = 1024, D = 64) the
// work is ~S^2 * D multiply-adds per head, far above the card's
// ops-per-byte ridge, so it is compute-bound, and only the tensor cores
// give that compute. Two kernels share the entry point, both one block per
// (b, h, 64-row q tile), both taking strides so the head-major
// [B, Nkv, Smax, 2*Dh] KV cache is read in place with no transpose:
//   - bf16 with 16-byte-aligned rows (every main-path call):
//     flash_fwd_mma_kernel, FlashAttention-2 on mma.sync m16n8k16 — four
//     warps of 16 query rows, q fragments held in registers, k and v tiles
//     staged in padded shared memory, scores and output kept in the mma
//     accumulator layout so the online softmax never leaves registers.
//   - fp32, or unaligned bf16 views: flash_fwd_kernel, the same algorithm
//     on the fp32 SIMT pipes (tiles staged as fp32, q and k transposed so
//     an inner-product step is two 16-byte shared loads for 16 FMAs).
// Not done yet: cp.async / TMA double-buffering of the k/v tiles and
// Hopper's wgmma, which the card needs for its full bf16 rate.

#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256;
constexpr int PAD = 4;       // padding (floats) of transposed tile rows
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;  // [B, Skv] (strided) or null
  void* o;
  float* lse;           // [B, N, Sq]
  int N, group, Sq, Skv;
  long long q_sb, q_ss, q_sn;  // element strides; the head dim is contiguous
  long long k_sb, k_ss, k_sn;
  long long v_sb, v_ss, v_sn;
  long long o_sb, o_ss, o_sn;
  long long m_sb, m_ss;
  float scale_log2;  // softmax scale * log2(e): scores live in base 2
  int causal, q_offset;
};

template <int D>
constexpr int smem_floats() {
  return D * (BQ + PAD) + D * (BK + PAD) + BK * D + BK * (BQ + PAD);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [D][BQ + PAD]  q tile, transposed
  float* Kt = Qt + D * (BQ + PAD);  // [D][BK + PAD]  k tile, transposed
  float* Vs = Kt + D * (BK + PAD);  // [BK][D]        v tile
  float* Pt = Vs + BK * D;          // [BK][BQ + PAD] probabilities, transposed

  constexpr int NC = D / 64;  // 4-wide output column groups per thread
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key columns tx*4.., output columns c*64 + tx*4..
  const int ty = tid >> 4;  // query rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.group;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sn;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sn;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sn;
  const int32_t* mp = a.mask ? a.mask + b * a.m_sb : nullptr;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    Qt[d * (BQ + PAD) + r] =
        qi < a.Sq ? molly::to_float(qp[qi * a.q_ss + d]) : 0.f;
  }

  const int n_tiles = (a.Skv + BK - 1) / BK;
  int n_visit = n_tiles;
  if (a.causal) {  // keys any row of this block may see: < q_offset + q0 + BQ
    const long long max_kv = (long long)a.q_offset + q0 + BQ;
    n_visit = (int)min((long long)n_tiles, (max_kv + BK - 1) / BK);
  }

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_visit; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of Kt / Vs / Pt are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int kj = k0 + r;
      const bool in = kj < a.Skv;
      Kt[d * (BK + PAD) + r] = in ? molly::to_float(kp[kj * a.k_ss + d]) : 0.f;
      Vs[r * D + d] = in ? molly::to_float(vp[kj * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv =
          *reinterpret_cast<const float4*>(&Qt[d * (BQ + PAD) + ty * 4]);
      const float4 kv =
          *reinterpret_cast<const float4*>(&Kt[d * (BK + PAD) + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    bool col_ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx * 4 + j;
      col_ok[j] = kj < a.Skv && (mp == nullptr || mp[kj * a.m_ss] != 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = a.q_offset + q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = col_ok[j] && (!a.causal || q_pos >= k0 + tx * 4 + j);
        s[i][j] = ok ? s[i][j] * a.scale_log2 : NEG_INF;
      }
    }

    // online softmax; each row's 64 scores live in the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }

#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * (BQ + PAD) + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv =
          *reinterpret_cast<const float4*>(&Pt[kk * (BQ + PAD) + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[kk * D + c * 64 + tx * 4]);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][c * 4 + j] = fmaf(pa[i], va[j], acc[i][c * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= a.Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / l_safe;
    T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sn + qi * a.o_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        op[c * 64 + tx * 4 + j] = molly::from_float<T>(acc[i][c * 4 + j] * inv);
    if (tx == 0)
      a.lse[((long long)b * a.N + h) * a.Sq + qi] = (m[i] + log2f(l_safe)) * LN2;
  }
}

template <typename T, int D>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.N, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 path on the tensor cores: FlashAttention-2 style with mma.sync
// m16n8k16 (bf16 operands, fp32 accumulators). 4 warps per block, each
// owning 16 query rows of the 64-row tile; q fragments stay in registers for
// the whole key loop; k is staged row-major and v transposed in shared
// memory (rows padded by 8 elements, so fragment reads hit 32 distinct
// banks); S and O live in the mma accumulator layout, so the softmax runs in
// registers and P feeds the second product without a trip through shared
// memory (as the Pallas kernel casts p to v's dtype for its second dot).
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;
constexpr int SPAD = 8;  // bf16 padding of a shared row

template <int D>
constexpr int mma_smem_bytes() {
  return (int)sizeof(__nv_bfloat16) *
             (BQ * (D + SPAD) + BK * (D + SPAD) + D * (BK + SPAD)) +
         BK * (int)sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_mma_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int QS = D + SPAD;   // row stride of Qs / Ks (elements)
  constexpr int VS = BK + SPAD;  // row stride of Vt
  constexpr int KSTEPS = D / 16;
  constexpr int DT = D / 8;      // 8-wide output column tiles
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * QS;
  __nv_bfloat16* Vt = Ks + BK * QS;  // [D][BK + SPAD]: v tile, transposed
  int* Ms = reinterpret_cast<int*>(Vt + D * VS);  // key validity of the tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sn;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kvh * a.k_sn;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kvh * a.v_sn;
  const int32_t* mp = a.mask ? a.mask + b * a.m_sb : nullptr;

  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < BQ * DT; idx += MMA_THREADS) {
    const int r = idx / DT, c = (idx % DT) * 8;
    const int qi = q0 + r;
    *reinterpret_cast<uint4*>(&Qs[r * QS + c]) =
        qi < a.Sq ? *reinterpret_cast<const uint4*>(qp + qi * a.q_ss + c)
                  : zero4;
  }
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    qa[ks][0] = molly::ld32(&Qs[r0 * QS + ks * 16 + t * 2]);
    qa[ks][1] = molly::ld32(&Qs[(r0 + 8) * QS + ks * 16 + t * 2]);
    qa[ks][2] = molly::ld32(&Qs[r0 * QS + ks * 16 + 8 + t * 2]);
    qa[ks][3] = molly::ld32(&Qs[(r0 + 8) * QS + ks * 16 + 8 + t * 2]);
  }

  const int n_tiles = (a.Skv + BK - 1) / BK;
  int n_visit = n_tiles;
  if (a.causal) {
    const long long max_kv = (long long)a.q_offset + q0 + BQ;
    n_visit = (int)min((long long)n_tiles, (max_kv + BK - 1) / BK);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const int qpos0 = a.q_offset + q0 + r0;

  for (int tile = 0; tile < n_visit; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile's reads of Ks / Vt / Ms are done
    for (int idx = tid; idx < BK * DT; idx += MMA_THREADS) {
      const int r = idx / DT, c = (idx % DT) * 8;  // k: lanes along d
      const int kj = k0 + r;
      *reinterpret_cast<uint4*>(&Ks[r * QS + c]) =
          kj < a.Skv ? *reinterpret_cast<const uint4*>(kp + kj * a.k_ss + c)
                     : zero4;
    }
    for (int idx = tid; idx < BK * DT; idx += MMA_THREADS) {
      const int r = idx % BK, c = (idx / BK) * 8;  // v: lanes along keys
      const int kj = k0 + r;
      uint4 raw = kj < a.Skv
                      ? *reinterpret_cast<const uint4*>(vp + kj * a.v_ss + c)
                      : zero4;
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * VS + r] = e8[i];
    }
    if (tid < BK) {
      const int kj = k0 + tid;
      Ms[tid] = kj < a.Skv && (mp == nullptr || mp[kj * a.m_ss] != 0);
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        molly::mma_bf16(s[j], qa[ks],
                        molly::ld32(&Ks[(j * 8 + g) * QS + ks * 16 + t * 2]),
                        molly::ld32(&Ks[(j * 8 + g) * QS + ks * 16 + 8 + t * 2]));
    }

    // mask + scale; element e of tile j is row r0 + 8*(e >= 2), key
    // k0 + j*8 + t*2 + (e & 1)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const int q_pos = qpos0 + (e >> 1) * 8;
        const bool ok = Ms[col] && (!a.causal || q_pos >= k0 + col);
        s[j][e] = ok ? s[j][e] * a.scale_log2 : NEG_INF;
      }

    // online softmax for rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3); a row's
    // 64 scores live in the 4 lanes sharing g
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = exp2f(m[hr] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][2 * hr] = exp2f(s[j][2 * hr] - m_new);
        s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - m_new);
        rs += s[j][2 * hr] + s[j][2 * hr + 1];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[hr] = l[hr] * alpha + rs;
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][2 * hr] *= alpha;
        o[j][2 * hr + 1] *= alpha;
      }
    }

    // O += P V: the S accumulators of key tiles 2kk, 2kk+1 are exactly the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          molly::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          molly::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          molly::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          molly::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; ++j)
        molly::mma_bf16(o[j], pa,
                        molly::ld32(&Vt[(j * 8 + g) * VS + kk * 16 + t * 2]),
                        molly::ld32(&Vt[(j * 8 + g) * VS + kk * 16 + 8 + t * 2]));
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + hr * 8;
    if (qi >= a.Sq) continue;
    const float l_safe = fmaxf(l[hr], 1e-30f);
    const float inv = 1.f / l_safe;
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                        h * a.o_sn + qi * a.o_ss;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(&op[j * 8 + t * 2]) =
          __floats2bfloat162_rn(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
    if (t == 0)
      a.lse[((long long)b * a.N + h) * a.Sq + qi] =
          (m[hr] + log2f(l_safe)) * LN2;
  }
}

template <int D>
int launch_mma(const FlashArgs& a, int B, cudaStream_t stream) {
  const int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.N, B);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the mma path reads 16-byte vectors: every row start must be 16-byte
// aligned (8 bf16 elements) and the output rows 4-byte aligned
bool vector_aligned(const FlashArgs& a) {
  auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const long long st[] = {a.q_sb, a.q_ss, a.q_sn, a.k_sb, a.k_ss, a.k_sn,
                          a.v_sb, a.v_ss, a.v_sn, a.o_sb, a.o_ss, a.o_sn};
  for (long long x : st)
    if (x % 8 != 0) return false;
  return al(a.q) && al(a.k) && al(a.v) && al(a.o);
}

}  // namespace

// q [B, Sq, N, D], k/v [B, Skv, Nkv, D] given by element strides (the head
// dim must be contiguous); o has q's shape and dtype; lse is [B, N, Sq] fp32.
extern "C" int molly_flash_attention_fwd(
    const void* q, const void* k, const void* v, const int32_t* mask, void* o,
    float* lse, int B, int N, int Nkv, int Sq, int Skv, int D, int dtype,
    long long q_sb, long long q_ss, long long q_sn, long long k_sb,
    long long k_ss, long long k_sn, long long v_sb, long long v_ss,
    long long v_sn, long long o_sb, long long o_ss, long long o_sn,
    long long m_sb, long long m_ss, float scale, int causal, int q_offset,
    void* stream) {
  if (N % Nkv != 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  FlashArgs a{q,    k,    v,    mask, o,    lse,  N,    N / Nkv,
              Sq,   Skv,  q_sb, q_ss, q_sn, k_sb, k_ss, k_sn,
              v_sb, v_ss, v_sn, o_sb, o_ss, o_sn, m_sb, m_ss,
              scale * LOG2E,    causal, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == molly::kBFloat16) {
    const bool mma = vector_aligned(a);
    if (D == 64)
      return mma ? launch_mma<64>(a, B, s) : launch<__nv_bfloat16, 64>(a, B, s);
    if (D == 128)
      return mma ? launch_mma<128>(a, B, s)
                 : launch<__nv_bfloat16, 128>(a, B, s);
  } else if (dtype == molly::kFloat32) {
    if (D == 64) return launch<float, 64>(a, B, s);
    if (D == 128) return launch<float, 128>(a, B, s);
  }
  return cudaErrorInvalidValue;
}
