// Flash-attention forward, SIMT fp32 math: fp32 operands and bf16 views
// whose rows are not 16-byte aligned. Aligned bf16 (every main-path call)
// runs on flash_attention_fwd_tma.cu; ops/flash_attention.py:fwd_takes_tma
// is the rule.
//
// Replaces: molly_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas TPU
// kernel launched from _flash_fwd). Same semantics: online softmax in fp32,
// GQA as kv head = h / (N / Nkv) with no repeated K/V, an optional [B, Skv]
// int mask, causal masking with a static q_offset that skips key tiles lying
// wholly above the diagonal, the kv_len guard on the ragged tail, an O output
// in the input dtype and an fp32 LSE [B, N, Sq] for the backward pass.
// Masked scores are a finite -1e30; a query row with no valid key (the
// left-padded prompt rows) gets O = 0 and LSE = 0, as on the TMA kernel.
//
// What bounds it on this card: ~S^2 * D multiply-adds per head on the fp32
// pipes (67 TFLOP/s), far above the ops-per-byte ridge. One block per
// (b, h, 64-row q tile) taking strides, so the head-major [B, Nkv, Smax,
// 2*Dh] KV cache is read in place with no transpose; tiles are staged as
// fp32 in shared memory, q and k transposed so an inner-product step is two
// 16-byte shared loads for 16 FMAs.

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
    const bool no_key = m[i] == NEG_INF;  // every visited key was masked
    const float inv = no_key ? 0.f : 1.f / l[i];
    T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sn + qi * a.o_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        op[c * 64 + tx * 4 + j] = molly::from_float<T>(acc[i][c * 4 + j] * inv);
    if (tx == 0)
      a.lse[((long long)b * a.N + h) * a.Sq + qi] =
          no_key ? 0.f : (m[i] + log2f(l[i])) * LN2;
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
    if (D == 64) return launch<__nv_bfloat16, 64>(a, B, s);
    if (D == 128) return launch<__nv_bfloat16, 128>(a, B, s);
  } else if (dtype == molly::kFloat32) {
    if (D == 64) return launch<float, 64>(a, B, s);
    if (D == 128) return launch<float, 128>(a, B, s);
  }
  return cudaErrorInvalidValue;
}
