// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: molly_tpu/ops/flash_attention.py:_dq_kernel and :_dkv_kernel (the
// Pallas TPU kernels launched from _flash_bwd). Same semantics, FA2 style:
// P is RECOMPUTED as exp(S - LSE) from the forward's saved fp32 LSE (masked
// scores are the finite -1e30, never -inf), dS = P * (dO V^T - delta) with
// delta = rowsum(dO * O) handed in by the wrapper, P and dS are rounded to
// the storage dtype before their second product, the softmax scale multiplies
// the fp32 score product and once more dQ and dK at the end. GQA: kv head =
// q head / group, K/V never repeated.
//
// The Pallas split is kept because it needs no atomics and gives the same
// bits from run to run:
//   - flash_dq_kernel: one block per (batch, q head, 64-row q tile); loops
//     over the key tiles up to the causal limit; dQ accumulates in registers.
//   - flash_dkv_kernel: one block per (batch, kv head, 64-key tile); loops
//     over the q heads of the group and over the q tiles from the first
//     causal one; dK and dV accumulate in registers, so the sum over the
//     group and over q tiles never leaves the block.
// All tensors come with element strides (head dim contiguous), so the
// model's [B, S, N, D] activations, and dO with whatever strides autograd
// left it, are read in place.
//
// What bounds it on this card: the training shapes (S = 1024, D = 128) make
// 7 tile products of ~S^2 * D multiply-adds per head (3 in dQ, 4 in dK/dV,
// S recomputed in both) — far above the ops-per-byte ridge, so it is bound
// by operations, and only the tensor cores give those. Each of the two
// kernels therefore exists twice behind one entry point:
//   - bf16 with 16-byte-aligned rows (every call of the train step):
//     flash_dq_mma_kernel / flash_dkv_mma_kernel on mma.sync m16n8k16; see
//     the note above them.
//   - fp32, or unaligned bf16 views: flash_dq_kernel / flash_dkv_kernel on
//     the fp32 SIMT pipes, tiles staged in shared memory as fp32 and laid
//     out so that every inner step is a few 16-byte shared loads for 32
//     FMAs. Shared memory per block at D = 128: 187 KB (dQ), 172 KB (dK/dV)
//     of the 227 KB a block may opt into — one block per SM.
// Heavy tiles (most causal work) are scheduled first in all four. Not done
// yet: cp.async / TMA double-buffering of the tiles and Hopper's wgmma,
// which the card needs for its full bf16 rate.

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int THREADS = 256;
constexpr int PAD = 4;   // floats of padding per shared row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int32_t* mask;  // [B, Skv] (strided) or null
  const float* lse;     // [B, N, Sq]
  const float* delta;   // [B, N, Sq]
  void* out1;           // dQ, or dK
  void* out2;           // unused, or dV
  int N, group, Sq, Skv;
  long long q_sb, q_ss, q_sn;  // element strides; the head dim is contiguous
  long long k_sb, k_ss, k_sn;
  long long v_sb, v_ss, v_sn;
  long long g_sb, g_ss, g_sn;    // dO
  long long o1_sb, o1_ss, o1_sn;
  long long o2_sb, o2_ss, o2_sn;
  long long m_sb, m_ss;
  float scale, scale_log2;
  int causal, q_offset;
};

// value as the storage dtype would hold it (P and dS before their second
// product)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return molly::to_float(molly::from_float<T>(x));
}

// src rows [row0, row0 + 64) x [0, D) -> dst[r][d] (row stride RS), rows past
// n_rows zero
template <typename T, int D, int RS>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows, int tid) {
  for (int idx = tid; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int gi = row0 + r;
    dst[r * RS + d] =
        gi < n_rows ? molly::to_float(src[gi * row_stride + d]) : 0.f;
  }
}

// src rows [row0, row0 + 64) x [0, D) -> dst[d][r] (row stride TS)
template <typename T, int D, int TS>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src,
                                            long long row_stride, int row0,
                                            int n_rows, int tid) {
  for (int idx = tid; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int gi = row0 + r;
    dst[d * TS + r] =
        gi < n_rows ? molly::to_float(src[gi * row_stride + d]) : 0.f;
  }
}

// The first stage both kernels share. Thread (ty, tx) owns query rows
// ty*4 .. +3 and keys tx*4 .. +3 of a 64 x 64 tile:
//   s[i][j]  = sum_d Q[ty*4+i][d]  * K[tx*4+j][d]
//   dp[i][j] = sum_d dO[ty*4+i][d] * V[tx*4+j][d]
// Qs / dOs are row-major [64][RS]; Kt / Vt transposed [D][TS].
template <int D, int RS, int TS>
__device__ __forceinline__ void scores_and_dp(const float* Qs, const float* dOs,
                                              const float* Kt, const float* Vt,
                                              int ty, int tx, float (&s)[4][4],
                                              float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float qa[4][4], ga[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 qv =
          *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * RS + d]);
      const float4 gv =
          *reinterpret_cast<const float4*>(&dOs[(ty * 4 + i) * RS + d]);
      qa[i][0] = qv.x; qa[i][1] = qv.y; qa[i][2] = qv.z; qa[i][3] = qv.w;
      ga[i][0] = gv.x; ga[i][1] = gv.y; ga[i][2] = gv.z; ga[i][3] = gv.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 kv =
          *reinterpret_cast<const float4*>(&Kt[(d + e) * TS + tx * 4]);
      const float4 vv =
          *reinterpret_cast<const float4*>(&Vt[(d + e) * TS + tx * 4]);
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i][e], ka[j], s[i][j]);
          dp[i][j] = fmaf(ga[i][e], va[j], dp[i][j]);
        }
    }
  }
}

// s, dp -> p (in s) and ds (in dp), both rounded to the storage dtype.
// lse2[i] is LSE * log2(e) of row ty*4+i; a row past Sq or a key that is
// masked, past Skv or above the diagonal scores the finite NEG_INF.
template <typename T>
__device__ __forceinline__ void probs_and_ds(const BwdArgs& a, int q0, int k0,
                                             int ty, int tx,
                                             const bool (&col_ok)[4],
                                             const float (&lse2)[4],
                                             const float (&dl)[4],
                                             float (&s)[4][4],
                                             float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    const int q_pos = a.q_offset + qi;
    const bool row_ok = qi < a.Sq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = row_ok && col_ok[j] &&
                      (!a.causal || q_pos >= k0 + tx * 4 + j);
      const float sv = ok ? s[i][j] * a.scale_log2 : NEG_INF;
      const float p = exp2f(sv - lse2[i]);
      s[i][j] = round_to<T>(p);
      dp[i][j] = round_to<T>(p * (dp[i][j] - dl[i]));
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * BQ * (D + PAD) + 2 * D * (BK + PAD) + BK * D + BK * (BQ + PAD);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = D + PAD;
  constexpr int TS = BK + PAD;
  constexpr int NC = D / 64;  // 4-wide output column groups per thread
  float* Qs = smem;            // [BQ][RS]
  float* dOs = Qs + BQ * RS;   // [BQ][RS]
  float* Kt = dOs + BQ * RS;   // [D][TS]   k tile, transposed
  float* Vt = Kt + D * TS;     // [D][TS]   v tile, transposed
  float* Ks = Vt + D * TS;     // [BK][D]   k tile, row-major
  float* dSt = Ks + BK * D;    // [BK][TS]  dS, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // the last q tiles see the most keys under the causal mask: run them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sn;
  const T* gp = static_cast<const T*>(a.dout) + b * a.g_sb + h * a.g_sn;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sn;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sn;
  const int32_t* mp = a.mask ? a.mask + b * a.m_sb : nullptr;
  const float* lsep = a.lse + ((long long)b * a.N + h) * a.Sq;
  const float* deltap = a.delta + ((long long)b * a.N + h) * a.Sq;

  load_rows<T, D, RS>(Qs, qp, a.q_ss, q0, a.Sq, tid);
  load_rows<T, D, RS>(dOs, gp, a.g_ss, q0, a.Sq, tid);
  float lse2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    lse2[i] = qi < a.Sq ? lsep[qi] * LOG2E : 0.f;
    dl[i] = qi < a.Sq ? deltap[qi] : 0.f;
  }

  const int n_tiles = (a.Skv + BK - 1) / BK;
  int n_visit = n_tiles;
  if (a.causal) {  // keys any row of this block may see: < q_offset + q0 + BQ
    const long long max_kv = (long long)a.q_offset + q0 + BQ;
    n_visit = (int)min((long long)n_tiles, (max_kv + BK - 1) / BK);
  }

  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_visit; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of Kt / Vt / Ks / dSt are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int kj = k0 + r;
      const bool in = kj < a.Skv;
      const float kval = in ? molly::to_float(kp[kj * a.k_ss + d]) : 0.f;
      Kt[d * TS + r] = kval;
      Ks[r * D + d] = kval;
      Vt[d * TS + r] = in ? molly::to_float(vp[kj * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_and_dp<D, RS, TS>(Qs, dOs, Kt, Vt, ty, tx, s, dp);
    bool col_ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx * 4 + j;
      col_ok[j] = kj < a.Skv && (mp == nullptr || mp[kj * a.m_ss] != 0);
    }
    probs_and_ds<T>(a, q0, k0, ty, tx, col_ok, lse2, dl, s, dp);

#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dSt[(tx * 4 + j) * TS + ty * 4]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 dv4 = *reinterpret_cast<const float4*>(&dSt[kk * TS + ty * 4]);
      const float da[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&Ks[kk * D + c * 64 + tx * 4]);
        const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][c * 4 + j] = fmaf(da[i], ka[j], acc[i][c * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= a.Sq) continue;
    T* op = static_cast<T*>(a.out1) + b * a.o1_sb + h * a.o1_sn + qi * a.o1_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        op[c * 64 + tx * 4 + j] =
            molly::from_float<T>(acc[i][c * 4 + j] * a.scale);
  }
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * D * (BK + PAD) + 2 * BQ * (D + PAD) + 2 * BQ * (BK + PAD);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = D + PAD;
  constexpr int TS = BK + PAD;
  constexpr int NC = D / 64;
  float* Kt = smem;            // [D][TS]   k tile, transposed
  float* Vt = Kt + D * TS;     // [D][TS]   v tile, transposed
  float* Qs = Vt + D * TS;     // [BQ][RS]
  float* dOs = Qs + BQ * RS;   // [BQ][RS]
  float* Ps = dOs + BQ * RS;   // [BQ][TS]  P, row-major
  float* dSs = Ps + BQ * TS;   // [BQ][TS]  dS, row-major

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // block x = 0 is the first key tile, which every q tile sees under the
  // causal mask: the heaviest blocks are already scheduled first
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y, b = blockIdx.z;

  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sn;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sn;
  const int32_t* mp = a.mask ? a.mask + b * a.m_sb : nullptr;

  load_rows_t<T, D, TS>(Kt, kp, a.k_ss, k0, a.Skv, tid);
  load_rows_t<T, D, TS>(Vt, vp, a.v_ss, k0, a.Skv, tid);
  bool col_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k0 + tx * 4 + j;
    col_ok[j] = kj < a.Skv && (mp == nullptr || mp[kj * a.m_ss] != 0);
  }

  const int n_q_tiles = (a.Sq + BQ - 1) / BQ;
  int first_q = 0;
  if (a.causal) first_q = max((k0 - a.q_offset) / BQ, 0);

  // thread (ty, tx) owns keys ty*4 .. +3 and columns c*64 + tx*4 .. +3
  float dk[4][4 * NC], dv[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  for (int g = 0; g < a.group; ++g) {
    const int h = kvh * a.group + g;
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sn;
    const T* gp = static_cast<const T*>(a.dout) + b * a.g_sb + h * a.g_sn;
    const float* lsep = a.lse + ((long long)b * a.N + h) * a.Sq;
    const float* deltap = a.delta + ((long long)b * a.N + h) * a.Sq;

    for (int iq = first_q; iq < n_q_tiles; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();  // the previous tile's reads of Qs / dOs / Ps / dSs
      load_rows<T, D, RS>(Qs, qp, a.q_ss, q0, a.Sq, tid);
      load_rows<T, D, RS>(dOs, gp, a.g_ss, q0, a.Sq, tid);
      float lse2[4], dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        lse2[i] = qi < a.Sq ? lsep[qi] * LOG2E : 0.f;
        dl[i] = qi < a.Sq ? deltap[qi] : 0.f;
      }
      __syncthreads();  // also covers the K / V tile on the first pass

      float s[4][4], dp[4][4];
      scores_and_dp<D, RS, TS>(Qs, dOs, Kt, Vt, ty, tx, s, dp);
      probs_and_ds<T>(a, q0, k0, ty, tx, col_ok, lse2, dl, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * TS + tx * 4]) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        *reinterpret_cast<float4*>(&dSs[(ty * 4 + i) * TS + tx * 4]) =
            make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(&Ps[r * TS + ty * 4]);
        const float4 d4 = *reinterpret_cast<const float4*>(&dSs[r * TS + ty * 4]);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
        const float da[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 g4 =
              *reinterpret_cast<const float4*>(&dOs[r * RS + c * 64 + tx * 4]);
          const float4 q4 =
              *reinterpret_cast<const float4*>(&Qs[r * RS + c * 64 + tx * 4]);
          const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
          const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dv[i][c * 4 + j] = fmaf(pa[i], ga[j], dv[i][c * 4 + j]);
              dk[i][c * 4 + j] = fmaf(da[i], qa[j], dk[i][c * 4 + j]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= a.Skv) continue;
    T* dkp =
        static_cast<T*>(a.out1) + b * a.o1_sb + kvh * a.o1_sn + kj * a.o1_ss;
    T* dvp =
        static_cast<T*>(a.out2) + b * a.o2_sb + kvh * a.o2_sn + kj * a.o2_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dkp[c * 64 + tx * 4 + j] =
            molly::from_float<T>(dk[i][c * 4 + j] * a.scale);
        dvp[c * 64 + tx * 4 + j] = molly::from_float<T>(dv[i][c * 4 + j]);
      }
  }
}

template <typename T, int D>
int launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
  const int smem = dq_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.N, B);
  flash_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const BwdArgs& a, int B, cudaStream_t stream) {
  const int smem = dkv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + BK - 1) / BK, a.N / a.group, B);
  flash_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 path on the tensor cores: the same two kernels on mma.sync m16n8k16
// (bf16 operands, fp32 accumulators), 4 warps per block, each owning 16 rows
// of the block's tile. As in the forward kernel, the accumulators of the
// first products (S and dP) are, pair of 8-wide tiles by pair, exactly the
// A fragment of the second product, so P and dS go from registers to the
// tensor cores (rounded to bf16 on the way, as the Pallas kernels cast them)
// without a trip through shared memory.
//   - flash_dq_mma_kernel: a warp owns 16 QUERY rows. Q and dO fragments stay
//     in registers for the whole key loop; S = Q K^T and dP = dO V^T read K
//     and V row-major from shared memory; dQ += dS K reads K transposed.
//   - flash_dkv_mma_kernel: a warp owns 16 KEY rows and works on the
//     transposed problem, S^T = K Q^T and dP^T = V dO^T (K, V row-major as
//     the A operand; Q, dO row-major as the B operand), so that P^T and dS^T
//     are the A operands of dV += P^T dO and dK += dS^T Q, which read dO and
//     Q transposed. The dK and dV accumulators (2 x 64 registers a thread at
//     D = 128) are why K and V fragments are re-read from shared memory
//     instead of being held in registers.
// Shared rows are padded by 8 elements, so fragment reads hit 32 distinct
// banks. Needs 16-byte-aligned rows (strides a multiple of 8 elements);
// anything else, and fp32, takes the SIMT kernels above.
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;
constexpr int SPAD = 8;  // bf16 padding of a shared row

// rows [row0, row0 + 64) x [0, D) of a strided bf16 tensor -> dst[r][d]
// (row stride D + SPAD), 16 bytes a thread, rows past n_rows zero
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int row0,
                                           int n_rows, int tid) {
  constexpr int DT = D / 8, QS = D + SPAD;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < 64 * DT; idx += MMA_THREADS) {
    const int r = idx / DT, c = (idx % DT) * 8;
    const int gi = row0 + r;
    *reinterpret_cast<uint4*>(&dst[r * QS + c]) =
        gi < n_rows
            ? *reinterpret_cast<const uint4*>(src + gi * row_stride + c)
            : zero4;
  }
}

// the same rows transposed: dst[d][r] (row stride 64 + SPAD)
template <int D>
__device__ __forceinline__ void stage_rows_t(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             long long row_stride, int row0,
                                             int n_rows, int tid) {
  constexpr int DT = D / 8, TS = 64 + SPAD;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < 64 * DT; idx += MMA_THREADS) {
    const int r = idx % 64, c = (idx / 64) * 8;  // lanes along the rows
    const int gi = row0 + r;
    uint4 raw = gi < n_rows ? *reinterpret_cast<const uint4*>(
                                  src + gi * row_stride + c)
                            : zero4;
    const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * TS + r] = e8[i];
  }
}

// the A fragment of k-step kk from the accumulators of 8-wide tiles 2kk and
// 2kk + 1, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&pa)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  pa[0] = molly::pack_bf16(lo[0], lo[1]);
  pa[1] = molly::pack_bf16(lo[2], lo[3]);
  pa[2] = molly::pack_bf16(hi[0], hi[1]);
  pa[3] = molly::pack_bf16(hi[2], hi[3]);
}

template <int D>
constexpr int dq_mma_smem_bytes() {
  return (int)sizeof(__nv_bfloat16) *
             (2 * BK * (D + SPAD) + D * (BK + SPAD)) +
         BK * (int)sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_dq_mma_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int QS = D + SPAD;   // row stride of Ks / Vs
  constexpr int TS = BK + SPAD;  // row stride of Kt
  constexpr int KSTEPS = D / 16;
  constexpr int DT = D / 8;
  using bf16 = __nv_bfloat16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][QS]; first holds Q
  bf16* Vs = Ks + BK * QS;                       // [BK][QS]; first holds dO
  bf16* Kt = Vs + BK * QS;                       // [D][TS]: k tile, transposed
  int* Ms = reinterpret_cast<int*>(Kt + D * TS);  // key validity of the tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sn;
  const bf16* gp = static_cast<const bf16*>(a.dout) + b * a.g_sb + h * a.g_sn;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sn;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sn;
  const int32_t* mp = a.mask ? a.mask + b * a.m_sb : nullptr;
  const float* lsep = a.lse + ((long long)b * a.N + h) * a.Sq;
  const float* deltap = a.delta + ((long long)b * a.N + h) * a.Sq;

  // Q and dO fragments of this warp's 16 rows, for the whole key loop
  stage_rows<D>(Ks, qp, a.q_ss, q0, a.Sq, tid);
  stage_rows<D>(Vs, gp, a.g_ss, q0, a.Sq, tid);
  __syncthreads();
  uint32_t qa[KSTEPS][4], ga[KSTEPS][4];
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    qa[ks][0] = molly::ld32(&Ks[r0 * QS + ks * 16 + t * 2]);
    qa[ks][1] = molly::ld32(&Ks[(r0 + 8) * QS + ks * 16 + t * 2]);
    qa[ks][2] = molly::ld32(&Ks[r0 * QS + ks * 16 + 8 + t * 2]);
    qa[ks][3] = molly::ld32(&Ks[(r0 + 8) * QS + ks * 16 + 8 + t * 2]);
    ga[ks][0] = molly::ld32(&Vs[r0 * QS + ks * 16 + t * 2]);
    ga[ks][1] = molly::ld32(&Vs[(r0 + 8) * QS + ks * 16 + t * 2]);
    ga[ks][2] = molly::ld32(&Vs[r0 * QS + ks * 16 + 8 + t * 2]);
    ga[ks][3] = molly::ld32(&Vs[(r0 + 8) * QS + ks * 16 + 8 + t * 2]);
  }
  float lse2[2], dl[2];
  bool row_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + hr * 8;
    row_ok[hr] = qi < a.Sq;
    lse2[hr] = row_ok[hr] ? lsep[qi] * LOG2E : 0.f;
    dl[hr] = row_ok[hr] ? deltap[qi] : 0.f;
  }

  const int n_tiles = (a.Skv + BK - 1) / BK;
  int n_visit = n_tiles;
  if (a.causal) {
    const long long max_kv = (long long)a.q_offset + q0 + BQ;
    n_visit = (int)min((long long)n_tiles, (max_kv + BK - 1) / BK);
  }

  float dq[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const int qpos0 = a.q_offset + q0 + r0;

  for (int tile = 0; tile < n_visit; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous reads of Ks / Vs / Kt / Ms are done
    stage_rows<D>(Ks, kp, a.k_ss, k0, a.Skv, tid);
    stage_rows<D>(Vs, vp, a.v_ss, k0, a.Skv, tid);
    stage_rows_t<D>(Kt, kp, a.k_ss, k0, a.Skv, tid);
    if (tid < BK) {
      const int kj = k0 + tid;
      Ms[tid] = kj < a.Skv && (mp == nullptr || mp[kj * a.m_ss] != 0);
    }
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int off = (j * 8 + g) * QS + ks * 16 + t * 2;
        molly::mma_bf16(s[j], qa[ks], molly::ld32(&Ks[off]),
                        molly::ld32(&Ks[off + 8]));
        molly::mma_bf16(dp[j], ga[ks], molly::ld32(&Vs[off]),
                        molly::ld32(&Vs[off + 8]));
      }
    }

    // dS into s; element e of tile j is row r0 + 8*(e >= 2), key
    // k0 + j*8 + t*2 + (e & 1)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const int hr = e >> 1;
        const bool ok = row_ok[hr] && Ms[col] &&
                        (!a.causal || qpos0 + hr * 8 >= k0 + col);
        const float sv = ok ? s[j][e] * a.scale_log2 : NEG_INF;
        const float p = exp2f(sv - lse2[hr]);
        s[j][e] = p * (dp[j][e] - dl[hr]);
      }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int off = (j * 8 + g) * TS + kk * 16 + t * 2;
        molly::mma_bf16(dq[j], da, molly::ld32(&Kt[off]),
                        molly::ld32(&Kt[off + 8]));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + hr * 8;
    if (qi >= a.Sq) continue;
    bf16* op =
        static_cast<bf16*>(a.out1) + b * a.o1_sb + h * a.o1_sn + qi * a.o1_ss;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(&op[j * 8 + t * 2]) =
          __floats2bfloat162_rn(dq[j][2 * hr] * a.scale,
                                dq[j][2 * hr + 1] * a.scale);
  }
}

template <int D>
constexpr int dkv_mma_smem_bytes() {
  return (int)sizeof(__nv_bfloat16) *
             (4 * 64 * (D + SPAD) + 2 * D * (64 + SPAD)) +
         2 * BQ * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_dkv_mma_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int QS = D + SPAD;   // row stride of the row-major tiles
  constexpr int TS = BQ + SPAD;  // row stride of the transposed tiles
  constexpr int KSTEPS = D / 16;
  constexpr int DT = D / 8;
  using bf16 = __nv_bfloat16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][QS]
  bf16* Vs = Ks + BK * QS;                       // [BK][QS]
  bf16* Qs = Vs + BK * QS;                       // [BQ][QS]
  bf16* Gs = Qs + BQ * QS;                       // [BQ][QS]  dO
  bf16* Qt = Gs + BQ * QS;                       // [D][TS]   q, transposed
  bf16* Gt = Qt + D * TS;                        // [D][TS]   dO, transposed
  float* Ls = reinterpret_cast<float*>(Gt + D * TS);  // [BQ] LSE * log2(e)
  float* Dl = Ls + BQ;                                // [BQ] delta

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;  // the first key tile is the heaviest
  const int kvh = blockIdx.y, b = blockIdx.z;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sn;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sn;
  const int32_t* mp = a.mask ? a.mask + b * a.m_sb : nullptr;

  stage_rows<D>(Ks, kp, a.k_ss, k0, a.Skv, tid);
  stage_rows<D>(Vs, vp, a.v_ss, k0, a.Skv, tid);
  const int kr0 = warp * 16 + g;  // this thread's keys: kr0 and kr0 + 8
  bool key_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = k0 + kr0 + hr * 8;
    key_ok[hr] = kj < a.Skv && (mp == nullptr || mp[kj * a.m_ss] != 0);
  }

  const int n_q_tiles = (a.Sq + BQ - 1) / BQ;
  int first_q = 0;
  if (a.causal) first_q = max((k0 - a.q_offset) / BQ, 0);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.f;
      dv[j][e] = 0.f;
    }

  for (int gi = 0; gi < a.group; ++gi) {
    const int h = kvh * a.group + gi;
    const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sn;
    const bf16* gp =
        static_cast<const bf16*>(a.dout) + b * a.g_sb + h * a.g_sn;
    const float* lsep = a.lse + ((long long)b * a.N + h) * a.Sq;
    const float* deltap = a.delta + ((long long)b * a.N + h) * a.Sq;

    for (int iq = first_q; iq < n_q_tiles; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();  // the previous tile's reads are done
      stage_rows<D>(Qs, qp, a.q_ss, q0, a.Sq, tid);
      stage_rows<D>(Gs, gp, a.g_ss, q0, a.Sq, tid);
      stage_rows_t<D>(Qt, qp, a.q_ss, q0, a.Sq, tid);
      stage_rows_t<D>(Gt, gp, a.g_ss, q0, a.Sq, tid);
      if (tid < BQ) {
        const int qi = q0 + tid;
        Ls[tid] = qi < a.Sq ? lsep[qi] * LOG2E : 0.f;
        Dl[tid] = qi < a.Sq ? deltap[qi] : 0.f;
      }
      __syncthreads();  // also covers the K / V tile on the first pass

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries a warp
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0.f;
          dpt[j][e] = 0.f;
        }
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int ao = kr0 * QS + ks * 16 + t * 2;
        const uint32_t ka[4] = {
            molly::ld32(&Ks[ao]), molly::ld32(&Ks[ao + 8 * QS]),
            molly::ld32(&Ks[ao + 8]), molly::ld32(&Ks[ao + 8 * QS + 8])};
        const uint32_t va[4] = {
            molly::ld32(&Vs[ao]), molly::ld32(&Vs[ao + 8 * QS]),
            molly::ld32(&Vs[ao + 8]), molly::ld32(&Vs[ao + 8 * QS + 8])};
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int off = (j * 8 + g) * QS + ks * 16 + t * 2;
          molly::mma_bf16(st[j], ka, molly::ld32(&Qs[off]),
                          molly::ld32(&Qs[off + 8]));
          molly::mma_bf16(dpt[j], va, molly::ld32(&Gs[off]),
                          molly::ld32(&Gs[off + 8]));
        }
      }

      // P^T into st, dS^T into dpt; element e of tile j is key
      // k0 + kr0 + 8*(e >= 2), query q0 + j*8 + t*2 + (e & 1)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + t * 2 + (e & 1);
          const int hr = e >> 1;
          const int qi = q0 + qc;
          const bool ok = key_ok[hr] && qi < a.Sq &&
                          (!a.causal ||
                           a.q_offset + qi >= k0 + kr0 + hr * 8);
          const float sv = ok ? st[j][e] * a.scale_log2 : NEG_INF;
          const float p = exp2f(sv - Ls[qc]);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Dl[qc]);
        }

      // dV += P^T dO, dK += dS^T Q (the k dimension is the 64 queries)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const int off = (j * 8 + g) * TS + kk * 16 + t * 2;
          molly::mma_bf16(dv[j], pa, molly::ld32(&Gt[off]),
                          molly::ld32(&Gt[off + 8]));
          molly::mma_bf16(dk[j], da, molly::ld32(&Qt[off]),
                          molly::ld32(&Qt[off + 8]));
        }
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = k0 + kr0 + hr * 8;
    if (kj >= a.Skv) continue;
    bf16* dkp =
        static_cast<bf16*>(a.out1) + b * a.o1_sb + kvh * a.o1_sn + kj * a.o1_ss;
    bf16* dvp =
        static_cast<bf16*>(a.out2) + b * a.o2_sb + kvh * a.o2_sn + kj * a.o2_ss;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(&dkp[j * 8 + t * 2]) =
          __floats2bfloat162_rn(dk[j][2 * hr] * a.scale,
                                dk[j][2 * hr + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(&dvp[j * 8 + t * 2]) =
          __floats2bfloat162_rn(dv[j][2 * hr], dv[j][2 * hr + 1]);
    }
  }
}

template <int D>
int launch_dq_mma(const BwdArgs& a, int B, cudaStream_t stream) {
  const int smem = dq_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.N, B);
  flash_dq_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const BwdArgs& a, int B, cudaStream_t stream) {
  const int smem = dkv_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + BK - 1) / BK, a.N / a.group, B);
  flash_dkv_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the mma kernels move 16-byte vectors in and 4-byte pairs out: every
// tensor's rows must start 16-byte aligned (strides a multiple of 8 bf16)
bool vector_aligned(const BwdArgs& a) {
  auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const long long st[] = {a.q_sb,  a.q_ss,  a.q_sn,  a.k_sb,  a.k_ss,  a.k_sn,
                          a.v_sb,  a.v_ss,  a.v_sn,  a.g_sb,  a.g_ss,  a.g_sn,
                          a.o1_sb, a.o1_ss, a.o1_sn, a.o2_sb, a.o2_ss, a.o2_sn};
  for (long long x : st)
    if (x % 8 != 0) return false;
  return al(a.q) && al(a.k) && al(a.v) && al(a.dout) && al(a.out1) &&
         al(a.out2);
}

// strides: 20 element strides in the order q, k, v, dO, out1, out2 (batch,
// sequence, head each) and the mask's (batch, key)
BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const int32_t* mask, const float* lse, const float* delta,
                  void* out1, void* out2, int N, int Nkv, int Sq, int Skv,
                  const long long* st, float scale, int causal, int q_offset) {
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask;
  a.lse = lse; a.delta = delta; a.out1 = out1; a.out2 = out2;
  a.N = N; a.group = N / Nkv; a.Sq = Sq; a.Skv = Skv;
  a.q_sb = st[0]; a.q_ss = st[1]; a.q_sn = st[2];
  a.k_sb = st[3]; a.k_ss = st[4]; a.k_sn = st[5];
  a.v_sb = st[6]; a.v_ss = st[7]; a.v_sn = st[8];
  a.g_sb = st[9]; a.g_ss = st[10]; a.g_sn = st[11];
  a.o1_sb = st[12]; a.o1_ss = st[13]; a.o1_sn = st[14];
  a.o2_sb = st[15]; a.o2_ss = st[16]; a.o2_sn = st[17];
  a.m_sb = st[18]; a.m_ss = st[19];
  a.scale = scale; a.scale_log2 = scale * LOG2E;
  a.causal = causal; a.q_offset = q_offset;
  return a;
}

}  // namespace

// q, dO, dQ [B, Sq, N, D]; k, v [B, Skv, Nkv, D]; lse, delta [B, N, Sq] fp32
// contiguous; every other tensor by the element strides in `strides` (see
// make_args; the out2 entries are unused here).
extern "C" int molly_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const int32_t* mask, const float* lse, const float* delta, void* dq,
    int B, int N, int Nkv, int Sq, int Skv, int D, int dtype,
    const long long* strides, float scale, int causal, int q_offset,
    void* stream) {
  if (Nkv <= 0 || N % Nkv != 0 || Sq <= 0 || Skv <= 0)
    return cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, dout, mask, lse, delta, dq, nullptr, N,
                              Nkv, Sq, Skv, strides, scale, causal, q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == molly::kBFloat16) {
    const bool mma = vector_aligned(a);
    if (D == 64)
      return mma ? launch_dq_mma<64>(a, B, s)
                 : launch_dq<__nv_bfloat16, 64>(a, B, s);
    if (D == 128)
      return mma ? launch_dq_mma<128>(a, B, s)
                 : launch_dq<__nv_bfloat16, 128>(a, B, s);
  } else if (dtype == molly::kFloat32) {
    if (D == 64) return launch_dq<float, 64>(a, B, s);
    if (D == 128) return launch_dq<float, 128>(a, B, s);
  }
  return cudaErrorInvalidValue;
}

// as above; dk, dv [B, Skv, Nkv, D] by the out1 / out2 strides.
extern "C" int molly_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const int32_t* mask, const float* lse, const float* delta, void* dk,
    void* dv, int B, int N, int Nkv, int Sq, int Skv, int D, int dtype,
    const long long* strides, float scale, int causal, int q_offset,
    void* stream) {
  if (Nkv <= 0 || N % Nkv != 0 || Sq <= 0 || Skv <= 0)
    return cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, dout, mask, lse, delta, dk, dv, N, Nkv,
                              Sq, Skv, strides, scale, causal, q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == molly::kBFloat16) {
    const bool mma = vector_aligned(a);
    if (D == 64)
      return mma ? launch_dkv_mma<64>(a, B, s)
                 : launch_dkv<__nv_bfloat16, 64>(a, B, s);
    if (D == 128)
      return mma ? launch_dkv_mma<128>(a, B, s)
                 : launch_dkv<__nv_bfloat16, 128>(a, B, s);
  } else if (dtype == molly::kFloat32) {
    if (D == 64) return launch_dkv<float, 64>(a, B, s);
    if (D == 128) return launch_dkv<float, 128>(a, B, s);
  }
  return cudaErrorInvalidValue;
}
