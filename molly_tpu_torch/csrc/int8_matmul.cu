// Int8 weight-only GEMM for Hopper (sm_90a): out = (x @ w_q) * scale.
//
// Replaces: molly_tpu/ops/quant.py:_kernel (the Pallas TPU kernel launched
// from int8_matmul). Same semantics: x [M, K] in bf16 or fp32 times int8
// w_q [K, N], products accumulated in fp32 from the activations as given
// (no bf16 rounding of x), the per-output-column fp32 scale applied once at
// the end, the output in x's dtype.
//
// What bounds it on this card: in the decode loop M is the batch (4), so
// the call streams K*N weight bytes for 2*M*K*N operations, far below the
// ops-per-byte ridge: it is bound by reading the int8 weights (half the
// bytes of bf16, which is the point of --int8). Under --int8 the prefill
// sends M = B*S (~12k rows) through the same call, and there it is
// compute-bound: bf16 x with more than 16 rows and aligned shapes runs on
// TMA and wgmma in int8_matmul_tma.cu (ops/quant.py:int8_takes_tma picks
// the source). Two kernels stay here, behind one entry point:
//   - M <= 16: a split-K weight stream (int8_gemv_kernel): 16-byte vector
//     loads of the weights, the activations in shared memory, enough K
//     chunks to fill every SM even when N is 2048, fp32 atomics into a
//     workspace and a small scale-and-cast pass;
//   - any other larger-M call (fp32 x, unaligned rows): a tiled SIMT GEMM
//     (int8_matmul_kernel), 64 x 64 output tiles staged as fp32, each of
//     the 256 threads owning a 4 x 4 block of outputs.
// Not done yet: the split-K stream on TMA with the reduction done without
// atomics, and int8 tensor-core products with the activations quantized (a
// different result).

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BKT = 32;
constexpr int THREADS = 256;
constexpr int TM = BM / 16;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int M, int N, int K) {
  __shared__ __align__(16) float Xs[BKT][BM + 4];  // x tile, transposed
  __shared__ __align__(16) float Ws[BKT][BN];      // w tile, unscaled

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns tx*4 .. tx*4+3
  const int ty = tid >> 4;  // output rows ty*TM .. ty*TM+TM-1
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKT) {
    for (int idx = tid; idx < BM * BKT; idx += THREADS) {
      const int r = idx / BKT, kk = idx % BKT;
      const int m = m0 + r, k = k0 + kk;
      Xs[kk][r] =
          (m < M && k < K) ? molly::to_float(x[(long long)m * K + k]) : 0.f;
    }
    for (int idx = tid; idx < BKT * BN; idx += THREADS) {
      const int kk = idx / BN, c = idx % BN;
      const int k = k0 + kk, n = n0 + c;
      Ws[kk][c] = (k < K && n < N) ? (float)w[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKT; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&Xs[kk][ty * TM]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      const float4 bv = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        out[(long long)m * N + n] = molly::from_float<T>(acc[i][j] * scale[n]);
    }
  }
}

template <typename T>
int launch(const void* x, const int8_t* w, const float* scale, void* out,
           int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, scale, static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Decode path (M <= SMALL_M): a split-K weight stream. Each block owns 128
// columns and one K chunk; every thread reads 16 int8 weights (16 bytes, one
// vector load) per row it visits, with the 8 threads of a row segment on
// 128 contiguous bytes, and multiplies them by up to MT activation rows
// (staged in shared memory as fp32). Partial sums are reduced in the block,
// then added into an fp32 workspace with atomics (the K chunks of one
// column land in any order); a second small kernel applies the scale and
// casts. The grid has enough K chunks to put ~2 blocks on every SM even
// when N is only 2048.
// ---------------------------------------------------------------------------

constexpr int SMALL_M = 16;
constexpr int GV_COLS = 128;      // columns per block
constexpr int GV_KCHUNK_MIN = 256;
constexpr int GV_KCHUNK_MAX = 8192;  // MT * 8192 fp32 = 128 KB of shared x
constexpr int MT = 4;             // activation rows per pass

template <typename T>
__global__ void __launch_bounds__(THREADS)
    int8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     float* __restrict__ ws, int M, int N, int K,
                     int kchunk) {
  extern __shared__ __align__(16) float xs[];  // [MT][kchunk]
  __shared__ float red[THREADS / 32][MT][GV_COLS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 7;               // 16-column group
  const int kl = warp * 4 + (lane >> 3);  // k lane, 0..31
  const int n0 = blockIdx.x * GV_COLS + cg * 16;
  const int kbeg = blockIdx.y * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int m0 = blockIdx.z * MT;
  const int mrows = min(MT, M - m0);

  for (int idx = tid; idx < MT * kchunk; idx += THREADS) {
    const int m = idx / kchunk, kk = idx % kchunk;
    const int k = kbeg + kk;
    xs[idx] = (m < mrows && k < kend)
                  ? molly::to_float(x[(long long)(m0 + m) * K + k])
                  : 0.f;
  }
  __syncthreads();

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;

  const bool full = n0 + 16 <= N && (N & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  for (int k = kbeg + kl; k < kend; k += 32) {
    int8_t wv[16];
    const int8_t* row = w + (long long)k * N + n0;
    if (full) {
      *reinterpret_cast<int4*>(wv) = __ldg(reinterpret_cast<const int4*>(row));
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) wv[c] = (n0 + c < N) ? row[c] : 0;
    }
    float xv[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) xv[m] = xs[m * kchunk + (k - kbeg)];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float wf = (float)wv[c];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xv[m], wf, acc[m][c]);
    }
  }

  // reduce over the 4 k lanes of a warp (lane bits 3, 4), then over warps
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) red[warp][m][cg * 16 + c] = acc[m][c];
  }
  __syncthreads();
  for (int idx = tid; idx < MT * GV_COLS; idx += THREADS) {
    const int m = idx / GV_COLS, c = idx % GV_COLS;
    const int n = blockIdx.x * GV_COLS + c;
    if (m >= mrows || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < THREADS / 32; ++wi) s += red[wi][m][c];
    atomicAdd(&ws[(long long)(m0 + m) * N + n], s);
  }
}

template <typename T>
__global__ void int8_gemv_finalize(const float* __restrict__ ws,
                                   const float* __restrict__ scale,
                                   T* __restrict__ out, int M, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (long long)M * N)
    out[i] = molly::from_float<T>(ws[i] * scale[i % N]);
}

template <typename T>
int launch_gemv(const void* x, const int8_t* w, const float* scale, void* out,
                float* ws, int M, int N, int K, cudaStream_t stream) {
  const int nblk = (N + GV_COLS - 1) / GV_COLS;
  int splits = (2 * 132 + nblk - 1) / nblk;
  splits = max(1, min(splits, (K + GV_KCHUNK_MIN - 1) / GV_KCHUNK_MIN));
  splits = max(splits, (K + GV_KCHUNK_MAX - 1) / GV_KCHUNK_MAX);
  int kchunk = (K + splits - 1) / splits;
  kchunk = (kchunk + 31) / 32 * 32;
  splits = (K + kchunk - 1) / kchunk;
  const int smem = MT * kchunk * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(ws, 0, sizeof(float) * (size_t)M * N, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(nblk, splits, (M + MT - 1) / MT);
  int8_gemv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), w, ws, M, N, K, kchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)M * N;
  int8_gemv_finalize<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      ws, scale, static_cast<T*>(out), M, N);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] and out [M, N] row-major contiguous in dtype; w_q [K, N] int8
// row-major contiguous (16-byte aligned); scale [N] fp32; ws an fp32
// workspace of M * N elements, used when M <= SMALL_M (may be null else;
// ops/quant.py:SMALL_M is the same number).
extern "C" int molly_int8_matmul(const void* x, const int8_t* w,
                                 const float* scale, void* out, float* ws,
                                 int M, int N, int K, int dtype,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = M <= SMALL_M;
  if (small && ws == nullptr) return cudaErrorInvalidValue;
  if (dtype == molly::kBFloat16)
    return small ? launch_gemv<__nv_bfloat16>(x, w, scale, out, ws, M, N, K, s)
                 : launch<__nv_bfloat16>(x, w, scale, out, M, N, K, s);
  if (dtype == molly::kFloat32)
    return small ? launch_gemv<float>(x, w, scale, out, ws, M, N, K, s)
                 : launch<float>(x, w, scale, out, M, N, K, s);
  return cudaErrorInvalidValue;
}
