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
// compute-bound. The bf16 calls of the main paths run elsewhere
// (ops/quant.py picks the source): M > 16 on TMA and wgmma in
// int8_matmul_tma.cu (int8_takes_tma), M <= 16 on the weight stream of
// int8_matmul_stream.cu (int8_takes_stream). What
// those rules leave out (fp32 x, unaligned rows, K or N off their
// multiples) runs here, on a tiled SIMT GEMM: 64 x 64 output tiles staged
// as fp32, each of the 256 threads owning a 4 x 4 block of outputs.

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

}  // namespace

// x [M, K] and out [M, N] row-major contiguous in dtype; w_q [K, N] int8
// row-major contiguous; scale [N] fp32.
extern "C" int molly_int8_matmul(const void* x, const int8_t* w,
                                 const float* scale, void* out, int M, int N,
                                 int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == molly::kBFloat16)
    return launch<__nv_bfloat16>(x, w, scale, out, M, N, K, s);
  if (dtype == molly::kFloat32)
    return launch<float>(x, w, scale, out, M, N, K, s);
  return cudaErrorInvalidValue;
}
