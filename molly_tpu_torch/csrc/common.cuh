// Shared helpers for the port's CUDA kernels: element conversion and the
// error-string export every library carries (ops/_cuda_build.check reads it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace molly {

// dtype codes passed from Python (ops/_cuda_build callers)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// D += A * B on the tensor cores: mma.sync m16n8k16, bf16 operands, fp32
// accumulators. Fragment coordinates with g = lane / 4, t = lane % 4:
//   a[0] = A[g][2t, 2t+1]   a[1] = A[g+8][2t, 2t+1]
//   a[2] = A[g][2t+8, +9]   a[3] = A[g+8][2t+8, +9]
//   b0 = B[2t, 2t+1][g]     b1 = B[2t+8, 2t+9][g]
//   c[0], c[1] = C[g][2t, 2t+1]   c[2], c[3] = C[g+8][2t, 2t+1]
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace molly

extern "C" const char* molly_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
