// PTX helpers for the kernels built from what Hopper added (sm_90a only):
// shared-memory addresses, mbarriers, TMA loads and stores, the proxy
// fence, the warpgroup barrier, wgmma and its shared-memory descriptors,
// the host's lookup of cuTensorMapEncodeTiled and the 4-D maps of the
// attention kernels, the exact int8 -> bf16 conversion of A fragments, the
// 128-byte swizzle's offsets and the cluster barrier and loads.
// Included by every *_tma.cu source, grouped_gemm_decode.cu and
// int8_matmul_stream.cu.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace molly {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// returns once the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// byte offset of (row, 16-byte chunk) in a box of 128-byte rows that TMA
// wrote with the 128-byte swizzle (the box is 1024-byte aligned)
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// every thread of every block of the cluster; divergent arrival is allowed
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// four floats at `addr` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory become visible to TMA and wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of one consumer warpgroup
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for register A operands: they stay untouched until the products
// that read them have retired
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory operand descriptor, 128-byte swizzle (layout type 1). The
// tile is rows of 128 bytes, 1024-byte aligned; 8 rows are one swizzle atom.
//   K-major (trans 0): a row is 64 contraction elements of one M/N index;
//     SBO = 1024 steps 8 M/N indices; LBO is not used; 16 contraction
//     elements further is +32 bytes.
//   MN-major (trans 1): a row is 64 M/N indices of one contraction element;
//     SBO = 1024 steps 8 contraction elements; LBO steps 64 M/N indices (the
//     next box); 16 contraction elements further is +2048 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define MOLLY_R4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MOLLY_R16(d, i) \
  MOLLY_R4(d, i), MOLLY_R4(d, i + 4), MOLLY_R4(d, i + 8), MOLLY_R4(d, i + 12)

// d[64 x 128] (+)= a[64 x 16] * b[16 x 128], bf16 operands from shared
// memory; scale_d = 0 overwrites d. Thread (warp q of the warpgroup, g =
// lane / 4, t = lane % 4) holds d[4j], d[4j+1] = D[16q + g][8j + 2t, +1] and
// d[4j+2], d[4j+3] = D[16q + g + 8][8j + 2t, +1] for j = 0 .. 15.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"  // scale-d: accumulate onto d
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : MOLLY_R16(d, 0), MOLLY_R16(d, 16), MOLLY_R16(d, 32), MOLLY_R16(d, 48)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d[64 x 64] (+)= a[64 x 16] * b[16 x 64] from shared memory; the layout of
// d is the one above with j = 0 .. 7
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : MOLLY_R16(d, 0), MOLLY_R16(d, 16)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d[64 x 128] += a[64 x 16] * b[16 x 128] with a from registers: thread
// (q, g, t) holds a[0] = A[16q + g][2t, +1], a[1] = A[16q + g + 8][2t, +1],
// a[2] = A[16q + g][2t + 8, +9], a[3] = A[16q + g + 8][2t + 8, +9] as bf16
// pairs, which is the accumulator layout above packed two by two.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "%70;\n"
      "}\n"
      : MOLLY_R16(d, 0), MOLLY_R16(d, 16), MOLLY_R16(d, 32), MOLLY_R16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

// d[64 x 64] += a[64 x 16] * b[16 x 64], a from registers as above; j = 0 .. 7
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : MOLLY_R16(d, 0), MOLLY_R16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

// One int8 byte of w (biased to unsigned by the caller) as fp32, exactly:
// the byte becomes the low mantissa byte of 2^23, and 2^23 + 128 is taken off.
template <int BYTE>
__device__ __forceinline__ float i8_biased_to_f32(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | BYTE)) -
         8388736.f;
}
// two exact fp32 integers as a bf16 pair (lo in the low half): their upper
// halves, since an integer of at most 8 bits has no bits in the lower ones
__device__ __forceinline__ uint32_t pack_exact_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// The A fragments (m16 x k16, bf16, the layout of mma.sync and of wgmma's
// register A) of two m tiles from an int8 tile stored [k][n], for weight
// columns on m: w0 .. w3 are the 32-bit words of rows 2t, 2t + 1, 2t + 8,
// 2t + 9 of the k step (t = lane % 4) at four adjacent columns c .. c + 3.
// Tile i gets columns c + 2i (its row g) and c + 2i + 1 (its row g + 8), so
// one 32-bit load a row serves both tiles. Exact: int8 values are bf16.
__device__ __forceinline__ void int8_frags(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t (&a0)[4],
                                           uint32_t (&a1)[4]) {
  w0 ^= 0x80808080u;
  w1 ^= 0x80808080u;
  w2 ^= 0x80808080u;
  w3 ^= 0x80808080u;
  a0[0] = pack_exact_bf16(i8_biased_to_f32<0>(w0), i8_biased_to_f32<0>(w1));
  a0[1] = pack_exact_bf16(i8_biased_to_f32<1>(w0), i8_biased_to_f32<1>(w1));
  a0[2] = pack_exact_bf16(i8_biased_to_f32<0>(w2), i8_biased_to_f32<0>(w3));
  a0[3] = pack_exact_bf16(i8_biased_to_f32<1>(w2), i8_biased_to_f32<1>(w3));
  a1[0] = pack_exact_bf16(i8_biased_to_f32<2>(w0), i8_biased_to_f32<2>(w1));
  a1[1] = pack_exact_bf16(i8_biased_to_f32<3>(w0), i8_biased_to_f32<3>(w1));
  a1[2] = pack_exact_bf16(i8_biased_to_f32<2>(w2), i8_biased_to_f32<2>(w3));
  a1[3] = pack_exact_bf16(i8_biased_to_f32<3>(w2), i8_biased_to_f32<3>(w3));
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the CUDA runtime has
// already loaded: it is looked up by name there, nothing new is linked.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A row-major [rows, cols] matrix of 1- or 2-byte elements as boxes of
// box_rows x box_cols (box_cols * elem_bytes = 128: one swizzle span),
// 128-byte swizzle, zeros out of bounds
inline bool map_2d(CUtensorMap* map, const void* ptr, int elem_bytes,
                   long long rows, long long cols, int box_rows,
                   int box_cols) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map,
                elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the SM count of the current device (the wrappers make the tensors'
// device current), 0 on error
inline int current_sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return count;
}

// [B, S, heads, D] bf16 given by element strides (the head dim contiguous)
// as a 4-D tensor map, boxes of 64 head dims (128 bytes) x `rows` positions
// x 1 x 1, 128-byte swizzle, zeros out of bounds (stores clip there)
inline bool make_bsnd_map(CUtensorMap* map, const void* ptr, long long D,
                          long long S, long long H, long long B, long long s_s,
                          long long s_h, long long s_b, int rows) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_s * 2, (cuuint64_t)s_h * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace molly
