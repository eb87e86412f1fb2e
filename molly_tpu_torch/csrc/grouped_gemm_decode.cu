// Grouped GEMM of the mixture-of-experts FFN at decode and serving shapes
// for Hopper (sm_90a): a stream of the active experts' weights, bf16 or
// int8, split over K, the splits reduced across a thread-block cluster.
//
// Replaces: megablox `gmm` (launched from molly_tpu/ops/moe.py:_grouped_dot)
// for the calls that ops/grouped_gemm.py:takes_stream names: bf16 lhs, a
// bf16 rhs without a scale or an int8 rhs with its per-(group, column)
// scale, not transposed, fewer than 64 rows a group on average (M < 64 G),
// K a multiple of 64, N of 8 (int8: 16), 16-byte aligned bases. Same
// semantics: out[r] = lhs[r] @ rhs[g(r)] accumulated in fp32 (int8: times
// scale[g(r)], once), rows past sum(group_sizes) zero, an empty group reads
// no weights; out fp32 or bf16.
//
// What bounds it: bytes. Decode sends 32 rows (4 tokens, top-8) to ~28 of
// 128 experts; the call reads 28 x 3 MB of bf16 weights and does 2
// operations a weight byte for each of the group's one or two rows. Every SM
// must stream, with tens of KB in flight, and no weight byte may be read
// twice.
//
// The design.
//   - A static plan (ops/grouped_gemm.py:stream_plan, from M, G, K, N and the
//     SM count, never the group sizes, so a captured graph replays with new
//     sizes): the grid is (split, slot, column tile of 128). Slot a serves
//     the a-th group that has rows (min(M, G) slots: no call has more active
//     groups); a block whose slot has no group returns before it loads
//     anything. The splits cut K into whole 64-element stages, as many as
//     keep every block of the plan resident at once (no second wave).
//   - Operands swapped: out^T = w^T x^T on mma.sync m16n8k16 with the
//     weight's 128 columns on m (two m16 tiles a consumer warp) and the
//     group's rows on n, 8 at a time, so at most 7 rows of a product are
//     padding. A group of more than 16 rows takes several passes over its
//     weights.
//   - A producer warp keeps STAGES stages in flight by TMA (128-byte
//     swizzle): the weight tile [64 k x 128 columns] and 16 rows of lhs from
//     the group's first row [16 x 64 k] (rows past the group's end only feed
//     columns of out^T that are never stored). bf16 A fragments come by
//     ldmatrix.trans; an int8 tile stays bytes in shared memory and is
//     converted to bf16 in registers, exactly (hopper.cuh: int8_frags), a
//     thread's two m16 tiles holding four adjacent weight columns.
//   - The splits of one (slot, column tile) are the blocks of one cluster.
//     Each writes its fp32 partial to its shared memory; after a cluster
//     barrier, block s sums its share of the tile's columns over the splits
//     in order 0 .. S-1 through distributed shared memory, applies the scale
//     and writes the output. No atomics: two runs give the same bits.
//   - Rows past the last group: the blocks of slot 0, split 0 write zeros
//     in their column tile.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace molly::hopper;

constexpr int MAX_GROUPS = 1024;
constexpr int MAX_SPLITS = 8;
constexpr int BN = 128;        // weight columns of a unit
constexpr int BK = 64;         // contraction elements a stage
constexpr int RB = 16;         // rows of a pass: two n8 chunks
constexpr int NCW = 4;         // consumer warps, 32 columns each
constexpr int THREADS = (NCW + 1) * 32;  // + the producer warp
constexpr int X_BYTES = RB * 128;        // [16 rows x 64 k] bf16
constexpr int PART_LD = BN + 4;          // floats a partial row (padded)
constexpr int PART_BYTES = RB * PART_LD * 4;

// Small blocks, so that a plan's blocks are all resident at once: 45 KB
// (bf16: 2 stages of 18 KB, 4 blocks an SM) or 40 KB (int8: 3 stages of 10
// KB, 5 blocks an SM), 8-15 stages in flight an SM. ops/grouped_gemm.py's
// _STREAM_BLOCKS_PER_SM holds these occupancies.
template <bool INT8>
struct Cfg {
  static constexpr int W_BYTES = BK * BN * (INT8 ? 1 : 2);  // 1 or 2 boxes
  static constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
  static constexpr int STAGES = INT8 ? 3 : 2;
  static constexpr int SMEM = STAGES * STAGE_BYTES + PART_BYTES + 1024;
};

struct Params {
  void* out;
  const float* scale;  // [G, N] (int8) or null
  const int* group_sizes;
  int out_f32, G, M, K, N, stages_per_split;
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// One warp: the `slot`-th group that has rows, as unit = {group (-1: none),
// first row, end row, rows owned by all groups}. Sizes are clamped to
// [0, M] and the row ranges clipped to M, as the other kernels do.
__device__ void find_group(const int* __restrict__ sizes, int G, int M,
                           int slot, int* unit) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int per = (G + 31) / 32;
  const int g0 = min(G, lane * per), g1 = min(G, g0 + per);
  int rows = 0;
  for (int g = g0; g < g1; ++g) rows += min(max(sizes[g], 0), M);
  int incl = rows;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int first = incl - rows;  // this lane's first row, unclipped
  int act = 0;
  for (int g = g0, r = first; g < g1; ++g) {
    const int s = min(max(sizes[g], 0), M);
    act += s > 0 && r < M;
    r += s;
  }
  int act_incl = act;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, act_incl, o);
    if (lane >= o) act_incl += v;
  }
  const int n_active = __shfl_sync(FULL, act_incl, 31);
  const int total = min(__shfl_sync(FULL, incl, 31), M);
  if (lane == 0) {
    unit[3] = total;
    if (slot >= n_active) unit[0] = -1;
  }
  if (slot >= act_incl - act && slot < act_incl) {
    for (int g = g0, r = first, k = act_incl - act; g < g1; ++g) {
      const int s = min(max(sizes[g], 0), M);
      if (s > 0 && r < M) {
        if (k == slot) {
          unit[0] = g;
          unit[1] = r;
          unit[2] = min(r + s, M);
          break;
        }
        ++k;
      }
      r += s;
    }
  }
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS)
    grouped_gemm_decode_kernel(const __grid_constant__ CUtensorMap map_w,
                               const __grid_constant__ CUtensorMap map_x,
                               const Params p) {
  using C = Cfg<INT8>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES];
  __shared__ int s_unit[4];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* part = reinterpret_cast<float*>(ring + STAGES * C::STAGE_BYTES);

  const int split = blockIdx.x, slot = blockIdx.y, S = gridDim.x;
  const int n0 = blockIdx.z * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = p.M, N = p.N, K = p.K;

  if (warp == 0) find_group(p.group_sizes, p.G, M, slot, s_unit);
  if (threadIdx.x == NCW * 32) {  // the producer: its maps into the cache
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_w) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_x) : "memory");
  }
  if (threadIdx.x == 32) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&s_full[s], 1);     // the producer's arrive, plus the bytes
      mbar_init(&s_empty[s], NCW);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int grp = s_unit[0], total = s_unit[3];

  if (slot == 0 && split == 0) {  // rows no group owns: zeros
    for (int i = threadIdx.x; i < (M - total) * BN; i += THREADS) {
      const int row = total + i / BN, n = n0 + i % BN;
      if (n < N) {
        const long long at = (long long)row * N + n;
        if (p.out_f32)
          static_cast<float*>(p.out)[at] = 0.f;
        else
          static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16_rn(0.f);
      }
    }
  }
  if (grp < 0) return;  // the slot's whole cluster leaves here
  const int row_begin = s_unit[1], row_end = s_unit[2];

  const int k_first = split * p.stages_per_split;
  const int n_st = max(0, min(p.stages_per_split, K / BK - k_first));
  const int g = lane >> 2, t = lane & 3;
  Ring<STAGES> ring_pos;

  for (int r0 = row_begin; r0 < row_end; r0 += RB) {  // passes
    if (warp == NCW) {
      if (lane == 0) {
        for (int i = 0; i < n_st; ++i) {
          mbar_wait(&s_empty[ring_pos.stage], ring_pos.phase ^ 1);
          uint64_t* bar = &s_full[ring_pos.stage];
          mbar_expect_tx(bar, C::STAGE_BYTES);
          unsigned char* st = ring + ring_pos.stage * C::STAGE_BYTES;
          const int k = (k_first + i) * BK;
          tma_load_2d(st, &map_w, bar, n0, grp * K + k);
          if constexpr (!INT8)
            tma_load_2d(st + BK * 128, &map_w, bar, n0 + 64, grp * K + k);
          tma_load_2d(st + C::W_BYTES, &map_x, bar, k, r0);
          ring_pos.advance();
        }
      }
    } else {
      float acc[2][RB / 8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < RB / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
      const int nch = min(RB / 8, (row_end - r0 + 7) / 8);
      // int8: this thread's four columns 32 warp + 4g .. + 3 (one 16-byte
      // chunk of the 128-byte row) at the even and odd rows of a k step
      const int chunk = 2 * warp + (g >> 2);
      const int off_e = ((chunk ^ (2 * t)) << 4) + 4 * (g & 3);
      const int off_o = ((chunk ^ (2 * t + 1)) << 4) + 4 * (g & 3);
      for (int i = 0; i < n_st; ++i) {
        mbar_wait(&s_full[ring_pos.stage], ring_pos.phase);
        const unsigned char* w = ring + ring_pos.stage * C::STAGE_BYTES;
        const unsigned char* x = w + C::W_BYTES;
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          uint32_t a[2][4];
          if constexpr (INT8) {
            const unsigned char* row = w + (16 * ks + 2 * t) * 128;
            int8_frags(lds32(row + off_e), lds32(row + 128 + off_o),
                       lds32(row + 8 * 128 + off_e),
                       lds32(row + 9 * 128 + off_o), a[0], a[1]);
          } else {
            // matrix lane / 8: k rows + 8 (bit 1), columns + 8 (bit 0)
            const int mj = lane >> 3;
            const int k = 16 * ks + (mj >> 1) * 8 + (lane & 7);
#pragma unroll
            for (int i2 = 0; i2 < 2; ++i2) {
              const int col = 32 * warp + 16 * i2 + (mj & 1) * 8;
              ldmatrix_x4_trans(a[i2], w + (col >> 6) * (BK * 128) +
                                           swz(k, (col & 63) >> 3));
            }
          }
#pragma unroll
          for (int c = 0; c < RB / 8; ++c) {
            if (c < nch) {
              const unsigned char* xr = x + 4 * t;
              const uint32_t b0 = lds32(xr + swz(8 * c + g, 2 * ks));
              const uint32_t b1 = lds32(xr + swz(8 * c + g, 2 * ks + 1));
              molly::mma_bf16(acc[0][c], a[0], b0, b1);
              molly::mma_bf16(acc[1][c], a[1], b0, b1);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&s_empty[ring_pos.stage]);
        ring_pos.advance();
      }
      // the partial, [row][column]: out^T row g (+8) of m tile i is column
      // 32 warp + 16 i + g (+8) (bf16) or 32 warp + 4 g + 2 i (+1) (int8)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int col = INT8 ? 32 * warp + 4 * g + 2 * i + hi
                               : 32 * warp + 16 * i + 8 * hi + g;
#pragma unroll
          for (int c = 0; c < RB / 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              part[(8 * c + 2 * t + e) * PART_LD + col] = acc[i][c][2 * hi + e];
        }
    }
    __syncwarp();
    cluster_sync();  // every split's partial is in its shared memory
    // this block's share of the tile: 4-column groups [q0, q1) of 32
    const int rows = min(RB, row_end - r0);
    const int q0 = split * (BN / 4) / S, q1 = (split + 1) * (BN / 4) / S;
    const uint32_t part_u32 = smem_u32(part);
    for (int i = threadIdx.x; i < rows * (q1 - q0); i += THREADS) {
      const int row = i / (q1 - q0), c = 4 * (q0 + i % (q1 - q0));
      const int n = n0 + c;
      if (n >= N) continue;  // N % 8 == 0: four columns lie in or out
      const uint32_t at = part_u32 + (row * PART_LD + c) * 4;
      float4 v = ld_cluster_f4(at, 0);
      for (int s = 1; s < S; ++s) {
        const float4 u = ld_cluster_f4(at, s);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      if constexpr (INT8) {
        const float4 sc =
            *reinterpret_cast<const float4*>(p.scale + (long long)grp * N + n);
        v.x *= sc.x;
        v.y *= sc.y;
        v.z *= sc.z;
        v.w *= sc.w;
      }
      const long long o = (long long)(r0 + row) * N + n;
      if (p.out_f32)
        *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) = v;
      else
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + o) =
            make_uint2(molly::pack_bf16(v.x, v.y), molly::pack_bf16(v.z, v.w));
    }
    cluster_sync();  // nobody reads a partial any more
  }
}

template <bool INT8>
int launch(const void* lhs, const void* rhs, const float* scale, void* out,
           int out_f32, const int* group_sizes, int M, int K, int N, int G,
           int slots, int tiles, int splits, int per, cudaStream_t stream) {
  using C = Cfg<INT8>;
  alignas(64) CUtensorMap map_w, map_x;
  if (!map_2d(&map_w, rhs, INT8 ? 1 : 2, (long long)G * K, N, BK,
              INT8 ? 128 : 64) ||
      !map_2d(&map_x, lhs, 2, M, K, RB, 64))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(grouped_gemm_decode_kernel<INT8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, slots, tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Params p{out, scale, group_sizes, out_f32, G, M, K, N, per};
  err = cudaLaunchKernelEx(&cfg, grouped_gemm_decode_kernel<INT8>, map_w,
                           map_x, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// lhs [M, K] bf16; rhs [G, K, N] bf16 (scale null) or int8 (scale [G, N]
// fp32); out [M, N] fp32 or bf16 (dtype codes of common.cuh); all
// contiguous with 16-byte aligned bases; group_sizes [G] int32 on the
// device. The plan (slots, column tiles, splits, stages a split) comes from
// ops/grouped_gemm.py:stream_plan.
extern "C" int molly_grouped_gemm_decode(const void* lhs, const void* rhs,
                                         const float* scale, void* out,
                                         const int* group_sizes, int M, int K,
                                         int N, int G, int out_dtype,
                                         int slots, int tiles, int splits,
                                         int per, void* stream) {
  const bool int8 = scale != nullptr;
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > MAX_GROUPS || K % BK ||
      N % (int8 ? 16 : 8) || !aligned16(lhs) || !aligned16(rhs) ||
      !aligned16(out) || (int8 && !aligned16(scale)))
    return cudaErrorInvalidValue;
  if (out_dtype != molly::kFloat32 && out_dtype != molly::kBFloat16)
    return cudaErrorInvalidValue;
  // the plan must cover every active group, column and stage
  if (slots < (M < G ? M : G) || slots > 65535 ||
      (long long)tiles * BN < N || tiles > 65535 || splits < 1 ||
      splits > MAX_SPLITS || per < 1 || (long long)splits * per * BK < K)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int out_f32 = out_dtype == molly::kFloat32;
  return int8 ? launch<true>(lhs, rhs, scale, out, out_f32, group_sizes, M, K,
                             N, G, slots, tiles, splits, per, s)
              : launch<false>(lhs, rhs, nullptr, out, out_f32, group_sizes, M,
                              K, N, G, slots, tiles, splits, per, s);
}
