// Grouped GEMMs of the mixture-of-experts FFN at prefill and training
// shapes, built from what Hopper added: TMA loads into a ring of shared
// memory stages guarded by mbarriers, and wgmma (sm_90a only).
//
// Replaces: the same megablox kernels as grouped_gemm.cu (`gmm`, also with
// transpose_rhs, and `tgmm`; launched from molly_tpu/ops/moe.py:_grouped_dot),
// for the operands those kernels see when hundreds of rows go to each
// expert: everything bf16, no scale, 16-byte aligned rows.
//   forward  out[r, :] = lhs[r, :] @ rhs[g(r)]     lhs [M, K], rhs [G, K, N]
//            (TRANS: rhs is [G, N, K]; wgmma reads it K-major as it lies)
//   tgmm     out[g] = lhs[rows_g]^T @ dout[rows_g]  -> [G, K, N]
// ops/grouped_gemm.py decides which source a call goes to (takes_tma /
// tgmm_takes_tma; the entry points below refuse what the rule excludes).
//
// What bounds them on this card. The forward at prefill width does 295
// operations a byte: operations and bytes bound it about equally, so the
// products must run at the wgmma rate and the output must leave in full
// lines. tgmm writes a [G, K, N] gradient from ~256 rows a group: bytes bound
// it, and two thirds of them are the output.
//
// The design, common to both. One persistent block an SM; 3 warpgroups: two
// consumers (232 registers a thread) that each own 64 rows of a 128 x 128
// output tile in fp32 accumulators, and a producer of which one thread
// starts TMA loads up to 4 stages (4 x 32 KB) ahead, across tile
// boundaries, so a tile's epilogue overlaps the next tile's loads. A stage
// is full when its bytes have landed (mbarrier transaction count) and empty
// when all 8 consumer warps have retired the wgmmas that read it. Every
// operand tile is a stack of TMA boxes of 64 rows x 128 bytes in the
// 128-byte swizzle, which is the layout wgmma's descriptors name.
//
// Forward. Tiles are aligned to groups as in grouped_gemm.cu: the prefix
// sums of the sizes (one pass a block, kept in shared memory) give each
// group's first row and first tile; a tile covers rows b .. min(b + 128,
// group end). The lhs box may reach into the next group's rows: they are
// multiplied and not stored. A warpgroup whose 64 rows all lie in the group
// hands them to TMA stores from a swizzled staging tile (they overlap the
// next tile's products); in a ragged tile each warp stages its 16 x 128 part
// and writes whole rows, 16 bytes a lane, masked by the group's end. Rows
// past the last group are written as zeros. An empty group owns no tile and
// reads no weights.
//
// tgmm. Tiles run group-major (group, K tile, N tile), so a group's rows
// stay in L2 while its 96 tiles are computed. Both operands lie with the
// contraction axis (rows) outermost: TMA brings them as they lie and wgmma
// reads both MN-major (trans_a = trans_b = 1). The last 64-row stage of a
// group reaches past the group's end: each consumer zeroes those rows (whole
// 128-byte lines) of its own lhs box before its wgmmas read it. The result
// leaves as TMA stores from a swizzled staging tile, which clip at the edges
// of [K, N] and overlap the next tile's products. One block a tile, rows in
// order, no atomics: two runs give the same bits, and an empty group's tile
// is the zeros the accumulators started with.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace molly::hopper;

constexpr int MAX_GROUPS = 1024;
constexpr int TILE = 128;      // output tile: 128 x 128
constexpr int BK = 64;         // contraction elements a stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;   // consumers: warpgroups 0, 1; producer: 2
constexpr int BOX_BYTES = 64 * 128;          // 64 rows of 128 bytes
constexpr int STAGE_BYTES = 4 * BOX_BYTES;   // 2 boxes an operand
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int STG_LD = TILE + 8;             // ragged staging row, floats
// epilogue staging of one warpgroup: 4 boxes for a TMA store (32 KB), or 4
// warps x 16 padded rows for the row-masked store
constexpr int STG_WG_BYTES = 35 * 1024;
static_assert(STG_WG_BYTES >= 4 * BOX_BYTES &&
              STG_WG_BYTES >= 4 * 16 * STG_LD * 4);
constexpr int SMEM_BYTES = RING_BYTES + 2 * STG_WG_BYTES + 1024;  // + align

// One ring position: the stage and the parity its full barrier shows once
// it has been filled this time round.
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

struct Shared {
  unsigned char* ring;   // STAGES x (operand A: 2 boxes, operand B: 2 boxes)
  unsigned char* stage;  // epilogue staging
};

__device__ __forceinline__ Shared carve(unsigned char* raw) {
  const uint32_t addr = smem_u32(raw);
  unsigned char* base = raw + ((1024 - (addr & 1023)) & 1023);
  return {base, base + RING_BYTES};
}

// Exclusive prefix sums of the clipped group sizes: s_row[g] is group g's
// first row (s_row[G] the first row no group owns, s_row[G + 1] = M); with
// `bm` > 0, s_tile[g] is its first row tile of bm rows (s_tile[G] the first
// tile of the rows no group owns, s_tile[G + 1] the tile count). One thread:
// a hundred groups cost about a microsecond a block.
__device__ __forceinline__ void scan_sizes(const int* group_sizes, int G,
                                           int M, int bm, int* s_row,
                                           int* s_tile) {
  for (int i = threadIdx.x; i < G; i += THREADS) s_row[i] = group_sizes[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int row = 0, tiles = 0;
    for (int g = 0; g < G; ++g) {
      const int sz = min(max(s_row[g], 0), M - row);
      s_row[g] = row;
      if (bm) s_tile[g] = tiles;
      row += sz;
      if (bm) tiles += (sz + bm - 1) / bm;
    }
    s_row[G] = row;
    s_row[G + 1] = M;
    if (bm) {
      s_tile[G] = tiles;
      s_tile[G + 1] = tiles + (M - row + bm - 1) / bm;
    }
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&empty[s], 8);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The consumers' product over `n_stages` ring stages into acc. make_a /
// make_b give the descriptors of a stage's operand tiles; step_a / step_b
// the descriptor advance of 16 contraction elements. before(stage, i) runs
// once the stage's bytes have landed.
template <int TRANS_A, int TRANS_B, typename Before>
__device__ __forceinline__ void consume(float (&acc)[64], Ring& ring,
                                        int n_stages, uint64_t* full,
                                        uint64_t* empty, uint32_t a_base,
                                        uint32_t b_base, uint32_t lbo_b,
                                        Before before) {
  constexpr uint32_t STEP_A = TRANS_A ? 2048 : 32;
  constexpr uint32_t STEP_B = TRANS_B ? 2048 : 32;
  const int lane = threadIdx.x & 31;
  int prev = -1;
  for (int i = 0; i < n_stages; ++i) {
    mbar_wait(&full[ring.stage], ring.phase);
    before(ring.stage, i);
    const uint32_t off = ring.stage * STAGE_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_m64n128k16<TRANS_A, TRANS_B>(
          acc, smem_desc(a_base + off + ks * STEP_A, BOX_BYTES),
          smem_desc(b_base + off + ks * STEP_B, lbo_b));
    wgmma_commit();
    if (prev >= 0) {  // the products of the stage before have retired
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = ring.stage;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
}

// A warpgroup's 64 x 128 accumulator tile leaves as TMA stores: every thread
// writes its fragment into the warpgroup's staging boxes (64 rows x 128 bytes
// each, 128-byte swizzle: 2 boxes of 64 bf16 columns or 4 of 32 fp32
// columns), one thread starts the stores to (column c0 + .., row c1, batch
// c2) of `map` and does not wait: the next tile's products overlap them.
// Boxes wholly past column n_lim are skipped, the hardware clips the rest.
// The caller has made sure the stores of the tile before have read the
// staging tile (tma_store_wait_read by thread 0, then warpgroup_sync).
__device__ __forceinline__ void store_tile_tma(const float (&acc)[64],
                                               unsigned char* stg,
                                               const CUtensorMap* map,
                                               int out_f32, int c0, int n_lim,
                                               int c1, int c2, int wg) {
  const int tid = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = (tid >> 5) * 16 + g;  // and r + 8; r % 8 == g either way
  if (out_f32) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      unsigned char* p = stg + (j >> 2) * BOX_BYTES + r * 128 +
                         ((((2 * (j & 3)) + (t >> 1)) ^ g) << 4) + 8 * (t & 1);
      *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(p + 8 * 128) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      unsigned char* p = stg + (j >> 3) * BOX_BYTES + r * 128 +
                         (((j & 7) ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(p) =
          molly::pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(p + 8 * 128) =
          molly::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  fence_async_shared();
  warpgroup_sync(wg);
  if (tid == 0) {
    const int boxes = out_f32 ? 4 : 2, cols = out_f32 ? 32 : 64;
    for (int bx = 0; bx < boxes; ++bx)
      if (c0 + bx * cols < n_lim)
        tma_store_3d(map, stg + bx * BOX_BYTES, c0 + bx * cols, c1, c2);
    tma_store_commit();
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
    grouped_gemm_tma_kernel(const __grid_constant__ CUtensorMap map_lhs,
                            const __grid_constant__ CUtensorMap map_rhs,
                            const __grid_constant__ CUtensorMap map_out,
                            void* __restrict__ out, int out_f32,
                            const int* __restrict__ group_sizes, int G, int M,
                            int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_row[MAX_GROUPS + 2], s_tile[MAX_GROUPS + 2];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES];
  const Shared sm = carve(smem_raw);

  scan_sizes(group_sizes, G, M, TILE, s_row, s_tile);
  init_barriers(s_full, s_empty);
  __syncthreads();

  const int n_nt = (N + TILE - 1) / TILE;
  const int total = s_tile[G + 1] * n_nt;
  const int n_stages = K / BK;
  // the tile's group (G: rows no group owns) and rows [b, e)
  auto locate = [&](int tile, int* b, int* e) {
    const int slot = tile / n_nt;
    int lo = 0, hi = G;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_tile[mid + 1] > slot)
        hi = mid;
      else
        lo = mid + 1;
    }
    *b = s_row[lo] + (slot - s_tile[lo]) * TILE;
    *e = min(s_row[lo + 1], *b + TILE);
    return lo;
  };

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      Ring ring;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        int b, e;
        const int grp = locate(tile, &b, &e);
        if (grp == G) continue;
        const int n0 = (tile % n_nt) * TILE;
        for (int k0 = 0; k0 < K; k0 += BK) {
          mbar_wait(&s_empty[ring.stage], ring.phase ^ 1);
          uint64_t* bar = &s_full[ring.stage];
          mbar_expect_tx(bar, STAGE_BYTES);
          unsigned char* a = sm.ring + ring.stage * STAGE_BYTES;
          unsigned char* w = a + 2 * BOX_BYTES;
          tma_load_2d(a, &map_lhs, bar, k0, b);  // 128 rows x 64
          if (TRANS) {  // [G * N, K]: 128 rows n x 64 k
            tma_load_2d(w, &map_rhs, bar, k0, grp * N + n0);
          } else {      // [G * K, N]: two boxes of 64 rows k x 64 n
            tma_load_2d(w, &map_rhs, bar, n0, grp * K + k0);
            tma_load_2d(w + BOX_BYTES, &map_rhs, bar, n0 + 64, grp * K + k0);
          }
          ring.advance();
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t a_base = smem_u32(sm.ring) + wg * BOX_BYTES;
    const uint32_t b_base = smem_u32(sm.ring) + 2 * BOX_BYTES;
    unsigned char* stg_wg = sm.stage + wg * STG_WG_BYTES;
    float* stg = reinterpret_cast<float*>(stg_wg) + (warp & 3) * 16 * STG_LD;
    uint32_t* stg16 = reinterpret_cast<uint32_t*>(stg);  // bf16 pairs
    constexpr int LD16 = STG_LD / 2;
    Ring ring;
    float acc[64];
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      int b, e;
      const int grp = locate(tile, &b, &e);
      const int n0 = (tile % n_nt) * TILE;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      if (grp < G)
        consume<0, TRANS ? 0 : 1>(acc, ring, n_stages, s_full, s_empty, a_base,
                                  b_base, BOX_BYTES, [](int, int) {});
      // the stores of the tile before have read the staging tile
      if ((threadIdx.x & 127) == 0) tma_store_wait_read();
      warpgroup_sync(wg);
      if (b + wg * 64 + 64 <= e) {  // 64 full rows: TMA stores
        store_tile_tma(acc, stg_wg, &map_out, out_f32, n0, N, b + wg * 64, 0,
                       wg);
        continue;
      }
      // a ragged tile: this warp's 16 rows, through shared memory, as whole
      // rows masked by the group's end
      const int r0 = b + warp * 16;
      if (r0 >= e) continue;
      if (out_f32) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<float2*>(&stg[g * STG_LD + 8 * j + 2 * t]) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(&stg[(g + 8) * STG_LD + 8 * j + 2 * t]) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
        __syncwarp();
        float* o = static_cast<float*>(out);
        const int col = n0 + 4 * lane;
#pragma unroll 4
        for (int r = 0; r < 16; ++r)
          if (r0 + r < e && col < N)
            *reinterpret_cast<float4*>(&o[(long long)(r0 + r) * N + col]) =
                *reinterpret_cast<const float4*>(&stg[r * STG_LD + 4 * lane]);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          stg16[g * LD16 + 4 * j + t] =
              molly::pack_bf16(acc[4 * j], acc[4 * j + 1]);
          stg16[(g + 8) * LD16 + 4 * j + t] =
              molly::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
        __syncwarp();
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
        const int col = n0 + 8 * (lane & 15);
#pragma unroll 4
        for (int it = 0; it < 8; ++it) {
          const int r = 2 * it + (lane >> 4);
          if (r0 + r < e && col < N)
            *reinterpret_cast<uint4*>(&o[(long long)(r0 + r) * N + col]) =
                *reinterpret_cast<const uint4*>(
                    &stg16[r * LD16 + 4 * (lane & 15)]);
        }
      }
    }
    if ((threadIdx.x & 127) == 0) tma_store_wait_all();
  }
}

// ---------------------------------------------------------------------------
// tgmm
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
    tgmm_tma_kernel(const __grid_constant__ CUtensorMap map_lhs,
                    const __grid_constant__ CUtensorMap map_dout,
                    const __grid_constant__ CUtensorMap map_out, int out_f32,
                    const int* __restrict__ group_sizes, int G, int M, int K,
                    int N) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_row[MAX_GROUPS + 2];
  __shared__ __align__(8) uint64_t s_full[STAGES], s_empty[STAGES];
  const Shared sm = carve(smem_raw);

  scan_sizes(group_sizes, G, M, 0, s_row, nullptr);
  init_barriers(s_full, s_empty);
  __syncthreads();

  const int n_kt = (K + TILE - 1) / TILE, n_nt = (N + TILE - 1) / TILE;
  const int per_group = n_kt * n_nt;
  const int total = G * per_group;

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      Ring ring;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int grp = tile / per_group, rem = tile % per_group;
        const int i0 = (rem / n_nt) * TILE, n0 = (rem % n_nt) * TILE;
        const int row_end = s_row[grp + 1];
        for (int r = s_row[grp]; r < row_end; r += BK) {
          mbar_wait(&s_empty[ring.stage], ring.phase ^ 1);
          uint64_t* bar = &s_full[ring.stage];
          mbar_expect_tx(bar, STAGE_BYTES);
          unsigned char* a = sm.ring + ring.stage * STAGE_BYTES;
          tma_load_2d(a, &map_lhs, bar, i0, r);  // 64 rows x 64 columns
          tma_load_2d(a + BOX_BYTES, &map_lhs, bar, i0 + 64, r);
          tma_load_2d(a + 2 * BOX_BYTES, &map_dout, bar, n0, r);
          tma_load_2d(a + 3 * BOX_BYTES, &map_dout, bar, n0 + 64, r);
          ring.advance();
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127;
    const uint32_t a_base = smem_u32(sm.ring) + wg * BOX_BYTES;
    const uint32_t b_base = smem_u32(sm.ring) + 2 * BOX_BYTES;
    unsigned char* stg = sm.stage + wg * STG_WG_BYTES;
    Ring ring;
    float acc[64];
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int grp = tile / per_group, rem = tile % per_group;
      const int i0 = (rem / n_nt) * TILE, n0 = (rem % n_nt) * TILE;
      const int row_begin = s_row[grp], row_end = s_row[grp + 1];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      consume<1, 1>(
          acc, ring, (row_end - row_begin + BK - 1) / BK, s_full, s_empty,
          a_base, b_base, BOX_BYTES, [&](int stage, int i) {
            // rows of the box past the group's end belong to the next
            // group: zero them in this warpgroup's lhs box
            const int valid = row_end - (row_begin + i * BK);
            if (valid < BK) {
              uint4* box = reinterpret_cast<uint4*>(
                  sm.ring + stage * STAGE_BYTES + wg * BOX_BYTES);
              for (int c = valid * 8 + tid; c < BK * 8; c += 128)
                box[c] = make_uint4(0u, 0u, 0u, 0u);
              fence_async_shared();
              warpgroup_sync(wg);
            }
          });
      // the stores of the tile before have read the staging tile
      if (tid == 0) tma_store_wait_read();
      warpgroup_sync(wg);
      if (i0 + wg * 64 < K)  // else the hardware would clip all of it
        store_tile_tma(acc, stg, &map_out, out_f32, n0, N, i0 + wg * 64, grp,
                       wg);
    }
    if (tid == 0) tma_store_wait_all();
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// A row-major [.., rows, cols] tensor as boxes of box_rows x box_cols (one
// box row is 128 bytes), 128-byte swizzle, zeros out of bounds. `batch` > 0
// makes it 3-D with boxes one batch entry deep.
bool make_map(CUtensorMap* map, const void* ptr, int elem_bytes,
              long long batch, long long rows, long long cols, int box_rows,
              int box_cols) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem_bytes,
                                 (cuuint64_t)rows * cols * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map,
                elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                batch > 0 ? 3 : 2, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

template <bool TRANS>
int launch_forward(const void* lhs, const void* rhs, void* out, int out_f32,
                   const int* group_sizes, int M, int K, int N, int G,
                   cudaStream_t stream) {
  alignas(64) CUtensorMap map_lhs, map_rhs, map_out;
  if (!make_map(&map_out, out, out_f32 ? 4 : 2, 1, M, N, 64,
                out_f32 ? 32 : 64) ||
      !make_map(&map_lhs, lhs, 2, 0, M, K, TILE, BK) ||
      !(TRANS ? make_map(&map_rhs, rhs, 2, 0, (long long)G * N, K, TILE, BK)
              : make_map(&map_rhs, rhs, 2, 0, (long long)G * K, N, BK, 64)))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(grouped_gemm_tma_kernel<TRANS>);
  if (err != cudaSuccess) return err;
  const long long tiles =
      ((long long)(M + TILE - 1) / TILE + G) * ((N + TILE - 1) / TILE);
  const int sms = current_sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  grouped_gemm_tma_kernel<TRANS><<<grid, THREADS, SMEM_BYTES, stream>>>(
      map_lhs, map_rhs, map_out, out, out_f32, group_sizes, G, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// The forward for bf16 operands: lhs [M, K], rhs [G, K, N] (or [G, N, K]
// with transpose_rhs), out [M, N] fp32 or bf16 (dtype codes of common.cuh),
// all contiguous and 16-byte aligned; K a multiple of 64, N of 8.
extern "C" int molly_grouped_gemm_tma(const void* lhs, const void* rhs,
                                      void* out, const int* group_sizes, int M,
                                      int K, int N, int G, int out_dtype,
                                      int transpose_rhs, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > MAX_GROUPS || K % BK ||
      N % 8 || !aligned16(lhs) || !aligned16(rhs) || !aligned16(out))
    return cudaErrorInvalidValue;
  if (out_dtype != molly::kFloat32 && out_dtype != molly::kBFloat16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int out_f32 = out_dtype == molly::kFloat32;
  return transpose_rhs ? launch_forward<true>(lhs, rhs, out, out_f32,
                                              group_sizes, M, K, N, G, s)
                       : launch_forward<false>(lhs, rhs, out, out_f32,
                                               group_sizes, M, K, N, G, s);
}

// tgmm for bf16 operands: lhs [M, K], dout [M, N], out [G, K, N] fp32 or
// bf16, all contiguous and 16-byte aligned; K and N multiples of 8.
extern "C" int molly_grouped_gemm_tgmm_tma(const void* lhs, const void* dout,
                                           void* out, const int* group_sizes,
                                           int M, int K, int N, int G,
                                           int out_dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > MAX_GROUPS || K % 8 ||
      N % 8 || !aligned16(lhs) || !aligned16(dout) || !aligned16(out))
    return cudaErrorInvalidValue;
  if (out_dtype != molly::kFloat32 && out_dtype != molly::kBFloat16)
    return cudaErrorInvalidValue;
  const int out_f32 = out_dtype == molly::kFloat32;
  alignas(64) CUtensorMap map_lhs, map_dout, map_out;
  if (!make_map(&map_lhs, lhs, 2, 0, M, K, BK, 64) ||
      !make_map(&map_dout, dout, 2, 0, M, N, BK, 64) ||
      !make_map(&map_out, out, out_f32 ? 4 : 2, G, K, N, 64,
                out_f32 ? 32 : 64))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(tgmm_tma_kernel);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)G * ((K + TILE - 1) / TILE) *
                          ((N + TILE - 1) / TILE);
  const int sms = current_sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  tgmm_tma_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map_lhs, map_dout, map_out, out_f32, group_sizes, G, M, K, N);
  return cudaGetLastError();
}
