// Paged flash-decode attention for Hopper (sm_90a), split over the sequence,
// with whole pages loaded ahead by TMA: one bf16 query token per serving slot
// over a KV cache of bf16 pages, or of int8 pages with fp32 per-row scales.
//
// Replaces, for bf16 q (ops/paged_attention.py:paged_takes_tma is the rule;
// fp32 pages, fp32 q over int8 pages and odd shapes stay on
// paged_attention.cu):
//   - molly_tpu/ops/paged_attention_int8.py:_kernel (and _kernel_one_block),
//     the Pallas kernel over int8 pages with per-row scales;
//   - the Pallas kernel behind molly_tpu/ops/paged_attention.py's
//     jax.experimental.pallas.ops.tpu.paged_attention call, over bf16 pages.
//
// It computes what ops/paged_attention.py:paged_attention_plain computes:
// for slot b and q head h (kv head h / G), over positions t < lengths[b],
// position t at pages[kv, page_indices[b, t / P], t % P, :],
//   s[t] = (q . k[t]) * scale          (int8: * k_scale[t] / 127.5)
//   out  = sum_t softmax(s)[t] * v[t]  (int8: weight * v_scale[t] / 127.5)
// with the K scale on the logit after the product, the V scale folded into
// the softmax weight, the softmax scale on the fp32 logits, and a zero row
// for a slot of length 0.
//
// What bounds it on this card: bytes. Every live K and V row is read once
// (2 Dh bytes a token and kv head in int8, 4 Dh in bf16) for 4 G Dh
// operations, far below the ops-per-byte ridge. The design:
//   - flash-decoding: the grid is (split, kv head, slot). A split is a whole
//     number of pages of one slot (ops/paged_attention.py:paged_split_plan
//     fixes it from static shapes and the SM count; lengths live on the
//     device and the host never reads them). A split that starts at or past
//     its slot's length exits at once; no table entry at or past
//     ceil(len / P) is read.
//   - a producer warp stages the split's page-table entries, then keeps
//     STAGES whole pages in flight: TMA copies of [P, 128-byte] boxes of the
//     pools viewed 2-D as [Nkv * rows * P, Dh] with a 128-byte swizzle, and
//     (int8) bulk copies of the pages' scales, each page completing on a
//     full mbarrier; consumers free a stage through an empty mbarrier.
//   - consumer warps (two for bf16 pages, four for int8) take 16-token
//     chunks of a page and run mma.sync m16n8k16 transposed: S^T = K q^T
//     with 16 tokens as the m rows and the G <= 8 q heads as the n = 8
//     columns (columns G .. 7 are zero), K rows loaded whole from shared
//     memory (no shuffle tree per
//     token: a column's max is three shuffles a chunk); the head dim is
//     permuted inside each 16-wide step (a lane reads 4 neighbouring
//     elements: 8 bytes of bf16 or 4 of int8) and q alike. The online
//     softmax runs in base 2 on the accumulator layout; the weights, rounded
//     to bf16 and transposed in registers (movmatrix), are the B operand of
//     O^T += V^T P^T, V^T the A operand by ldmatrix.trans (int8: pairs of
//     bytes, split and converted exactly to bf16 in registers). O^T is
//     [Dh, 8]: 32 accumulators a thread at Dh 128.
//   - dead rows of the last page come with the page box and may hold NaN or
//     inf: their scores are replaced by select, their weights are 0 by
//     select (never 0 * scale), and their bf16 V rows are zeroed in the
//     registers before P V.
//   - the consumer warps merge (max, sum, [G, Dh]) through shared memory.
//     The slot's only live split writes the output; otherwise each split
//     writes fp32 partials to scratch the wrapper allocated, and
//     paged_merge_kernel combines the live splits in split order (eight
//     splits' loads at a time): two runs are bit-equal, and nothing depends
//     on lengths on the host, so a captured graph replays with new lengths
//     and tables.
//
// Beyond the bytes, what bounds it (PERF.md has the times): the int8 pages'
// conversions, the chain of dependent reads a split starts with (length,
// table entries, first page) and the merge kernel's launch.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace molly::hopper;

// consumer warps a block: two take a bf16 page's 16-token chunks; int8
// pages, which spend more instructions a byte, take four
template <bool INT8>
struct Warps {
  static constexpr int NW = INT8 ? 4 : 2;
  static constexpr int THREADS = (NW + 1) * 32;  // + one producer warp
};
constexpr int STAGE_TARGET = 65536;      // bytes of pages in flight a block
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLIT_PAGES = 32;      // table entries a split stages
constexpr float NEG = -1e30f;            // finite "minus infinity"
constexpr float INV_QMAX = 1.0f / 127.5f;

struct Params {
  const __nv_bfloat16* q;
  const float* k_scales;
  const float* v_scales;
  const int* lengths;
  const int* page_indices;
  __nv_bfloat16* out;
  float* part_o;   // [B, Nkv, n_splits, G, Dh]
  float* part_ml;  // [B, Nkv, n_splits, G, 2]: max (base 2), sum
  long long q_sb, q_sh;
  int Nq, Nkv, G, P, rows, pages_per_seq, pages_per_split, n_splits;
  int stages, stage_bytes;
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the 8 x 8 b16 matrix whose row lane / 4 holds columns (2 (lane % 4), +1)
// in x, transposed into the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// four int8 (bytes 0..3 of w) to fp32, exactly: bias each byte to unsigned,
// place it in the low mantissa byte of 2^23, subtract 2^23 + 128
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  w ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | i)) -
           8388736.f;
}

template <bool INT8, int DH>
__global__ void __launch_bounds__(Warps<INT8>::THREADS)
    paged_split_kernel(const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const Params p) {
  constexpr int NW = Warps<INT8>::NW, THREADS = Warps<INT8>::THREADS;
  constexpr int ESZ = INT8 ? 1 : 2;
  constexpr int NB = DH * ESZ / 128;  // 128-byte boxes a row
  constexpr int MT = DH / 16;         // m tiles of O^T
  constexpr int KS = DH / 16;         // k steps of q . k

  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ int table[MAX_SPLIT_PAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = p.P, G = p.G;
  const int len = p.lengths[b];
  const int n_used = min((max(len, 0) + P - 1) / P, p.pages_per_seq);
  const int p0 = split * p.pages_per_split;
  if (p0 >= n_used) {  // nothing live in this split
    if (p.n_splits == 1) {  // it is the whole slot: a zero row
      __nv_bfloat16* out =
          p.out + ((long long)b * p.Nq + (long long)h * G) * DH;
      for (int i = tid; i < G * DH; i += THREADS)
        out[i] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  const int n_pages = min(p.pages_per_split, n_used - p0);
  const int stages = p.stages, stage_bytes = p.stage_bytes;
  const int box_bytes = P * 128;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == NW && lane < n_pages)
    table[lane] =
        p.page_indices[(long long)b * p.pages_per_seq + p0 + lane];
  __syncthreads();

  float o[MT][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const int c = lane >> 2, t = lane & 3;

  if (warp == NW) {
    // the producer: every page of the split, STAGES ahead of the consumers
    if (lane == 0) {
      const int tx = 2 * P * DH * ESZ + (INT8 ? 2 * P * 4 : 0);
      for (int i = 0; i < n_pages; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
        uint8_t* st = ring + s * stage_bytes;
        const int row = (h * p.rows + table[i]) * P;
        mbar_expect_tx(&full[s], tx);
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) {
          tma_load_2d(st + bx * box_bytes, &map_k, &full[s], bx * 128 / ESZ,
                      row);
          tma_load_2d(st + (NB + bx) * box_bytes, &map_v, &full[s],
                      bx * 128 / ESZ, row);
        }
        if (INT8) {
          float* sc = reinterpret_cast<float*>(st + 2 * NB * box_bytes);
          bulk_load(sc, p.k_scales + row, P * 4, &full[s]);
          bulk_load(sc + P, p.v_scales + row, P * 4, &full[s]);
        }
      }
    }
  } else {
    // q^T as the B operand: column c < G is q head h * G + c, its elements
    // (16 j + 4 t, +1) in b0 and (+2, +3) in b1 of step j; other columns 0
    uint32_t qb[KS][2];
    const __nv_bfloat16* qr =
        p.q + (long long)b * p.q_sb + (long long)(h * G + c) * p.q_sh;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      qb[j][0] = c < G ? molly::ld32(qr + 16 * j + 4 * t) : 0u;
      qb[j][1] = c < G ? molly::ld32(qr + 16 * j + 4 * t + 2) : 0u;
    }
#pragma unroll
    for (int n = 0; n < MT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

    // ldmatrix: lane l addresses row l % 8 of matrix l / 8
    const int lr = lane & 7, lm = lane >> 3;
    for (int i = 0; i < n_pages; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const uint8_t* kb = ring + s * stage_bytes;
      const uint8_t* vb = kb + NB * box_bytes;
      const float* ksc = reinterpret_cast<const float*>(vb + NB * box_bytes);
      const float* vsc = ksc + P;
      const int pos0 = (p0 + i) * P;
      for (int ch = warp; ch < P / 16; ch += NW) {
        const int tb = ch * 16;  // the chunk's first row in the page
        // S^T = K q^T: sacc = S[g 2t, 2t+1][token c], then [.][token c + 8]
        // two accumulators (even and odd steps) halve the chain of products
        float sacc[4] = {0.f, 0.f, 0.f, 0.f}, sodd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          uint32_t a[4];
          if (INT8) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {  // rows c, then c + 8
              float f[4];
              i8x4_to_f32(*reinterpret_cast<const uint32_t*>(
                              kb + swz(tb + c + 8 * hf, j) + 4 * t),
                          f);
              a[hf] = molly::pack_bf16(f[0], f[1]);
              a[2 + hf] = molly::pack_bf16(f[2], f[3]);
            }
          } else {
            const uint8_t* box = kb + (j >> 2) * box_bytes + 8 * (t & 1);
            const int chunk = 2 * (j & 3) + (t >> 1);
            const uint2 u0 =
                *reinterpret_cast<const uint2*>(box + swz(tb + c, chunk));
            const uint2 u1 =
                *reinterpret_cast<const uint2*>(box + swz(tb + c + 8, chunk));
            a[0] = u0.x;
            a[1] = u1.x;
            a[2] = u0.y;
            a[3] = u1.y;
          }
          molly::mma_bf16(j & 1 ? sodd : sacc, a, qb[j][0], qb[j][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[e] += sodd[e];
        // online softmax in base 2, by column (q head 2t + e)
        const bool live0 = pos0 + tb + c < len, live1 = pos0 + tb + c + 8 < len;
        const float f0 = INT8 ? p.scale_log2 * INV_QMAX * ksc[tb + c]
                              : p.scale_log2;
        const float f1 = INT8 ? p.scale_log2 * INV_QMAX * ksc[tb + c + 8]
                              : p.scale_log2;
        float w[4], alpha[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x0 = live0 ? sacc[e] * f0 : NEG;
          const float x1 = live1 ? sacc[2 + e] * f1 : NEG;
          float mx = fmaxf(x0, x1);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float mn = fmaxf(m[e], mx);
          alpha[e] = exp2f(m[e] - mn);
          m[e] = mn;
          const float p0v = live0 ? exp2f(x0 - mn) : 0.f;
          const float p1v = live1 ? exp2f(x1 - mn) : 0.f;
          l[e] = l[e] * alpha[e] + p0v + p1v;
          // int8: the V scale folds into the weight, by select (a dead
          // row's scale may be inf or NaN)
          w[e] = INT8 ? (live0 ? p0v * vsc[tb + c] * INV_QMAX : 0.f) : p0v;
          w[2 + e] =
              INT8 ? (live1 ? p1v * vsc[tb + c + 8] * INV_QMAX : 0.f) : p1v;
        }
#pragma unroll
        for (int n = 0; n < MT; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[1];
          o[n][2] *= alpha[0];
          o[n][3] *= alpha[1];
        }
        // P^T as the B operand: the weights' 8 x 8 fragments transposed
        const uint32_t pb0 = movmatrix_trans(molly::pack_bf16(w[0], w[1]));
        const uint32_t pb1 = movmatrix_trans(molly::pack_bf16(w[2], w[3]));
        // O^T += V^T P^T, V^T the A operand by ldmatrix.trans
        if (INT8) {
          // matrices: rows tb .. +7 / tb + 8 .. +15 of 16-byte column jj,
          // then of column jj + 1; a b16 element is a pair of bytes, so
          // row c of m tile jj + q2 is element 2c of that column and row
          // c + 8 element 2c + 1
          const int vr = tb + lr + 8 * (lm & 1);
#pragma unroll
          for (int jj = 0; jj < DH / 16; jj += 2) {
            uint32_t v4[4];
            ldmatrix_x4_trans(v4, vb + swz(vr, jj + (lm >> 1)));
#pragma unroll
            for (int q2 = 0; q2 < 2; ++q2) {
              // v4[2 q2]: rows (2t, 2t + 1) x elements (2c, 2c + 1) as
              // bytes 0, 1 (row 2t) and 2, 3 (row 2t + 1); v4[2 q2 + 1] the
              // same 8 rows further
              uint32_t a[4];
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                float f[4];
                i8x4_to_f32(v4[2 * q2 + hf], f);
                a[2 * hf] = molly::pack_bf16(f[0], f[2]);      // element 2c
                a[2 * hf + 1] = molly::pack_bf16(f[1], f[3]);  // 2c + 1
              }
              molly::mma_bf16(o[jj + q2], a, pb0, pb1);
            }
          }
        } else {
          // rows past the length may hold inf or NaN, and 0 * inf is NaN
          // on a tensor core too: zero this thread's rows (2t, 2t + 1 and
          // 8 + those) when they are dead
          const int d0 = pos0 + tb + 2 * t;
          const uint32_t mk_lo = (d0 < len ? 0x0000ffffu : 0u) |
                                 (d0 + 1 < len ? 0xffff0000u : 0u);
          const uint32_t mk_hi = (d0 + 8 < len ? 0x0000ffffu : 0u) |
                                 (d0 + 9 < len ? 0xffff0000u : 0u);
          // matrices: rows tb .. +7 at elements 16 n .. +7, then + 8 .. +15;
          // rows tb + 8 .. +15 at the same two
          const int vr = tb + lr + 8 * (lm >> 1);
#pragma unroll
          for (int n = 0; n < MT; ++n) {
            const int dd = 16 * n + 8 * (lm & 1);
            uint32_t v4[4];
            ldmatrix_x4_trans(v4, vb + (dd >> 6) * box_bytes +
                                      swz(vr, (dd & 63) >> 3));
            const uint32_t a[4] = {v4[0] & mk_lo, v4[1] & mk_lo,
                                   v4[2] & mk_hi, v4[3] & mk_hi};
            molly::mma_bf16(o[n], a, pb0, pb1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 4);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 8);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 16);
    }
  }

  // merge the consumer warps through shared memory (the ring is free: every
  // page was waited for)
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(ring);  // [NW][G][DH]
  float* red_m = red_o + NW * G * DH;             // [NW][G]
  float* red_l = red_m + NW * G;                  // [NW][G]
  if (warp < NW) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int g = 2 * t + e;
      if (g >= G) continue;
#pragma unroll
      for (int n = 0; n < MT; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          // row c + 8 hf of m tile n: bf16 element 16 n + c + 8 hf; int8
          // element 16 n + 2 c + hf
          const int d = INT8 ? 16 * n + 2 * c + hf : 16 * n + c + 8 * hf;
          red_o[(warp * G + g) * DH + d] = o[n][2 * hf + e];
        }
      if (c == 0) {
        red_m[warp * G + g] = m[e];
        red_l[warp * G + g] = l[e];
      }
    }
  }
  __syncthreads();
  const long long part = ((long long)b * p.Nkv + h) * p.n_splits + split;
  // the slot's only live split writes the output itself
  const bool only = (n_used + p.pages_per_split - 1) / p.pages_per_split == 1;
  for (int idx = tid; idx < G * DH; idx += THREADS) {
    const int g = idx / DH, d = idx % DH;
    float M = NEG;
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) M = fmaxf(M, red_m[wi * G + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      const float e = exp2f(red_m[wi * G + g] - M);
      L += red_l[wi * G + g] * e;
      O += red_o[(wi * G + g) * DH + d] * e;
    }
    if (only) {
      p.out[((long long)b * p.Nq + h * G + g) * DH + d] =
          __float2bfloat16_rn(O / L);
    } else {
      p.part_o[(part * G + g) * DH + d] = O;
      if (d == 0) {
        p.part_ml[2 * (part * G + g)] = M;
        p.part_ml[2 * (part * G + g) + 1] = L;
      }
    }
  }
}

// out[b, qh, :] from the live splits' partials, in split order (a slot
// with one live split was written by it; one without gets a zero row). One
// block a (slot, q head), one thread an element of the head dim; the
// partials are read eight splits at a time and merged online.
template <int DH>
__global__ void __launch_bounds__(DH) paged_merge_kernel(const Params p) {
  constexpr int U = 8;
  const int b = blockIdx.x / p.Nq, qh = blockIdx.x % p.Nq;
  const int h = qh / p.G, g = qh % p.G, d = threadIdx.x;
  const int len = p.lengths[b];
  const int n_used = min((max(len, 0) + p.P - 1) / p.P, p.pages_per_seq);
  const int n_live = (n_used + p.pages_per_split - 1) / p.pages_per_split;
  __nv_bfloat16* out = p.out + ((long long)b * p.Nq + qh) * DH + d;
  if (n_live == 1) return;
  if (n_live == 0) {
    *out = __float2bfloat16_rn(0.f);
    return;
  }
  const long long base = ((long long)b * p.Nkv + h) * p.n_splits;
  float M = NEG, L = 0.f, O = 0.f;
  for (int s0 = 0; s0 < n_live; s0 += U) {
    float mm[U], ll[U], oo[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long pg = (base + s0 + u) * p.G + g;
      const bool in = s0 + u < n_live;
      mm[u] = in ? p.part_ml[2 * pg] : NEG;
      ll[u] = in ? p.part_ml[2 * pg + 1] : 0.f;
      oo[u] = in ? p.part_o[pg * DH + d] : 0.f;
    }
    float mx = M;
#pragma unroll
    for (int u = 0; u < U; ++u) mx = fmaxf(mx, mm[u]);
    const float a = exp2f(M - mx);
    L *= a;
    O *= a;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float e = exp2f(mm[u] - mx);
      L += ll[u] * e;
      O += oo[u] * e;
    }
    M = mx;
  }
  *out = __float2bfloat16_rn(O / L);
}

// the pool [Nkv * rows * P, Dh] as a 2-D map, boxes of 128 bytes x P rows,
// 128-byte swizzle
bool pool_map(CUtensorMap* map, const void* ptr, bool int8, long long n_rows,
              int Dh, int P) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const int esz = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)Dh, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Dh * esz};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esz), (cuuint32_t)P};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map,
                int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool INT8, int DH>
int launch(const void* k_pages, const void* v_pages, Params p, int B,
           cudaStream_t stream) {
  alignas(64) CUtensorMap mk, mv;
  const long long n_rows = (long long)p.Nkv * p.rows * p.P;
  if (!pool_map(&mk, k_pages, INT8, n_rows, DH, p.P) ||
      !pool_map(&mv, v_pages, INT8, n_rows, DH, p.P))
    return cudaErrorInvalidValue;
  const int esz = INT8 ? 1 : 2;
  p.stage_bytes = (2 * p.P * DH * esz + (INT8 ? 8 * p.P : 0) + 1023) / 1024 *
                  1024;
  // about 64 KB of pages in flight a block (three blocks an SM), never more
  // stages than the split has pages
  p.stages = max(1, min(min(p.pages_per_split, MAX_STAGES),
                        max(2, STAGE_TARGET / p.stage_bytes)));
  const int merge_bytes = 4 * Warps<INT8>::NW * p.G * (DH + 2);
  const int smem = max(p.stages * p.stage_bytes, merge_bytes) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<INT8, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_splits, p.Nkv, B);
  paged_split_kernel<INT8, DH>
      <<<grid, Warps<INT8>::THREADS, smem, stream>>>(mk, mv, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return err;
  paged_merge_kernel<DH><<<B * p.Nq, DH, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B, Nq, Dh] bf16 with element strides q_stride_b, q_stride_h (multiples
// of 8) and a contiguous head dim; k_pages / v_pages [Nkv, rows, P, Dh]
// contiguous, bf16 (kv_int8 = 0) or int8 (kv_int8 = 1, with k_scales /
// v_scales [Nkv, rows, P] fp32 contiguous); lengths [B] int32; page_indices
// [B, pages_per_seq] int32; out [B, Nq, Dh] bf16 contiguous; part_o
// [B, Nkv, n_splits, Nq / Nkv, Dh] and part_ml [.., 2] fp32 scratch (unused
// when n_splits == 1), n_splits = ceil(pages_per_seq / pages_per_split).
// Dh 128 (bf16 pages also 64), Nq / Nkv in {1, 2, 4, 8}, P a multiple of 16
// up to 128, pages_per_split up to 32, all bases 16-byte aligned.
extern "C" int molly_paged_attention_tma(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* lengths,
    const int* page_indices, void* out, float* part_o, float* part_ml, int B,
    int Nq, int Nkv, int Dh, int page_size, int pages_per_seq, int rows,
    int pages_per_split, long long q_stride_b, long long q_stride_h,
    int kv_int8, float scale, void* stream) {
  const int G = Nkv > 0 ? Nq / Nkv : 0;
  if (B <= 0 || Nkv <= 0 || Nq % Nkv != 0 ||
      !(G == 1 || G == 2 || G == 4 || G == 8) || page_size < 16 ||
      page_size > 128 || page_size % 16 != 0 || pages_per_seq <= 0 ||
      rows <= 0 || pages_per_split <= 0 ||
      pages_per_split > MAX_SPLIT_PAGES || q_stride_b % 8 != 0 ||
      q_stride_h % 8 != 0 || !aligned16(q) || !aligned16(k_pages) ||
      !aligned16(v_pages) || !aligned16(out) ||
      (long long)Nkv * rows * page_size > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.lengths = lengths;
  p.page_indices = page_indices;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_o = part_o;
  p.part_ml = part_ml;
  p.q_sb = q_stride_b;
  p.q_sh = q_stride_h;
  p.Nq = Nq;
  p.Nkv = Nkv;
  p.G = G;
  p.P = page_size;
  p.rows = rows;
  p.pages_per_seq = pages_per_seq;
  p.pages_per_split = pages_per_split;
  p.n_splits = (pages_per_seq + pages_per_split - 1) / pages_per_split;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (p.n_splits > 1 && (part_o == nullptr || part_ml == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8) {
    if (Dh != 128 || k_scales == nullptr || v_scales == nullptr ||
        !aligned16(k_scales) || !aligned16(v_scales))
      return cudaErrorInvalidValue;
    return launch<true, 128>(k_pages, v_pages, p, B, s);
  }
  if (Dh == 64) return launch<false, 64>(k_pages, v_pages, p, B, s);
  if (Dh == 128) return launch<false, 128>(k_pages, v_pages, p, B, s);
  return cudaErrorInvalidValue;
}
