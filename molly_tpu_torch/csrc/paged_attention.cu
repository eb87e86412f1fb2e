// Paged flash-decode attention for Hopper (sm_90a): one query token per
// serving slot over a KV cache stored as fixed-size pages named by a page
// table, the pages in fp32, bf16 or int8 with per-row scales.
//
// The SIMT kernel for what paged_attention_tma.cu does not take
// (ops/paged_attention.py:paged_takes_tma is the rule): fp32 q over fp32 or
// int8 pages, and bf16 q at shapes outside that rule (int8 pages at Dh 64,
// page sizes that are not a multiple of 16 or above 128, unaligned views).
// Every bf16 call of the serving paths runs the split TMA kernel. Together
// the two replace:
//   - molly_tpu/ops/paged_attention_int8.py:_kernel (and _kernel_one_block),
//     the Pallas kernel over int8 pages with per-row scales (KV = int8);
//   - the Pallas kernel behind molly_tpu/ops/paged_attention.py's
//     jax.experimental.pallas.ops.tpu.paged_attention call, the same over
//     pages in the model dtype (KV = float | bf16).
//
// What it computes, for slot b and q head h (kv head h / G, G = Nq / Nkv),
// over positions t in [0, lengths[b]): position t lives at
// pages[kv, page_indices[b, t / P], t % P, :].
//   s[t]  = (q . k[t]) * scale            (int8: * k_scale[t] / 127.5)
//   p     = softmax(s) in fp32
//   out   = sum_t p[t] * v[t]             (int8: p[t] * v_scale[t] / 127.5)
// The K scale is applied to the logit after the product and the V scale is
// folded into the softmax weight, as the Pallas kernel does; int8 rows are
// never dequantized to memory. The softmax scale is an argument applied to
// the fp32 logits, as the plain version does (the TPU wrapper instead folds
// it into q and rounds q to its dtype before the call). A slot with
// lengths[b] == 0 gets a zero output row, as the Pallas kernel leaves it.
// Page-table entries at or past ceil(lengths[b] / P) are never read, and
// neither are page rows at or past lengths[b]. Scales are [Nkv, rows, P]
// fp32, one per page row: the TPU's [8, P] sublane-replicated tile is a
// Mosaic layout constraint and is not copied. Any page size is taken (the
// TPU kernel's page_size % 128 rule does not carry over), and there is no
// pages_per_compute_block.
//
// What bounds it on this card: bytes. Every live K and V row is read once
// (2 * Dh * sizeof(KV) bytes a token and kv head, plus 8 bytes of scales for
// int8) for 4 * G * Dh operations, far below the ops-per-byte ridge, so the
// design is about keeping loads in flight, not about the tensor cores:
//   - one block per (slot, kv head); its G query rows live in registers, so
//     K and V are read once for the whole group;
//   - a row of Dh elements is split over DH / VEC neighbouring lanes with one
//     vector load each (16 bytes for fp32 and bf16, 8 bytes for int8), so a
//     warp reads 32 / (DH / VEC) consecutive tokens of a page as one
//     contiguous segment;
//   - each lane group walks the sequence with stride (groups in the block)
//     and takes U = 4 tokens a turn: 4 K loads, then 4 V loads, are issued
//     before their arithmetic, and the running max / sum / [G, VEC]
//     accumulator are rescaled once a turn, not once a token;
//   - the slot's page-table row is staged in shared memory once;
//   - lane groups merge (max, sum, accumulator) by shuffles inside a warp
//     and through shared memory across the 8 warps.
// One block walks a whole sequence and nothing is loaded ahead of its
// arithmetic: the split, TMA-fed tensor-core design is paged_attention_tma.cu.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;               // tokens a lane group takes per turn
constexpr float NEG = -1e30f;      // finite "minus infinity"
constexpr float INV_QMAX = 1.0f / 127.5f;

enum KvType : int { kKvFloat32 = 0, kKvBFloat16 = 1, kKvInt8 = 2 };

// VEC elements of a page row as one vector load, converted to fp32
template <typename KVT>
struct Row;

template <>
struct Row<float> {
  static constexpr int VEC = 4;
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void clear() { raw = make_float4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_float(float (&f)[VEC]) const {
    f[0] = raw.x; f[1] = raw.y; f[2] = raw.z; f[3] = raw.w;
  }
};

template <>
struct Row<__nv_bfloat16> {
  static constexpr int VEC = 8;
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void clear() { raw = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_float(float (&f)[VEC]) const {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the top half of an fp32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Row<int8_t> {
  static constexpr int VEC = 8;
  uint2 raw;
  __device__ __forceinline__ void load(const int8_t* p) {
    raw = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void clear() { raw = make_uint2(0, 0); }
  __device__ __forceinline__ void to_float(float (&f)[VEC]) const {
    // int8 -> fp32 without the slow integer conversion: bias each byte to
    // unsigned (x ^ 0x80 = x + 128), place it in the low mantissa byte of
    // 2^23 (0x4B000000 | b is the float 2^23 + b), subtract 2^23 + 128
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = __uint_as_float(__byte_perm(w[i >> 2], 0x4B000000u,
                                         0x7650u | (i & 3))) - 8388736.f;
  }
};

template <typename QT, typename KVT, int DH, int G>
__global__ void __launch_bounds__(THREADS)
    paged_attention_kernel(const QT* __restrict__ q,
                           const KVT* __restrict__ k_pages,
                           const KVT* __restrict__ v_pages,
                           const float* __restrict__ k_scales,
                           const float* __restrict__ v_scales,
                           const int* __restrict__ lengths,
                           const int* __restrict__ page_indices,
                           QT* __restrict__ out, int n_q_heads,
                           int pages_per_seq, int page_size,
                           long long pool_rows, long long q_stride_b,
                           long long q_stride_h, int table_words,
                           float scale) {
  constexpr int VEC = Row<KVT>::VEC;
  constexpr int LPR = DH / VEC;    // lanes that share one page row
  constexpr int TPW = 32 / LPR;    // rows a warp reads with one load each
  constexpr int NG = WARPS * TPW;  // lane groups in the block
  constexpr bool QUANT = sizeof(KVT) == 1;
  static_assert(DH % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "row split");

  extern __shared__ __align__(16) int smem[];
  int* table = smem;                                    // [table_words]
  float* red_m = reinterpret_cast<float*>(smem + table_words);  // [WARPS][G]
  float* red_l = red_m + WARPS * G;                     // [WARPS][G]
  float* red_acc = red_l + WARPS * G;                   // [WARPS][G][DH]

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int lir = lane % LPR;              // lane in row
  const int grp = warp * TPW + lane / LPR;  // lane group in block
  const int len = lengths[b];
  QT* out_b = out + ((long long)b * n_q_heads + (long long)h * G) * DH;

  if (len <= 0) {  // an empty slot: a zero row
    for (int idx = tid; idx < G * DH; idx += THREADS)
      out_b[idx] = molly::from_float<QT>(0.f);
    return;
  }

  const int n_used = (len + page_size - 1) / page_size;
  for (int i = tid; i < n_used; i += THREADS)
    table[i] = page_indices[(long long)b * pages_per_seq + i];

  float qf[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const QT* qrow = q + (long long)b * q_stride_b +
                     (long long)(h * G + g) * q_stride_h + lir * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) qf[g][i] = molly::to_float(qrow[i]);
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }
  __syncthreads();

  const long long head_row0 = (long long)h * pool_rows;  // in pages
  // the trip count is the same for every lane (the shuffles below need the
  // whole warp); a group past the end of the sequence carries dead tokens
  for (int base = 0; base < len; base += NG * U) {
    const int t0 = base + grp;
    bool ok[U];
    long long row[U];  // page row index: ((head, page), offset)
    Row<KVT> kr[U], vr[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * NG;
      ok[u] = t < len;
      ksc[u] = 1.f;
      if (ok[u]) {
        const int pg = t / page_size;
        row[u] = (head_row0 + table[pg]) * page_size + (t - pg * page_size);
        kr[u].load(k_pages + row[u] * DH + lir * VEC);
        if (QUANT) ksc[u] = k_scales[row[u]] * INV_QMAX;
      } else {
        row[u] = 0;
        kr[u].clear();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      vsc[u] = 1.f;
      if (ok[u]) {
        vr[u].load(v_pages + row[u] * DH + lir * VEC);
        if (QUANT) vsc[u] = v_scales[row[u]] * INV_QMAX;
      } else {
        vr[u].clear();
      }
    }

    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      kr[u].to_float(kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) d = fmaf(qf[g][i], kf[i], d);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][g] = ok[u] ? d * ksc[u] * scale : NEG;
      }
    }

    // one rescale a turn; a turn with no live token leaves (m, l, acc) as
    // they were (alpha = 1, every weight 0)
    float w[U][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = __expf(m[g] - mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? __expf(s[u][g] - mx) : 0.f;
        sum += p;
        w[u][g] = p * vsc[u];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      vr[u].to_float(vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[g][i] = fmaf(w[u][g], vf[i], acc[g][i]);
    }
  }

  // merge the lane groups of a warp (they differ in the lane bits >= LPR)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], m_o);
      const float a = __expf(m[g] - mx), c = __expf(m_o - mx);
      l[g] = l[g] * a + l_o * c;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + acc_o * c;
      }
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        red_m[warp * G + g] = m[g];
        red_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        red_acc[(warp * G + g) * DH + lir * VEC + i] = acc[g][i];
    }
  }
  __syncthreads();

  // merge the warps; len >= 1, so the sum is positive
  for (int idx = tid; idx < G * DH; idx += THREADS) {
    const int g = idx / DH, d = idx % DH;
    float mx = NEG;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) mx = fmaxf(mx, red_m[wi * G + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) {
      const float e = __expf(red_m[wi * G + g] - mx);
      L += red_l[wi * G + g] * e;
      O += red_acc[(wi * G + g) * DH + d] * e;
    }
    out_b[idx] = molly::from_float<QT>(O / L);
  }
}

struct Args {
  const void *q, *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *lengths, *page_indices;
  void* out;
  int B, Nq, Nkv, page_size, pages_per_seq;
  long long pool_rows, q_stride_b, q_stride_h;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename KVT, int DH, int G>
int launch(const Args& a) {
  const int table_words = (a.pages_per_seq + 3) / 4 * 4;
  const size_t smem = sizeof(int) * table_words +
                      sizeof(float) * WARPS * G * (DH + 2);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(a.B, a.Nkv);
  paged_attention_kernel<QT, KVT, DH, G><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.k_pages),
      static_cast<const KVT*>(a.v_pages), a.k_scales, a.v_scales, a.lengths,
      a.page_indices, static_cast<QT*>(a.out), a.Nq, a.pages_per_seq,
      a.page_size, a.pool_rows, a.q_stride_b, a.q_stride_h, table_words,
      a.scale);
  return cudaGetLastError();
}

template <typename QT, typename KVT, int DH>
int launch_g(const Args& a, int G) {
  switch (G) {
    case 1: return launch<QT, KVT, DH, 1>(a);
    case 2: return launch<QT, KVT, DH, 2>(a);
    case 4: return launch<QT, KVT, DH, 4>(a);
    case 8: return launch<QT, KVT, DH, 8>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename QT, typename KVT>
int launch_dh(const Args& a, int Dh, int G) {
  if (Dh == 64) return launch_g<QT, KVT, 64>(a, G);
  if (Dh == 128) return launch_g<QT, KVT, 128>(a, G);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Nq, Dh] in q_dtype (0 fp32, 1 bf16) with element strides q_stride_b,
// q_stride_h and a contiguous head dim; k_pages / v_pages [Nkv, pool_rows, P,
// Dh] contiguous in kv_dtype (0 fp32, 1 bf16: the same as q_dtype; 2 int8
// with k_scales / v_scales [Nkv, pool_rows, P] fp32); lengths [B] int32;
// page_indices [B, pages_per_seq] int32; out [B, Nq, Dh] contiguous in
// q_dtype. Dh in {64, 128}, Nq / Nkv in {1, 2, 4, 8}.
extern "C" int molly_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* lengths,
    const int* page_indices, void* out, int B, int Nq, int Nkv, int Dh,
    int page_size, int pages_per_seq, long long pool_rows,
    long long q_stride_b, long long q_stride_h, int q_dtype, int kv_dtype,
    float scale, void* stream) {
  if (B <= 0 || Nkv <= 0 || Nq % Nkv != 0 || page_size <= 0 ||
      pages_per_seq <= 0)
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, lengths,
               page_indices, out, B, Nq, Nkv, page_size, pages_per_seq,
               pool_rows, q_stride_b, q_stride_h, scale,
               static_cast<cudaStream_t>(stream)};
  const int G = Nq / Nkv;
  if (kv_dtype == kKvInt8) {
    if (k_scales == nullptr || v_scales == nullptr)
      return cudaErrorInvalidValue;
    if (q_dtype == molly::kFloat32)
      return launch_dh<float, int8_t>(a, Dh, G);
    if (q_dtype == molly::kBFloat16)
      return launch_dh<__nv_bfloat16, int8_t>(a, Dh, G);
    return cudaErrorInvalidValue;
  }
  if (kv_dtype == kKvFloat32 && q_dtype == molly::kFloat32)
    return launch_dh<float, float>(a, Dh, G);
  if (kv_dtype == kKvBFloat16 && q_dtype == molly::kBFloat16)
    return launch_dh<__nv_bfloat16, __nv_bfloat16>(a, Dh, G);
  return cudaErrorInvalidValue;
}
