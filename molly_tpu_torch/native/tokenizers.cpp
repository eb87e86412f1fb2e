// Native sequence tokenizers for the molly_tpu_torch input pipeline (a copy of molly_tpu/native/tokenizers.cpp).
//
// The reference's performance-critical code all lives in native
// dependencies (the upstream project); on the accelerator side the input pipeline is the
// host-bound hot path (single host core feeding the chips), so the two
// modality tokenizers are implemented here and exposed over a C ABI for
// ctypes. Semantics are identical to molly_tpu_torch.data.tokenizers:
//
//   nucleotide (nucleotide-transformer 6-mer):
//     vocab = [<unk> <pad> <mask> <cls> <eos> <bos>] + 4096 6-mers over
//     "ATCG" (A=0,T=1,C=2,G=3, big-endian) + [A T C G N]
//     encode = <cls> + greedy 6-mers (per-char fallback), truncate to
//     max_len, pad with 1. U is treated as T.
//
//   protein (ESM-2 alphabet):
//     <cls> + residues + <eos>, truncated to max_len keeping cls/eos,
//     padded with 1; unknown chars -> <unk>=3.
//
// Batch API: sequences are passed as one concatenated byte buffer plus
// offsets, outputs as one [n, max_len] int32 buffer.

#include <cstdint>
#include <cstring>

namespace {

constexpr int32_t NT_UNK = 0, NT_PAD = 1, NT_CLS = 3;
constexpr int32_t NT_KMER_BASE = 6;        // first 6-mer id
constexpr int32_t NT_SINGLE_BASE = 6 + 4096;  // A T C G N

// base-4 digit for a nucleotide in "ATCG" order; -1 if not ACGT
inline int nt_digit(char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'T': case 't': return 1;
    case 'U': case 'u': return 1;  // RNA on DNA alphabet
    case 'C': case 'c': return 2;
    case 'G': case 'g': return 3;
    default: return -1;
  }
}

inline int32_t nt_single_id(char c) {
  switch (c) {
    case 'A': case 'a': return NT_SINGLE_BASE + 0;
    case 'T': case 't': case 'U': case 'u': return NT_SINGLE_BASE + 1;
    case 'C': case 'c': return NT_SINGLE_BASE + 2;
    case 'G': case 'g': return NT_SINGLE_BASE + 3;
    case 'N': case 'n': return NT_SINGLE_BASE + 4;
    default: return NT_UNK;
  }
}

constexpr int32_t P_CLS = 0, P_PAD = 1, P_EOS = 2, P_UNK = 3;

// ESM vocab order: <cls> <pad> <eos> <unk> L A G V S E R T I D P K Q N F Y
// M H W C X B U Z O . - <null_1> <mask>
int32_t protein_table(char c) {
  switch (c) {
    case 'L': return 4;  case 'A': return 5;  case 'G': return 6;
    case 'V': return 7;  case 'S': return 8;  case 'E': return 9;
    case 'R': return 10; case 'T': return 11; case 'I': return 12;
    case 'D': return 13; case 'P': return 14; case 'K': return 15;
    case 'Q': return 16; case 'N': return 17; case 'F': return 18;
    case 'Y': return 19; case 'M': return 20; case 'H': return 21;
    case 'W': return 22; case 'C': return 23; case 'X': return 24;
    case 'B': return 25; case 'U': return 26; case 'Z': return 27;
    case 'O': return 28; case '.': return 29; case '-': return 30;
    default: return P_UNK;
  }
}

inline char upper(char c) {
  return (c >= 'a' && c <= 'z') ? static_cast<char>(c - 32) : c;
}

}  // namespace

extern "C" {

// Encode one nucleotide sequence into out[max_len]. Returns #real tokens.
int32_t nt_encode(const char* seq, int32_t len, int32_t max_len,
                  int32_t* out) {
  int32_t w = 0;
  if (w < max_len) out[w++] = NT_CLS;
  int32_t i = 0;
  while (i < len && w < max_len) {
    // try a 6-mer
    if (i + 6 <= len) {
      int32_t idx = 0;
      bool ok = true;
      for (int k = 0; k < 6; ++k) {
        int d = nt_digit(seq[i + k]);
        if (d < 0) { ok = false; break; }
        idx = idx * 4 + d;
      }
      if (ok) {
        out[w++] = NT_KMER_BASE + idx;
        i += 6;
        continue;
      }
    }
    out[w++] = nt_single_id(seq[i]);
    i += 1;
  }
  int32_t real = w;
  while (w < max_len) out[w++] = NT_PAD;
  return real;
}

// Encode one protein sequence: <cls> seq[:max_len-2] <eos>, pad with 1.
int32_t protein_encode(const char* seq, int32_t len, int32_t max_len,
                       int32_t* out) {
  int32_t w = 0;
  if (w < max_len) out[w++] = P_CLS;
  int32_t body = len < max_len - 2 ? len : (max_len >= 2 ? max_len - 2 : 0);
  for (int32_t i = 0; i < body && w < max_len; ++i)
    out[w++] = protein_table(upper(seq[i]));
  if (w < max_len) out[w++] = P_EOS;
  int32_t real = w;
  while (w < max_len) out[w++] = NT_PAD;  // pad id 1 for both vocabs
  return real;
}

// Batch APIs: buf holds all sequences back to back; offsets[n+1] frames
// them; out is [n, max_len] row-major.
void nt_encode_batch(const char* buf, const int64_t* offsets, int32_t n,
                     int32_t max_len, int32_t* out) {
  for (int32_t s = 0; s < n; ++s) {
    const char* seq = buf + offsets[s];
    int32_t len = static_cast<int32_t>(offsets[s + 1] - offsets[s]);
    nt_encode(seq, len, max_len, out + static_cast<int64_t>(s) * max_len);
  }
}

void protein_encode_batch(const char* buf, const int64_t* offsets,
                          int32_t n, int32_t max_len, int32_t* out) {
  for (int32_t s = 0; s < n; ++s) {
    const char* seq = buf + offsets[s];
    int32_t len = static_cast<int32_t>(offsets[s + 1] - offsets[s]);
    protein_encode(seq, len, max_len,
                   out + static_cast<int64_t>(s) * max_len);
  }
}

}  // extern "C"
