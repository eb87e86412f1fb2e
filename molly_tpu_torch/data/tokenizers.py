"""Tokenizers for the three modalities: text, DNA/RNA (6-mer), protein (per-residue).

Mirrors the reference's tokenizer usage without depending on downloaded
vocabulary files:

  - Protein: the ESM-2 alphabet (reference loads the HF ESM tokenizer,
    src/train.py:86-88; encoding call at
    src/dataset/omics_dataset.py:437-444 with
    padding="max_length", truncation=True, max_length=k).
  - DNA/RNA: the nucleotide-transformer 6-mer tokenizer (greedy 6-mers with
    single-nucleotide fallback; pad id 1 — the fusion model's encoder
    attention mask is literally ``tokens != 1``, see
    src/model/omics_one.py:70).
  - Text: either a local HF tokenizer (wrapped) or a self-contained
    byte-level tokenizer for tests/demos. Both expose the Qwen chat special
    tokens plus the 9 omics special tokens the reference appends
    (src/train.py:73-85).
"""

from __future__ import annotations

import itertools
import os
from typing import List, Optional, Sequence

import numpy as np

# The 9 omics special tokens, in the exact order the reference appends them
# to the Qwen tokenizer (src/train.py:73-85). Order matters:
# ids are assigned by append order.
OMICS_SPECIAL_TOKENS = (
    "<|dna_start|>",
    "<|dna_pad|>",
    "<|dna_end|>",
    "<|rna_start|>",
    "<|rna_pad|>",
    "<|rna_end|>",
    "<|protein_start|>",
    "<|protein_pad|>",
    "<|protein_end|>",
)

SYSTEM_PROMPT_TEXT = (
    "<|im_start|>system\nYou are a helpful knowledgeable and precise "
    "biomedical assistant.<|im_end|>\n<|im_start|>user\n"
)
ASSISTANT_START_TEXT = "<|im_end|>\n<|im_start|>assistant\n"


# --------------------------------------------------------------------------
# Protein tokenizer (ESM-2 alphabet)
# --------------------------------------------------------------------------

# The canonical ESM alphabet used by all facebook/esm2_* checkpoints.
ESM_VOCAB: tuple = (
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K",
    "Q", "N", "F", "Y", "M", "H", "W", "C",
    "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
)


class ProteinTokenizer:
    """ESM-2 amino-acid tokenizer: ``<cls> residues... <eos>`` padded with 1."""

    def __init__(self):
        self.vocab = list(ESM_VOCAB)
        self.token_to_id = {t: i for i, t in enumerate(self.vocab)}
        self.cls_id = self.token_to_id["<cls>"]
        self.pad_id = self.token_to_id["<pad>"]  # == 1, load-bearing
        self.eos_id = self.token_to_id["<eos>"]
        self.unk_id = self.token_to_id["<unk>"]
        self.mask_id = self.token_to_id["<mask>"]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, seq: str, max_length: int) -> np.ndarray:
        """Fixed-length encoding matching HF ``padding='max_length',
        truncation=True``: ``[cls] + seq[:max_length-2] + [eos]`` then pad."""
        body = [self.token_to_id.get(c, self.unk_id) for c in seq.upper()]
        body = body[: max(0, max_length - 2)]
        ids = [self.cls_id] + body + [self.eos_id]
        ids = ids[:max_length]
        ids += [self.pad_id] * (max_length - len(ids))
        return np.asarray(ids, dtype=np.int32)


# --------------------------------------------------------------------------
# DNA/RNA tokenizer (nucleotide-transformer 6-mer)
# --------------------------------------------------------------------------


class NucleotideTokenizer:
    """Nucleotide-transformer k-mer tokenizer.

    Vocabulary: 6 specials, then all 4096 6-mers over ACGT, then the single
    nucleotides A/T/C/G/N. Sequences are greedily split into 6-mers from the
    left; any chunk containing a non-ACGT char (or a tail shorter than 6)
    falls back to per-nucleotide tokens. A ``<cls>`` is prepended; pad id is
    1 (``<pad>``) so the fusion encoder mask ``tokens != 1`` works for both
    modalities.
    """

    def __init__(self, kmer: int = 6):
        self.kmer = kmer
        specials = ["<unk>", "<pad>", "<mask>", "<cls>", "<eos>", "<bos>"]
        kmers = ["".join(p) for p in itertools.product("ATCG", repeat=kmer)]
        singles = ["A", "T", "C", "G", "N"]
        self.vocab = specials + kmers + singles
        self.token_to_id = {t: i for i, t in enumerate(self.vocab)}
        self.unk_id = self.token_to_id["<unk>"]
        self.pad_id = self.token_to_id["<pad>"]  # == 1, load-bearing
        self.mask_id = self.token_to_id["<mask>"]
        self.cls_id = self.token_to_id["<cls>"]
        self.eos_id = self.token_to_id["<eos>"]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, seq: str) -> List[str]:
        seq = seq.upper().replace("U", "T")  # RNA handled on DNA alphabet
        toks: List[str] = []
        i = 0
        n = len(seq)
        while i < n:
            chunk = seq[i : i + self.kmer]
            if len(chunk) == self.kmer and chunk in self.token_to_id:
                toks.append(chunk)
                i += self.kmer
            else:
                toks.append(seq[i])
                i += 1
        return toks

    def encode(self, seq: str, max_length: int) -> np.ndarray:
        body = [self.token_to_id.get(t, self.unk_id) for t in self.tokenize(seq)]
        ids = [self.cls_id] + body
        ids = ids[:max_length]
        ids += [self.pad_id] * (max_length - len(ids))
        return np.asarray(ids, dtype=np.int32)


# --------------------------------------------------------------------------
# Text tokenizers
# --------------------------------------------------------------------------


class ByteTextTokenizer:
    """Self-contained byte-level text tokenizer with Qwen-style specials.

    Ids 0-255 are raw bytes; then ``<|endoftext|>`` (pad), ``<|im_start|>``,
    ``<|im_end|>`` (eos), then the 9 omics special tokens in reference order.
    Used for tests, demos, and any run without a local Qwen vocabulary; the
    production path wraps a local HF tokenizer (:class:`HFTextTokenizer`).
    """

    BASE_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")

    def __init__(self):
        self._specials: List[str] = list(self.BASE_SPECIALS) + list(
            OMICS_SPECIAL_TOKENS
        )
        self._special_to_id = {t: 256 + i for i, t in enumerate(self._specials)}
        self.pad_token_id = self._special_to_id["<|endoftext|>"]
        self.eos_token_id = self._special_to_id["<|im_end|>"]

    @property
    def vocab_size(self) -> int:
        return 256 + len(self._specials)

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self._special_to_id:
            return self._special_to_id[token]
        raise KeyError(f"unknown special token: {token!r}")

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        del add_special_tokens
        ids: List[int] = []
        i = 0
        while i < len(text):
            matched = None
            if text[i] == "<":
                for sp in self._specials:
                    if text.startswith(sp, i):
                        matched = sp
                        break
            if matched is not None:
                ids.append(self._special_to_id[matched])
                i += len(matched)
            else:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            nonlocal byte_buf
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf = bytearray()

        for i in ids:
            i = int(i)
            if i < 256:
                byte_buf.append(i)
            elif i - 256 < len(self._specials):
                flush()
                tok = self._specials[i - 256]
                if not skip_special_tokens:
                    out.append(tok)
            else:  # out-of-vocab id (e.g. model vocab padded past tokenizer)
                flush()
                if not skip_special_tokens:
                    out.append("�")
        flush()
        return "".join(out)


class HFTextTokenizer:
    """Wraps a locally available HF tokenizer (e.g. Qwen3) and appends the 9
    omics special tokens, mirroring src/train.py:66-91."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer  # local files only; no network

        self._tok = AutoTokenizer.from_pretrained(path, trust_remote_code=True)
        self._tok.add_special_tokens(
            {"additional_special_tokens": list(OMICS_SPECIAL_TOKENS)}
        )
        self.pad_token_id = self._tok.pad_token_id
        self.eos_token_id = self._tok.eos_token_id

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._tok.convert_tokens_to_ids(token)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def save(self, path: str) -> None:
        """Serialize the EXTENDED tokenizer (base vocab + the 9 appended
        omics tokens). Special-token ids depend on append order
        (src/train.py:73-85), so shipping the extended
        tokenizer with checkpoints removes id drift."""
        self._tok.save_pretrained(path)


def load_text_tokenizer(path: Optional[str] = None):
    """Load the production HF tokenizer from ``path`` or fall back to bytes."""
    if path and os.path.isdir(path):
        return HFTextTokenizer(path)
    return ByteTextTokenizer()
