"""Prompts built again from a raw row, apart from the program's data path:
the chat template, the byte-level text tokens with the Qwen and omics
special tokens, each tagged sequence spliced in as start + k placeholders +
end, and the sequence itself tokenized by the nucleotide-transformer 6-mer
rule or the ESM-2 alphabet. The tables are a frozen copy of the
tokenizers' definitions; the code is written anew.

The traffic never needs truncation (two segments of 1,026 placeholders and
a short question stay well under the maximum length), so a prompt longer
than the maximum raises rather than guess at a rule."""

from __future__ import annotations

import itertools
import re
from typing import Any, Dict, List, Tuple

SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>",
            "<|dna_start|>", "<|dna_pad|>", "<|dna_end|>",
            "<|rna_start|>", "<|rna_pad|>", "<|rna_end|>",
            "<|protein_start|>", "<|protein_pad|>", "<|protein_end|>")
SPECIAL_ID = {t: 256 + i for i, t in enumerate(SPECIALS)}
PAD_ID = SPECIAL_ID["<|endoftext|>"]
EOS_ID = SPECIAL_ID["<|im_end|>"]
SYSTEM = ("<|im_start|>system\nYou are a helpful knowledgeable and precise "
          "biomedical assistant.<|im_end|>\n<|im_start|>user\n")
ASSISTANT = "<|im_end|>\n<|im_start|>assistant\n"
TAGS = {"dna": re.compile(r"<dna>\s*([ACGTNacgtn]+)\s*</dna>"),
        "rna": re.compile(r"<rna>\s*([ACGTNacgtn]+)\s*</rna>"),
        "protein": re.compile(
            r"<protein>\s*([ACDEFGHIKLMNPQRSTVWYBXZOU]+)\s*</protein>")}

ESM_ALPHABET = ("<cls>", "<pad>", "<eos>", "<unk>", "L", "A", "G", "V", "S",
                "E", "R", "T", "I", "D", "P", "K", "Q", "N", "F", "Y", "M",
                "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
                "<null_1>", "<mask>")
ESM_ID = {t: i for i, t in enumerate(ESM_ALPHABET)}
NT_TOKENS = (["<unk>", "<pad>", "<mask>", "<cls>", "<eos>", "<bos>"]
             + ["".join(p) for p in itertools.product("ATCG", repeat=6)]
             + ["A", "T", "C", "G", "N"])
NT_ID = {t: i for i, t in enumerate(NT_TOKENS)}
ENCODER_PAD = 1


def text_ids(text: str) -> List[int]:
    """Bytes, with the special tokens matched whole."""
    out, i = [], 0
    while i < len(text):
        for sp in SPECIALS:
            if text.startswith(sp, i):
                out.append(SPECIAL_ID[sp])
                i += len(sp)
                break
        else:
            out.extend(text[i].encode("utf-8"))
            i += 1
    return out


def nucleotide_ids(seq: str, k: int) -> List[int]:
    seq = seq.upper().replace("U", "T")
    ids, i = [NT_ID["<cls>"]], 0
    while i < len(seq):
        six = seq[i:i + 6]
        if len(six) == 6 and six in NT_ID:
            ids.append(NT_ID[six])
            i += 6
        else:
            ids.append(NT_ID.get(seq[i], NT_ID["<unk>"]))
            i += 1
    ids = ids[:k]
    return ids + [ENCODER_PAD] * (k - len(ids))


def protein_ids(seq: str, k: int) -> List[int]:
    body = [ESM_ID.get(c, ESM_ID["<unk>"]) for c in seq.upper()][:k - 2]
    ids = ([ESM_ID["<cls>"]] + body + [ESM_ID["<eos>"]])[:k]
    return ids + [ENCODER_PAD] * (k - len(ids))


def build(row: Dict[str, Any], k: Dict[str, int], max_len: int
          ) -> Tuple[List[int], List[Tuple[str, int, List[int]]]]:
    """(prompt ids without padding, [(modality, start, encoder ids [k])])
    where ``start`` indexes the segment's start token; its k placeholders
    follow it. ``k`` maps ``dna_rna`` and ``protein`` to their slot
    widths."""
    text = (row.get("input") or "").strip()
    found = sorted((m.start(), m.end(), kind, m.group(1))
                   for kind, rx in TAGS.items() for m in rx.finditer(text))
    ids = text_ids(SYSTEM)
    segments = []
    cursor = 0
    for s, e, kind, seq in found:
        ids += text_ids(text[cursor:s])
        modality = "protein" if kind == "protein" else "dna_rna"
        width = k[modality]
        enc = (protein_ids(seq, width) if modality == "protein"
               else nucleotide_ids(seq, width))
        segments.append((modality, len(ids), enc))
        ids += ([SPECIAL_ID[f"<|{kind}_start|>"]]
                + [SPECIAL_ID[f"<|{kind}_pad|>"]] * width
                + [SPECIAL_ID[f"<|{kind}_end|>"]])
        cursor = e
    ids += text_ids(text[cursor:]) + text_ids(ASSISTANT)
    if len(ids) > max_len:
        raise ValueError(f"prompt of {len(ids)} tokens over {max_len}: the "
                         f"reference does not truncate")
    return ids, segments
