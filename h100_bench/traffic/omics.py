"""The omics mix: rows ``{task, kind, input, output, think, label}`` with
inline ``<dna>/<rna>/<protein>`` tags, the rows the reference's datasets
hold, drawn from a seed by the parameters of a traffic file's ``mix``.

Every batch holds the same multiset of shapes: how many samples of each
kind (largest remainders of the shares), and every sequence, question,
reasoning and answer length at the stratified quantiles of its log-uniform
range. The seed picks the letters, the words and the order only, so every
seed asks for the same work and the spread between seeds is the system's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np

NUCLEOTIDES = np.array(list("ACGT"))
RESIDUES = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
WORDS = ("the", "sequence", "given", "predict", "whether", "this", "region",
         "protein", "binds", "expression", "level", "of", "is", "a", "and",
         "which", "class", "answer", "with", "score", "stability", "site",
         "promoter", "enhancer", "activity", "function", "label", "cell")
MODALITY = {"dna": "dna_rna", "rna": "dna_rna", "protein": "protein"}


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, *stream])


def kind_counts(samples: Sequence[Dict[str, Any]], n: int) -> List[int]:
    """Rows of each sample kind in a batch of ``n``: largest remainders of
    ``share * n``, ties to the earlier kind."""
    raw = [s["share"] * n for s in samples]
    counts = [math.floor(r) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: (counts[i] - raw[i], i))
    for i in order[: n - sum(counts)]:
        counts[i] += 1
    return counts


def strata(lo: float, hi: float, n: int) -> List[int]:
    """n lengths at the midpoints of n equal strata of log-uniform[lo, hi]."""
    a, b = math.log(lo), math.log(hi)
    return [int(round(math.exp(a + (i + 0.5) / n * (b - a))))
            for i in range(n)]


def _text(rng: np.random.Generator, n: int) -> str:
    """n characters of words (the byte-level tokenizer's n tokens)."""
    out = ""
    while len(out) < n:
        out += str(rng.choice(WORDS)) + " "
    return out[:n].strip().ljust(n, "s")


def _sequence(rng: np.random.Generator, kind: str, n: int) -> str:
    alphabet = RESIDUES if kind == "protein" else NUCLEOTIDES
    return "".join(rng.choice(alphabet, n))


def batch_rows(mix: Dict[str, Any], batch_size: int, seed: int,
               index: int) -> List[Dict[str, Any]]:
    """The rows of batch ``index`` (any int; the warm-up uses -1)."""
    rng = _rng(seed, index + 2 ** 31)
    kinds = [s for s, c in zip(mix["samples"],
                               kind_counts(mix["samples"], batch_size))
             for _ in range(c)]
    rng.shuffle(kinds)
    # every segment of a modality takes one stratum of its range
    segs = [(r, j, kind) for r, s in enumerate(kinds)
            for j, kind in enumerate(s["segments"])]
    seg_len = {}
    for modality in ("dna_rna", "protein"):
        mine = [x for x in segs if MODALITY[x[2]] == modality]
        lo, hi = mix["lengths"][modality]
        for x, n in zip(mine, rng.permutation(strata(lo, hi, len(mine)))):
            seg_len[x[:2]] = int(n)

    def lengths(key):
        lo, hi = mix[key]
        return [int(n) for n in rng.permutation(strata(lo, hi, batch_size))]

    q_len = lengths("question_tokens")
    think_len = lengths("think_tokens") if "think_tokens" in mix else None
    out_len = lengths("output_tokens") if "output_tokens" in mix else None
    rows = []
    for r, s in enumerate(kinds):
        parts = len(s["segments"]) + 1
        cuts = sorted(int(c) for c in rng.integers(0, q_len[r] + 1,
                                                   parts - 1))
        bounds = [0, *cuts, q_len[r]]
        words = _text(rng, q_len[r])
        pieces = [words[bounds[0]:bounds[1]]]
        for j, kind in enumerate(s["segments"]):
            seq = _sequence(rng, kind, seg_len[(r, j)])
            pieces.append(f"<{kind}>{seq}</{kind}>")
            pieces.append(words[bounds[j + 1]:bounds[j + 2]])
        rows.append({
            "task": s["task"], "kind": s["kind"],
            "input": " ".join(p for p in pieces if p),
            "think": _text(rng, think_len[r]) if think_len else "",
            "output": _text(rng, out_len[r]) if out_len else "yes",
            "label": "1",
        })
    return rows
