"""Classification dataset for the encoder + head baselines, the counterpart
of ``molly_tpu/baselines/dataset.py``.

Per-model-type sequence extraction and pairing, pad id 1, and the label
rules: binary positive/negative, float regression, or a ``label2id``
multihot with the "EC" prefix stripped. Both tag styles are accepted
(``<dna>..</dna>`` and the baseline data's ``<dna>..<dna>``).

``source`` is a parquet path or a DataFrame (pandas, imported only then) or
an in-memory list of row dicts with ``input`` and ``label``, so a caller
without pandas can use it. The shuffle draws the permutation
``DataFrame.sample(frac=1, random_state=np.random.default_rng(seed))``
draws, so a seed gives the JAX package's order either way.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np

# accept both <dna>..</dna> (main pipeline) and <dna>..<dna> (the baseline
# data format)
REGEX = {
    "dna": re.compile(r"<dna>\s*([ACGTNacgtn]+)\s*</?dna>"),
    "rna": re.compile(r"<rna>\s*([ACGTNacgtn]+)\s*</?rna>"),
    "protein": re.compile(
        r"<protein>\s*([ACDEFGHIKLMNPQRSTVWYBXZOU]+)\s*</?protein>"),
}

PAD_ID = 1


def _rows(source) -> List[Dict[str, Any]]:
    if isinstance(source, str):
        import pandas as pd
        source = pd.read_parquet(source)
    if hasattr(source, "to_dict") and hasattr(source, "columns"):
        source = source.reset_index(drop=True)
        return [source.loc[i].to_dict() for i in range(len(source))]
    return [dict(r) for r in source]


def shuffle_order(n: int, seed: int) -> np.ndarray:
    """The row order of ``DataFrame.sample(frac=1,
    random_state=np.random.default_rng(seed))``: pandas draws
    ``Generator.choice(n, size=n, replace=False)``."""
    return np.random.default_rng(seed).choice(n, size=n, replace=False)


class ClassificationDataset:
    def __init__(self, source, model_type: str,
                 dna_rna_tokenizer=None, protein_tokenizer=None,
                 dna_rna_k_tokens: int = 1024, protein_k_tokens: int = 1024,
                 label2id: Optional[Dict[str, int]] = None,
                 multi_label: bool = False, shuffle: bool = False,
                 seed: int = 42):
        self.rows = _rows(source)
        if shuffle:
            self.rows = [self.rows[int(i)]
                         for i in shuffle_order(len(self.rows), seed)]
        self.model_type = model_type
        self.dna_tok = dna_rna_tokenizer
        self.prot_tok = protein_tokenizer
        self.k_dna = dna_rna_k_tokens
        self.k_prot = protein_k_tokens
        self.label2id = label2id
        self.multi_label = multi_label

    def __len__(self):
        return len(self.rows)

    def _extract(self, text: str) -> Dict[str, List[str]]:
        return {k: [m.group(1).upper() for m in pat.finditer(text)]
                for k, pat in REGEX.items()}

    def _label(self, label):
        if self.multi_label:
            label = str(label).replace("EC", "")
            vec = np.zeros(len(self.label2id), np.float32)
            hit = False
            for lab in label.split(","):
                lab = lab.strip()
                if lab in self.label2id:
                    vec[self.label2id[lab]] = 1.0
                    hit = True
            if not hit:
                raise ValueError(f"no label of {label!r} in label2id")
            return vec
        if label in ("positive", "negative"):
            return np.int32(1 if label == "positive" else 0)
        try:
            f = float(label)
            return np.int32(f) if float(f).is_integer() and not isinstance(
                label, float) else np.float32(f)
        except (TypeError, ValueError):
            raise ValueError(f"unparseable label {label!r}")

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.rows[idx]
        seqs = self._extract((row.get("input") or "").strip())
        label = self._label(str(row.get("label", "")).strip())
        out: Dict[str, np.ndarray] = {"labels": label}

        t = self.model_type
        nts = seqs["dna"] + seqs["rna"]
        if t == "NT":
            assert len(nts) == 1, "NT requires exactly one DNA/RNA sequence"
            out["x1"] = self.dna_tok.encode(nts[0], self.k_dna)
        elif t == "ESM":
            assert len(seqs["protein"]) == 1
            out["x1"] = self.prot_tok.encode(seqs["protein"][0], self.k_prot)
        elif t == "NT+ESM":
            assert len(nts) == 1 and len(seqs["protein"]) == 1
            out["x1"] = self.dna_tok.encode(nts[0], self.k_dna)
            out["x2"] = self.prot_tok.encode(seqs["protein"][0], self.k_prot)
        elif t == "NT+NT":
            assert len(nts) == 2
            out["x1"] = self.dna_tok.encode(nts[0], self.k_dna)
            out["x2"] = self.dna_tok.encode(nts[1], self.k_dna)
        elif t == "ESM+ESM":
            assert len(seqs["protein"]) == 2
            out["x1"] = self.prot_tok.encode(seqs["protein"][0], self.k_prot)
            out["x2"] = self.prot_tok.encode(seqs["protein"][1], self.k_prot)
        else:
            raise ValueError(f"unsupported model_type {t!r}")

        for key in ("x1", "x2"):
            if key in out:
                out["mask" + key[1]] = (out[key] != PAD_ID).astype(np.int32)
        return out


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}
