"""Data tooling — library equivalents of the reference's 17 standalone
scripts under the reference's data_tools/ (SURVEY.md §2.2 #19-21):

  - reserved-token replacement + IUPAC validation + 6-column parquet
    (cot2parquet.py, write2parquet.py)
  - inference JSONL -> eval format (convert.py:142-202)
  - per-task 8:2 splitting (split_parquet.py / split_json.py)
  - parquet merging (merge_parguet.py / merge_cot_data.py)
  - dataset statistics (show_count.py / show_task.py / compute_length.py /
    count_token.py)
  - exact-input leak check (check_data_leak.py)
  - marker filtering / balanced subsampling (process_data.py,
    get_target_data.py)

All functions are importable; the CLI lives in molly_tpu_torch.tools.cli.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PARQUET_COLUMNS = ["task", "input", "think", "output", "label", "kind"]

IDX2MARKER = {"1": "dna", "2": "rna", "3": "protein"}
RESERVED_TAG_RE = re.compile(r"(</?)\|reserved_special_token_(\d+)\|>",
                             re.IGNORECASE)
NT_REGEX = re.compile(r"^[ACGTN]+$")
AA_REGEX = re.compile(r"^[ACDEFGHIKLMNPQRSTVWYBXZOU]+$")
ALLOW_BASE = {"dna": NT_REGEX, "rna": NT_REGEX, "protein": AA_REGEX}
TAGGED_RE = re.compile(r"<(dna|rna|protein)>(.*?)</\1>", re.DOTALL)


def replace_reserved_tokens(text: str) -> str:
    """<|reserved_special_token_1..3|> -> <dna>/<rna>/<protein>, with the
    closing form normalized to </tag> (cot2parquet.py)."""
    if not text:
        return text

    def repl(m: re.Match) -> str:
        marker = IDX2MARKER.get(m.group(2))
        if not marker:
            return m.group(0)
        return f"</{marker}>" if m.group(1) == "</" else f"<{marker}>"

    return RESERVED_TAG_RE.sub(repl, text)


def validate_tagged_sequences(text: str) -> List[str]:
    """Return a list of validation errors (empty = valid IUPAC content in
    every tagged span)."""
    errors = []
    for m in TAGGED_RE.finditer(text or ""):
        kind, seq = m.group(1), m.group(2).strip().upper()
        if not ALLOW_BASE[kind].match(seq):
            bad = sorted(set(c for c in seq
                             if not ALLOW_BASE[kind].match(c)))
            errors.append(f"invalid {kind} sequence (bad chars {bad[:5]})")
    return errors


def records_to_parquet(records: Iterable[dict], out_path: str,
                       validate: bool = True,
                       replace_reserved: bool = True) -> Tuple[int, int]:
    """Normalize records into the 6-column schema and write parquet.
    Returns (written, dropped_by_validation)."""
    import pandas as pd

    rows, dropped = [], 0
    for rec in records:
        row = {c: rec.get(c, "") or "" for c in PARQUET_COLUMNS}
        if replace_reserved:
            row["input"] = replace_reserved_tokens(row["input"])
        if validate and validate_tagged_sequences(row["input"]):
            dropped += 1
            continue
        rows.append(row)
    pd.DataFrame(rows, columns=PARQUET_COLUMNS).to_parquet(out_path)
    return len(rows), dropped


def jsonl_to_parquet(jsonl_path: str, out_path: str, **kw) -> Tuple[int, int]:
    def gen():
        with open(jsonl_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)
    return records_to_parquet(gen(), out_path, **kw)


def convert_inference_jsonl(src_path: str, dst_path: str) -> int:
    """Inference-CLI JSONL -> eval format {task, input, model_output,
    label, kind} (convert.py:171-202)."""
    n = 0
    with open(src_path) as fin, open(dst_path, "w") as fout:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            fout.write(json.dumps({
                "task": rec.get("task"),
                "input": rec.get("input"),
                "model_output": rec.get("decoded_output"),
                "label": rec.get("gt_label"),
                "kind": rec.get("kind"),
            }, ensure_ascii=False) + "\n")
            n += 1
    return n


def split_by_task(df, ratio: float = 0.8, seed: int = 42):
    """Per-task train/val split (split_parquet.py semantics: 8:2 within
    each task). Returns (train_df, val_df)."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(seed)
    train_parts, val_parts = [], []
    for _, group in df.groupby("task", sort=False):
        idx = rng.permutation(len(group))
        cut = int(len(group) * ratio)
        train_parts.append(group.iloc[idx[:cut]])
        val_parts.append(group.iloc[idx[cut:]])
    return (pd.concat(train_parts).reset_index(drop=True),
            pd.concat(val_parts).reset_index(drop=True))


def merge_parquets(paths: Sequence[str], out_path: str,
                   shuffle: bool = False, seed: int = 42) -> int:
    import numpy as np
    import pandas as pd

    df = pd.concat([pd.read_parquet(p) for p in paths], ignore_index=True)
    if shuffle:
        df = df.sample(frac=1,
                       random_state=np.random.default_rng(seed)
                       ).reset_index(drop=True)
    df.to_parquet(out_path)
    return len(df)


def check_data_leak(path1: str, path2: str,
                    column: str = "input") -> Dict[str, object]:
    """Exact-overlap check on a column between two parquets
    (check_data_leak.py)."""
    import pandas as pd

    s1 = set(pd.read_parquet(path1, columns=[column])[column].dropna())
    s2 = set(pd.read_parquet(path2, columns=[column])[column].dropna())
    common = s1 & s2
    return {"overlap": len(common), "examples": sorted(common)[:10]}


def dataset_stats(df, tokenizer=None) -> Dict[str, object]:
    """Per-task counts + input/output length stats (+ token counts when a
    tokenizer is given) — show_count/show_task/compute_length/count_token."""
    import numpy as np

    stats: Dict[str, object] = {
        "rows": len(df),
        "tasks": df["task"].value_counts().to_dict() if "task" in df else {},
    }
    for col in ("input", "output"):
        if col in df:
            lens = df[col].fillna("").str.len()
            stats[f"{col}_chars"] = {
                "mean": float(lens.mean()), "p50": float(lens.median()),
                "max": int(lens.max()) if len(lens) else 0}
            if tokenizer is not None:
                tok_lens = [len(tokenizer.encode(t))
                            for t in df[col].fillna("")]
                stats[f"{col}_tokens"] = {
                    "mean": float(np.mean(tok_lens)),
                    "max": int(np.max(tok_lens)) if tok_lens else 0}
    return stats


def balanced_subsample(df, n_per_task: int, seed: int = 42):
    """At most n rows per task (analysis_dataset.py balanced subsampling)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    parts = []
    for _, group in df.groupby("task", sort=False):
        take = min(n_per_task, len(group))
        parts.append(group.iloc[rng.permutation(len(group))[:take]])
    import pandas as pd
    return pd.concat(parts).reset_index(drop=True)


def filter_by_markers(df, required: Optional[List[str]] = None,
                      forbidden: Optional[List[str]] = None):
    """Keep rows whose input contains all required tags and none of the
    forbidden ones (process_data.py / get_target_data.py style)."""
    def ok(text: str) -> bool:
        text = text or ""
        if required and not all(f"<{t}>" in text for t in required):
            return False
        if forbidden and any(f"<{t}>" in text for t in forbidden):
            return False
        return True

    return df[df["input"].map(ok)].reset_index(drop=True)


def ablation_subset(df, modalities: Sequence[str]):
    """Task-subset ablation split (reference scripts/train/run_train_{dna,
    rna,protein,dna_rna,dna_protein,rna_protein}.sh train on pre-filtered
    parquets): keep rows whose tagged sequences use ONLY the requested
    modalities (at least one tag present)."""
    want = {m.lower() for m in modalities}
    assert want <= {"dna", "rna", "protein"}, modalities

    def row_mods(text: str) -> set:
        text = text or ""
        return {m for m in ("dna", "rna", "protein") if f"<{m}>" in text}

    def ok(text: str) -> bool:
        mods = row_mods(text)
        return bool(mods) and mods <= want

    return df[df["input"].map(ok)].reset_index(drop=True)


_ANSWER_RE = re.compile(r"(?<=Answer[:：])\s*(.*?)(?=\n|$)",
                        re.IGNORECASE | re.DOTALL)


def extract_answer(text: str) -> str:
    """'Answer: X' extraction (compute_kegg.py:18-31)."""
    if not text:
        return ""
    m = _ANSWER_RE.search(text)
    return m.group(1).strip().lower() if m else ""


def kegg_report(jsonl_path: str, save_confusion: Optional[str] = None
                ) -> Dict[str, object]:
    """KEGG free-text accuracy analysis (reference data_tools/
    compute_kegg.py): extract 'Answer:' spans, fuzzy-match substrings to
    the gold label, report Accuracy/macro-P/R/F1 (+ optional confusion-
    matrix PNG)."""
    from sklearn.metrics import (accuracy_score, confusion_matrix,
                                 precision_recall_fscore_support)

    y_true, y_pred, fuzzy = [], [], 0
    with open(jsonl_path) as f:
        for line in f:
            if not line.strip():
                continue
            item = json.loads(line)
            gt = str(item.get("gt_label", "")).strip().lower()
            pred = extract_answer(item.get("decoded_output", ""))
            # fuzzy: one-sided substring counts as a match (:83-88)
            if pred and gt and pred != gt and (pred in gt or gt in pred):
                pred = gt
                fuzzy += 1
            y_true.append(gt)
            y_pred.append(pred)

    labels = sorted(set(y_true))
    prec, rec, f1, _ = precision_recall_fscore_support(
        y_true, y_pred, average="macro", zero_division=0, labels=labels)
    report = {
        "n": len(y_true),
        "labels": labels,
        "fuzzy_matched": fuzzy,
        "Accuracy": float(accuracy_score(y_true, y_pred)),
        "Precision": float(prec),
        "Recall": float(rec),
        "F1-Score": float(f1),
    }
    if save_confusion:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        cm = confusion_matrix(y_true, y_pred, labels=labels)
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(cm, cmap="Blues")
        ax.set_xticks(range(len(labels)), labels, rotation=90, fontsize=6)
        ax.set_yticks(range(len(labels)), labels, fontsize=6)
        for i in range(len(labels)):
            for j in range(len(labels)):
                ax.text(j, i, cm[i, j], ha="center", va="center", fontsize=6)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("Ground Truth")
        fig.colorbar(im)
        fig.savefig(save_confusion, dpi=150, bbox_inches="tight")
        plt.close(fig)
        report["confusion_matrix_png"] = save_confusion
    return report


def count_tokens_with_tokenizer(df, tokenizer, column: str = "output"
                                ) -> Dict[str, object]:
    """Per-column LLM-token statistics (reference data_tools/
    count_token_llm.py): total/mean/median/p95/max over tokenizer.encode
    of each row."""
    import numpy as np

    if column not in df.columns:
        raise ValueError(f"column {column!r} not in {list(df.columns)}")
    counts = [len(tokenizer.encode(str(t), add_special_tokens=False))
              for t in df[column]]
    arr = np.asarray(counts, dtype=np.int64)
    return {
        "rows": int(len(arr)),
        "column": column,
        "total_tokens": int(arr.sum()),
        "mean": float(arr.mean()) if len(arr) else 0.0,
        "median": float(np.median(arr)) if len(arr) else 0.0,
        "p95": float(np.percentile(arr, 95)) if len(arr) else 0.0,
        "max": int(arr.max()) if len(arr) else 0,
        "min": int(arr.min()) if len(arr) else 0,
    }
