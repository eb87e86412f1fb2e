"""Metric implementations for the omics benchmark evaluator.

Pure numpy/scipy/sklearn ports of the reference metric suite
(the reference's eval/eval.py §§6-11), preserving its exact conventions:
  - regression: first extracted numeric; unparseable -> inf, and the final
    score is down-weighted by the invalid fraction (eval.py:158-236)
  - mixed_score: MAE / range-MAE / F1 blend for siRNA (:239-316)
  - 3-output R2 (ProgrammableRNASwitches, :321-429), 2-output PCC
    (enhancer_activity, :432-521)
  - binary cls: keyword match; "don't know" counted wrong; otherwise a
    pluggable sentiment fallback (:61-112) — the reference downloads a
    roberta sentiment model; here the fallback is injectable, defaulting to
    a lexicon heuristic
  - 13-way ncRNA family accuracy (:562-632), multilabel modification AUC
    (:637-720), FunctionEC Fmax over EC multihot labels (:725-827); the
    Fmax prefix algorithm follows the published Biology-Instructions /
    torchdrug formulation
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# extraction helpers
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"(-?\d+\.?\d*)")


def extract_numeric_values(text) -> List[float]:
    """All numerics in the text, normalized through %.6g (eval.py:48-58)."""
    out = []
    for num in _NUM_RE.findall(str(text)):
        v = np.float64(num)
        s = f"{int(v):.6g}" if v.is_integer() else f"{v:.6g}"
        out.append(float(s))
    return out


POSITIVE_KEYWORDS = ("yes",)
NEGATIVE_KEYWORDS = (
    "no", "absence", "not found", "not detected", "not associated",
    "not inferred", "not linked", "does not indicate", "no evidence",
    "not predicted", "absent",
)
DONT_KNOW_KEYWORDS = ("don't know", "unknown", "unsure", "uncertain",
                      "not applicable")


def classify_by_keywords(text: str):
    """1 / 0 / "dont_know" / None (eval.py:61-79)."""
    t = text.lower()
    if any(k in t for k in POSITIVE_KEYWORDS):
        return 1
    if any(k in t for k in NEGATIVE_KEYWORDS):
        return 0
    if any(k in t for k in DONT_KNOW_KEYWORDS):
        return "dont_know"
    return None


_POS_WORDS = ("positive", "likely", "high", "strong", "bind", "interact",
              "promot", "active", "soluble", "stable", "present", "true")
_NEG_WORDS = ("negative", "unlikely", "low", "weak", "inactive", "insoluble",
              "unstable", "false", "none")


def lexicon_sentiment(text: str) -> Tuple[int, float]:
    """Offline stand-in for the reference's roberta sentiment fallback
    (eval.py:84-112): same (class, score) contract."""
    t = text.lower()
    pos = sum(t.count(w) for w in _POS_WORDS)
    neg = sum(t.count(w) for w in _NEG_WORDS)
    total = max(pos + neg, 1)
    return (1, pos / total) if pos >= neg else (0, neg / total)


SentimentFn = Callable[[str], Tuple[int, float]]


def hf_sentiment_fn(model_dir: str, device: str = "cpu",
                    batch_hint: int = 512) -> SentimentFn:
    """Model-backed sentiment fallback: loads a local HF sequence-
    classification checkpoint (the reference uses
    twitter-roberta-base-sentiment-latest, eval.py:84-112) and returns the
    same (class, score) contract as lexicon_sentiment. The id2label map
    must contain 'positive' and 'negative' (case-insensitive)."""
    import torch
    from transformers import (AutoConfig, AutoModelForSequenceClassification,
                              AutoTokenizer)

    tokenizer = AutoTokenizer.from_pretrained(model_dir)
    config = AutoConfig.from_pretrained(model_dir)
    model = AutoModelForSequenceClassification.from_pretrained(
        model_dir).to(device).eval()
    id2label = {i: str(l).lower() for i, l in config.id2label.items()}
    try:
        pos_idx = next(i for i, l in id2label.items() if l == "positive")
        neg_idx = next(i for i, l in id2label.items() if l == "negative")
    except StopIteration:
        raise ValueError(
            f"sentiment model must label 'positive'/'negative'; "
            f"got id2label={config.id2label}")

    def classify(text: str) -> Tuple[int, float]:
        enc = tokenizer(text, padding=True, truncation=True,
                        max_length=batch_hint, return_tensors="pt"
                        ).to(device)
        with torch.no_grad():
            logits = model(**enc).logits
        probs = torch.softmax(logits, dim=-1)[0]
        pos, neg = float(probs[pos_idx]), float(probs[neg_idx])
        return (1, pos) if pos > neg else (0, neg)

    return classify

# ---------------------------------------------------------------------------
# regression metrics (with invalid-fraction downweighting)
# ---------------------------------------------------------------------------


def _downweight(score: float, n_valid: int, n_total: int,
                n_invalid: int) -> float:
    return (score * n_valid) / n_total if n_invalid > 0 else score


def compute_spearman(labels: Sequence[float],
                     results: Sequence[float]) -> Dict[str, float]:
    from scipy.stats import spearmanr

    r = np.asarray(results, dtype=np.float64).flatten()
    l = np.asarray(labels, dtype=np.float64).flatten()
    inf_mask = np.isinf(r)
    valid = ~inf_mask & np.isfinite(r) & np.isfinite(l)
    if valid.sum() > 0:
        rho, _ = spearmanr(l[valid], r[valid])
    else:
        rho = 0.0
    return {"spearman": _downweight(float(rho), int(valid.sum()), len(r),
                                    int(inf_mask.sum()))}


def compute_r2(labels: Sequence[float],
               results: Sequence[float]) -> Dict[str, float]:
    """R2 = PCC^2 with invalid downweighting (eval.py:196-236)."""
    from scipy.stats import pearsonr

    r = np.asarray(results, dtype=np.float64).flatten()
    l = np.asarray(labels, dtype=np.float64).flatten()
    inf_mask = np.isinf(r)
    valid = ~inf_mask & np.isfinite(r) & np.isfinite(l)
    if valid.sum() > 0:
        try:
            pcc, _ = pearsonr(l[valid], r[valid])
            r2 = float(pcc) ** 2
        except Exception:
            r2 = float(np.inf)
    else:
        r2 = 0.0
    return {"R2": _downweight(r2, int(valid.sum()), len(r),
                              int(inf_mask.sum()))}


def compute_mixed_score(labels, results, threshold: float = 30.0,
                        max_value: float = 1e3) -> Dict[str, float]:
    """siRNA efficiency blend (eval.py:239-316): 0.5*(1-MAE/100) +
    0.5*(1-rangeMAE/100)*F1 with too-large outputs scored 0."""
    from sklearn.metrics import (mean_absolute_error, precision_score,
                                 recall_score)

    r = np.asarray([float(x) if np.isfinite(x := _to_float(v)) else np.nan
                    for v in results])
    l = np.asarray([_to_float(v) for v in labels])
    too_large = np.abs(r) > max_value
    too_large = np.where(np.isnan(r), False, too_large)
    valid = ~too_large & np.isfinite(r) & np.isfinite(l)
    rv, lv = r[valid], l[valid]

    lb = (lv < threshold).astype(int)
    rb = (rv < threshold).astype(int)
    precision = precision_score(lb, rb, average="binary", zero_division=0)
    recall = recall_score(lb, rb, average="binary", zero_division=0)
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) else 0.0)
    mae = (mean_absolute_error(lv, rv) if len(rv) else np.inf)
    in_range = (rv >= 0) & (rv <= threshold)
    range_mae = (mean_absolute_error(lv[in_range], rv[in_range])
                 if in_range.sum() > 0 else 100.0)
    mae = min(mae, 100.0)
    range_mae = min(range_mae, 100.0)
    score = (1 - mae / 100) * 0.5 + (1 - range_mae / 100) * f1 * 0.5
    n_inf = int(too_large.sum())
    if n_inf > 0:
        score = (score * valid.sum()) / len(r)
    return {"mixed_score": float(score)}


def _to_float(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


# ---------------------------------------------------------------------------
# multi-output regression tasks
# ---------------------------------------------------------------------------


def compute_r2_programmable_rna_switches(entries: List[dict]
                                         ) -> Dict[str, float]:
    """3-output (ON/OFF/ON_OFF) averaged downweighted R2 (eval.py:321-429)."""
    cols = {"ON": ([], []), "OFF": ([], []), "ON_OFF": ([], [])}
    for e in entries:
        label = e["label"]
        if isinstance(label, str):
            label = json.loads(label)
        vals = extract_numeric_values(e["model_output"])
        vals = vals if len(vals) == 3 else [np.nan] * 3
        for (key, (res, lab)), v in zip(cols.items(), vals):
            res.append(v)
            lab.append(float(label[key]))
    scores = []
    for key, (res, lab) in cols.items():
        res = np.asarray(res)
        lab = np.asarray(lab)
        valid = np.isfinite(res) & np.isfinite(lab)
        n_valid, n_invalid = int(valid.sum()), int((~valid).sum())
        r2 = (compute_r2(lab[valid], res[valid])["R2"] if n_valid > 0 else 0.0)
        total = max(n_valid + n_invalid, 1)
        scores.append((r2 * n_valid) / total if n_valid > 0 else 0.0)
    return {"R2": float(np.mean(scores))}


def compute_pcc_enhancer_activity(entries: List[dict]) -> Dict[str, object]:
    """2-output (hk/dev) downweighted PCC (eval.py:432-521)."""
    from scipy.stats import pearsonr

    hk_r, dev_r, hk_l, dev_l = [], [], [], []
    for e in entries:
        label = e["label"]
        if isinstance(label, str):
            label = json.loads(label)
        vals = extract_numeric_values(e["model_output"])
        vals = vals if len(vals) == 2 else [np.inf, np.inf]
        hk_r.append(vals[0])
        dev_r.append(vals[1])
        hk_l.append(float(label["hk"]))
        dev_l.append(float(label["dev"]))

    out = {}
    for name, res, lab in (("hk_PCC", hk_r, hk_l), ("dev_PCC", dev_r, dev_l)):
        res = np.asarray(res)
        lab = np.asarray(lab)
        valid = np.isfinite(res) & np.isfinite(lab)
        if valid.sum() == 0:
            return {"PCC": f"Error: {name} has insufficient valid data."}
        pcc, _ = pearsonr(res[valid], lab[valid])
        total = int(valid.sum() + (~valid).sum())
        out[name] = float(pcc * valid.sum() / total)
    return {"PCC": out}


# ---------------------------------------------------------------------------
# classification metrics
# ---------------------------------------------------------------------------


def binary_outcomes(entries: List[dict],
                    sentiment_fn: Optional[SentimentFn] = None
                    ) -> Tuple[List[int], List[int]]:
    """Label/prediction pairs for a binary task (eval.py:529-559): label is
    'positive'/other; dont-know and missing outputs count as wrong."""
    sentiment_fn = sentiment_fn or lexicon_sentiment
    labels, preds = [], []
    for e in entries:
        label = 1 if e["label"] == "positive" else 0
        out = e.get("model_output")
        if out is None:
            pred = 1 - label
        else:
            pred = classify_by_keywords(out)
            if pred == "dont_know":
                pred = 1 - label
            elif pred is None:
                pred, _ = sentiment_fn(out)
        labels.append(label)
        preds.append(pred)
    return labels, preds


def compute_mcc(labels, preds) -> Dict[str, float]:
    from sklearn.metrics import matthews_corrcoef

    return {"MCC": float(matthews_corrcoef(labels, preds))}


def compute_acc(labels, preds) -> Dict[str, float]:
    from sklearn.metrics import accuracy_score

    return {"Acc": float(accuracy_score(labels, preds))}


RNA_CLASSES = sorted(
    ["5S_rRNA", "5_8S_rRNA", "tRNA", "ribozyme", "CD-box", "miRNA",
     "Intron_gpI", "Intron_gpII", "HACA-box", "riboswitch", "IRES",
     "leader", "scaRNA"], key=len, reverse=True)


def extract_rna_family(text: str) -> Optional[str]:
    for c in RNA_CLASSES:
        if c in text:
            return c
    return None


def compute_acc_ncrna_family(entries: List[dict]) -> Dict[str, float]:
    correct = sum(1 for e in entries
                  if extract_rna_family(e["model_output"]) == e["label"])
    return {"Acc": correct / len(entries) if entries else 0.0}


MODIFICATION_CLASSES = sorted(
    ["Am", "Cm", "Gm", "Um", "m1A", "m5C", "m5U", "m6A", "m6Am", "m7G",
     "Psi", "AtoI", "none"], key=len, reverse=True)


def extract_modifications(text: str) -> List[str]:
    return [m for m in MODIFICATION_CLASSES
            if re.search(rf"\b{m}\b", text)]


def _to_multihot(mods: Optional[List[str]],
                 classes=MODIFICATION_CLASSES) -> List[int]:
    mods = mods or []
    return [1 if m in mods else 0 for m in classes]


def compute_auc_modification(entries: List[dict],
                             sentiment_fn: Optional[SentimentFn] = None
                             ) -> Dict[str, Optional[float]]:
    """Macro AUC over modification multihots with the reference's 'none'
    disambiguation fallback (eval.py:664-720)."""
    from sklearn.metrics import roc_auc_score

    sentiment_fn = sentiment_fn or lexicon_sentiment
    y_true, y_pred = [], []
    for e in entries:
        pred = extract_modifications(e["model_output"])
        true = e["label"].split(",")
        if pred == [] and true == ["none"]:
            kw = classify_by_keywords(e["model_output"])
            if kw == 0:
                pred = ["none"]
            elif kw == 1:
                pred = []
            elif kw is None:
                s, _ = sentiment_fn(e["model_output"])
                pred = ["none"] if s == 0 else []
        y_true.append(_to_multihot(true))
        y_pred.append(_to_multihot(pred))
    try:
        auc = float(roc_auc_score(y_true, y_pred, average="macro"))
    except ValueError:
        auc = None
    return {"AUC": auc}


# ---------------------------------------------------------------------------
# FunctionEC Fmax
# ---------------------------------------------------------------------------

EC_RE = re.compile(r"\d+\.\d+\.\d+\.\-?\d*")


def fmax(pred: np.ndarray, target: np.ndarray) -> float:
    """Protein-centric Fmax over the global prediction ordering (numpy port
    of the published Biology-Instructions/torchdrug formulation the
    reference vendors at eval.py:725-764): at every prefix of the
    score-sorted (sample, class) list, precision is averaged over samples
    with >=1 prediction and recall over all samples."""
    if pred.size == 0 or target.size == 0:
        return 0.0
    N, C = pred.shape
    order = np.argsort(-pred, axis=1, kind="stable")
    tgt_sorted = np.take_along_axis(target, order, axis=1)
    csum = tgt_sorted.cumsum(1)
    precision = csum / np.arange(1, C + 1)[None, :]
    recall = csum / (target.sum(1, keepdims=True) + 1e-10)

    is_start_sorted = np.zeros((N, C), dtype=bool)
    is_start_sorted[:, 0] = True
    is_start = np.zeros((N, C), dtype=bool)
    np.put_along_axis(is_start, order, is_start_sorted, axis=1)

    all_order = np.argsort(-pred.flatten(), kind="stable")
    order_flat = (order + np.arange(N)[:, None] * C).flatten()
    inv_order = np.empty_like(order_flat)
    inv_order[order_flat] = np.arange(N * C)
    is_start_f = is_start.flatten()[all_order]
    all_order2 = inv_order[all_order]

    p_f = precision.flatten()
    r_f = recall.flatten()
    dp = p_f[all_order2] - np.where(is_start_f, 0.0, p_f[all_order2 - 1])
    dr = r_f[all_order2] - np.where(is_start_f, 0.0, r_f[all_order2 - 1])
    all_p = np.cumsum(dp) / np.cumsum(is_start_f)
    all_r = np.cumsum(dr) / N
    all_f1 = 2 * all_p * all_r / (all_p + all_r + 1e-10)
    if np.isnan(all_f1).any():
        return 0.0
    return float(all_f1.max())


def compute_fmax_function_ec(entries: List[dict],
                             ec_labels: List[str]) -> Dict[str, float]:
    idx = {ec: i for i, ec in enumerate(ec_labels)}
    preds, targets = [], []
    for e in entries:
        label_ec = EC_RE.findall(str(e["label"]))
        result_ec = EC_RE.findall(str(e["model_output"]))
        p = np.zeros(len(ec_labels))
        t = np.zeros(len(ec_labels))
        for ec in result_ec:
            if ec in idx:
                p[idx[ec]] = 1
        for ec in label_ec:
            if ec in idx:
                t[idx[ec]] = 1
        preds.append(p)
        targets.append(t)
    return {"Fmax": fmax(np.stack(preds), np.stack(targets))}
