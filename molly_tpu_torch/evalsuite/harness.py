"""Benchmark evaluation harness: inference JSONL -> per-task metrics JSON
grouped by omics, x100-scaled.

Library-structured port of the reference pipeline
(the reference's eval/eval.py:832-1058): load + rename tasks, merge subtask
groups, dispatch per registry type, scale and group. The sentiment fallback
for unparseable binary outputs is injectable (metrics.SentimentFn); the
reference hard-codes a local roberta checkpoint on CUDA.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

from . import metrics as M
from .registry import (
    AUTO_GROUP_PREFIXES,
    SUBTASK_GROUPS,
    TASK_NAME_SUBSTITUTIONS,
    TASK_RENAMES,
    TASK_REGISTRY,
    get_base_task_name,
)

_EC_LABELS_PATH = os.path.join(os.path.dirname(__file__), "data",
                               "ec_labels.json")


def load_ec_labels() -> List[str]:
    with open(_EC_LABELS_PATH) as f:
        return json.load(f)


def load_entries(input_file_path: str) -> List[dict]:
    """Parse an inference JSONL; non-dict / broken lines skipped
    (eval.py:835-848). The 'result' field is renamed to 'model_output'."""
    entries = []
    with open(input_file_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(d, dict):
                entries.append(d)
    return entries


def group_entries(entries: List[dict]) -> Dict[str, List[dict]]:
    """Rename, filter nan labels, group by subtask, then append merged
    groups (eval.py:849-948)."""
    groups: Dict[str, List[dict]] = defaultdict(list)
    for e in entries:
        e = dict(e)
        if "result" in e and "model_output" not in e:
            e["model_output"] = e.pop("result")
        # raw inference-CLI rows (pre-convert.py format,
        # the reference's data_tools/convert.py:171-202)
        if "decoded_output" in e and "model_output" not in e:
            e["model_output"] = e.pop("decoded_output")
        if "gt_label" in e and "label" not in e:
            e["label"] = e.pop("gt_label")
        task = e.get("task", "")
        task = TASK_RENAMES.get(task, task)
        for old, new in TASK_NAME_SUBSTITUTIONS:
            task = task.replace(old, new)
        e["task"] = task
        if e.get("label") is None:
            continue
        groups[task].append(e)

    merged: Dict[str, List[dict]] = dict(groups)
    subgroups = {k: list(v) for k, v in SUBTASK_GROUPS.items()}
    for prefix in AUTO_GROUP_PREFIXES:
        subs = [t for t in groups if t != prefix and
                t.startswith(prefix + "-")]
        if subs:
            subgroups[prefix] = subs
    for group_name, subs in subgroups.items():
        entries_merged: List[dict] = []
        for s in subs:
            entries_merged.extend(groups.get(s, []))
        if entries_merged:
            merged[group_name] = entries_merged
    return merged


def evaluate_task(task_name: str, entries: List[dict],
                  sentiment_fn: Optional[M.SentimentFn] = None,
                  ec_labels: Optional[List[str]] = None) -> dict:
    """Dispatch one (sub)task to its metric (eval.py:984-1031)."""
    base = get_base_task_name(task_name)
    spec = TASK_REGISTRY[base]
    ttype, metric = spec["type"], spec["metrics"]

    if ttype == "regression":
        labels, results = [], []
        for e in entries:
            labels.append(float(e["label"]))
            vals = M.extract_numeric_values(e["model_output"])
            results.append(vals[0] if vals else float("inf"))
        if metric == "spearman":
            return M.compute_spearman(labels, results)
        if metric == "R2":
            return M.compute_r2(labels, results)
        if metric == "mixed_score":
            return M.compute_mixed_score(labels, results, threshold=30)

    if ttype == "binary classification":
        labels, preds = M.binary_outcomes(entries, sentiment_fn)
        return (M.compute_mcc(labels, preds) if metric == "MCC"
                else M.compute_acc(labels, preds))

    if ttype == "multilabel regression":
        if base == "ProgrammableRNASwitches":
            return M.compute_r2_programmable_rna_switches(entries)
        if base == "enhancer_activity":
            return M.compute_pcc_enhancer_activity(entries)

    if ttype == "multiclass classification":
        return M.compute_acc_ncrna_family(entries)

    if ttype == "multilabel classification":
        if base == "FunctionEC":
            return M.compute_fmax_function_ec(
                entries, ec_labels or load_ec_labels())
        if base == "Modification":
            return M.compute_auc_modification(entries, sentiment_fn)

    raise ValueError(f"unhandled task type {ttype!r} for {task_name!r}")


def _scale(value, factor=100, places=2):
    if isinstance(value, dict):
        return {k: _scale(v, factor, places) for k, v in value.items()}
    if isinstance(value, (int, float)):
        return float(round(value * factor, places))
    return value


def evaluate_file(input_file_path: str,
                  sentiment_fn: Optional[M.SentimentFn] = None,
                  scale: bool = True,
                  processed_dir: Optional[str] = None
                  ) -> Dict[str, Dict[str, dict]]:
    """Full pipeline -> {omics: {task: {metric: score}}} (x100 scaled).

    processed_dir: when set, dumps each task's grouped entries as JSON for
    inspection (the reference's save_processed_data affordance,
    eval.py:115-124)."""
    groups = group_entries(load_entries(input_file_path))
    ec_labels = load_ec_labels()
    by_omics: Dict[str, Dict[str, dict]] = defaultdict(dict)
    for task_name, entries in groups.items():
        try:
            base = get_base_task_name(task_name)
        except KeyError:
            continue
        result = evaluate_task(task_name, entries, sentiment_fn, ec_labels)
        omics = TASK_REGISTRY[base]["omics"]
        by_omics[omics][task_name] = _scale(result) if scale else result
        if processed_dir:
            os.makedirs(processed_dir, exist_ok=True)
            with open(os.path.join(processed_dir,
                                   f"{task_name}_processed_data.json"),
                      "w") as f:
                json.dump(entries, f, indent=2, default=str)
    return dict(by_omics)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("molly_tpu_torch benchmark evaluator")
    ap.add_argument("--input_file_path", required=True)
    ap.add_argument("--model_name", default="molly_tpu")
    ap.add_argument("--OMICS", default="All")
    ap.add_argument("--output", default=None)
    ap.add_argument("--processed-dir", default=None)
    ap.add_argument("--sentiment-model", default=None,
                    help="local HF sequence-classification dir for the "
                         "unparseable-binary-output fallback (reference "
                         "eval.py:84-112); default = offline lexicon")
    args = ap.parse_args(argv)

    sentiment_fn = None
    if args.sentiment_model:
        sentiment_fn = M.hf_sentiment_fn(args.sentiment_model)
    result = evaluate_file(args.input_file_path,
                           sentiment_fn=sentiment_fn,
                           processed_dir=args.processed_dir)
    out = args.output or (
        f"metrics_result_{args.model_name}_{args.OMICS}.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=4)
    print(json.dumps(result, indent=2))
    print(f"Metrics saved to {out}")


if __name__ == "__main__":
    main()
