"""LLM-as-judge evaluation, the counterpart of
``molly_tpu/tools/llm_judge.py``: a judge LLM decides whether each model
output conveys the ground-truth label, with a strict Yes/No prompt;
reasoning (<think>...</think>) is stripped before parsing; per-task
accuracy tables are returned.

The prompt, the parsing helpers and ``judge_records`` are copies of the
JAX module's; ``make_engine_judge`` decodes greedily on this package's
KV-cache engine, on the device of the judge's params (any Qwen3 decoder
loaded through ``models.hf_import``).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional

JUDGE_PROMPT = (
    "You are a strict evaluator. Given a model's answer and the ground "
    "truth label, decide whether the answer conveys the same meaning as "
    "the label. Respond with exactly one word: Yes or No.\n\n"
    "Label: {label}\nModel answer: {answer}\n\nSame meaning?"
)

THINK_RE = re.compile(r"<think>.*?</think>", re.DOTALL)


def strip_think(text: str) -> str:
    """Remove reasoning spans before verdict parsing (the reference strips
    up to the </think> token id 151668)."""
    return THINK_RE.sub("", text).strip()


def parse_verdict(text: str) -> Optional[bool]:
    t = strip_think(text).lower()
    if re.search(r"\byes\b", t):
        return True
    if re.search(r"\bno\b", t):
        return False
    return None


def judge_records(records: List[dict], generate_fn,
                  max_items: Optional[int] = None) -> Dict[str, dict]:
    """records: [{task, model_output/decoded_output, label/gt_label}];
    generate_fn(prompt str) -> judge response str.

    Returns per-task {correct, total, accuracy} plus an "overall" entry.
    """
    per_task = defaultdict(lambda: {"correct": 0, "total": 0})
    for rec in records[:max_items]:
        answer = rec.get("model_output") or rec.get("decoded_output") or ""
        label = rec.get("label") or rec.get("gt_label") or ""
        prompt = JUDGE_PROMPT.format(label=label,
                                     answer=strip_think(str(answer)))
        verdict = parse_verdict(generate_fn(prompt) or "")
        t = per_task[rec.get("task", "unknown")]
        t["total"] += 1
        if verdict:
            t["correct"] += 1

    out: Dict[str, dict] = {}
    tot_c = tot_n = 0
    for task, c in sorted(per_task.items()):
        acc = c["correct"] / c["total"] if c["total"] else 0.0
        out[task] = {**c, "accuracy": acc}
        tot_c += c["correct"]
        tot_n += c["total"]
    out["overall"] = {"correct": tot_c, "total": tot_n,
                      "accuracy": tot_c / tot_n if tot_n else 0.0}
    return out


def make_engine_judge(params, text_cfg, tokenizer, max_new_tokens: int = 8):
    """A generate_fn that runs the judge greedily on this package's decode
    engine (``inference.engine._generate_from_embeds``)."""
    import torch

    from ..inference.engine import _generate_from_embeds
    from ..models import qwen3
    from ..models.configs import GenerationConfig

    gen = GenerationConfig(
        max_new_tokens=max_new_tokens, do_sample=False,
        repetition_penalty=1.0, eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id or 0)
    dev = params["embed"].device

    def generate_fn(prompt: str) -> str:
        ids = tokenizer.encode(
            f"<|im_start|>user\n{prompt}<|im_end|>\n<|im_start|>assistant\n")
        arr = torch.as_tensor([ids], dtype=torch.long, device=dev)
        embeds = qwen3.embed_tokens(params, arr)
        toks = _generate_from_embeds(
            params, text_cfg, embeds,
            torch.ones(arr.shape, dtype=torch.int32, device=dev), gen)
        out = [t for t in toks[0].tolist() if t != gen.pad_token_id]
        return tokenizer.decode(out, skip_special_tokens=True)

    return generate_fn
