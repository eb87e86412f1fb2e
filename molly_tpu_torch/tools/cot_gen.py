"""Offline CoT data generation: an OpenAI-compatible chat client with a
thread pool and resumable JSONL output. A copy of
``molly_tpu/tools/cot_gen.py`` (stdlib only, no JAX).

Reads a parquet of samples, asks an OpenAI-compatible endpoint for
reasoning + answer per row, appends {"id", "task", "input", "think",
"output"} JSONL rows, and skips ids already present in the output on
restart. The transport is stdlib urllib, so the tool works without the
openai package.

  python -m molly_tpu_torch.tools.cot_gen \\
      --input samples.parquet --output cot.jsonl \\
      --base-url https://host/v1 --model deepseek-r1 \\
      --api-key-env COT_API_KEY --workers 16
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Dict, Optional, Set

SYSTEM_PROMPT = "You are a helpful assistant."

# Rephrasing mode mirrors the reference's bioinformatics system prompt
# (data_tools/rephrasing_data.py:14-23) minus the vLLM dependency: any
# OpenAI-compatible endpoint serves the rephrasing model instead.
REPHRASE_SYSTEM_PROMPT = (
    "You are a precise bioinformatics assistant. "
    "The user has provided a DNA/RNA sequence and a question. "
    "Your job is to generate a detailed, fluent paragraph that:\n"
    "  1) restates the question in your own words,\n"
    "  2) briefly analyses any relevant motifs or regions,\n"
    "  3) gives biological reasoning in 2-3 sentences,\n"
    "  4) ends with a single, clear sentence that exactly matches the "
    "ground-truth label.\n"
    "Do NOT contradict the ground-truth label."
)


def chat_completion(base_url: str, model: str, prompt: str,
                    api_key: str = "", timeout: float = 120.0,
                    system: str = SYSTEM_PROMPT,
                    transport=None) -> Dict[str, Any]:
    """One OpenAI-compatible /chat/completions call. Returns
    {"content", "reasoning", "completion_tokens"} — reasoning comes from
    the R1-style ``reasoning_content`` field when present, else from a
    <think>...</think> span in the content (both appear in the wild)."""
    payload = json.dumps({
        "model": model,
        "messages": [
            {"role": "system", "content": system},
            {"role": "user", "content": prompt},
        ],
    }).encode()
    url = base_url.rstrip("/") + "/chat/completions"
    if transport is None:
        req = urllib.request.Request(url, data=payload, headers={
            "Content-Type": "application/json",
            "Authorization": f"Bearer {api_key}",
        })
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            data = json.loads(resp.read())
    else:  # injected for tests / custom transports
        data = transport(url, payload)

    msg = data["choices"][0]["message"]
    content = msg.get("content") or ""
    reasoning = msg.get("reasoning_content") or ""
    if not reasoning and "<think>" in content and "</think>" in content:
        start = content.index("<think>") + len("<think>")
        end = content.index("</think>")
        reasoning = content[start:end].strip()
        content = content[end + len("</think>"):].strip()
    usage = data.get("usage") or {}
    return {"content": content, "reasoning": reasoning,
            "completion_tokens": usage.get("completion_tokens", 0)}


def read_existing_ids(output_file: str) -> Set[Any]:
    """Resume support: ids already answered (openai_api.py:127-137)."""
    done: Set[Any] = set()
    if os.path.exists(output_file):
        with open(output_file) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["id"])
                except (json.JSONDecodeError, KeyError):
                    continue
    return done


def process_dataframe(df, output_file: str, *, base_url: str, model: str,
                      api_key: str = "", workers: int = 8,
                      max_retries: int = 3, transport=None,
                      progress_every: int = 25,
                      rephrase: bool = False) -> Dict[str, int]:
    """Thread-pool fan-out over rows with resumable append-only output
    (openai_api.py:141-186). rephrase=True swaps in the label-grounded
    rephrasing prompt (rephrasing_data.py). Returns
    {"done", "skipped", "failed"}."""
    done_ids = read_existing_ids(output_file)
    lock = threading.Lock()
    stats = {"done": 0, "skipped": 0, "failed": 0}

    def work(idx: int, row) -> Optional[Dict[str, Any]]:
        prompt = str(row["input"])
        system = SYSTEM_PROMPT
        if rephrase:
            system = (REPHRASE_SYSTEM_PROMPT +
                      "\nGround-truth label (you must agree): "
                      f"{row.get('label', row.get('output', ''))}")
        for attempt in range(max_retries):
            try:
                out = chat_completion(base_url, model, prompt,
                                      api_key=api_key, system=system,
                                      transport=transport)
                return {"id": idx, "task": row.get("task", ""),
                        "input": prompt, "think": out["reasoning"],
                        "output": out["content"],
                        "completion_tokens": out["completion_tokens"]}
            except Exception:
                if attempt == max_retries - 1:
                    return None
                time.sleep(1.5 * (attempt + 1))
        return None

    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with open(output_file, "a") as fh, \
            ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {}
        for idx, row in df.iterrows():
            if idx in done_ids:
                stats["skipped"] += 1
                continue
            futures[pool.submit(work, idx, row)] = idx
        for i, fut in enumerate(as_completed(futures)):
            rec = fut.result()
            if rec is None:
                stats["failed"] += 1
                continue
            with lock:
                fh.write(json.dumps(rec, ensure_ascii=False) + "\n")
                fh.flush()
            stats["done"] += 1
            if progress_every and (i + 1) % progress_every == 0:
                print(f"[cot_gen] {i + 1}/{len(futures)} "
                      f"(failed {stats['failed']})", flush=True)
    return stats


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser("molly_tpu_torch CoT generator")
    ap.add_argument("--input", required=True, help="parquet with an "
                    "'input' column (6-col schema fine)")
    ap.add_argument("--output", required=True, help="JSONL, appended; "
                    "restart resumes by id")
    ap.add_argument("--base-url", required=True,
                    help="OpenAI-compatible endpoint, e.g. https://x/v1")
    ap.add_argument("--model", default="deepseek-r1")
    ap.add_argument("--api-key-env", default="COT_API_KEY",
                    help="env var holding the key (never a flag)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--read-nums", type=int, default=None)
    ap.add_argument("--rephrase", action="store_true",
                    help="label-grounded rephrasing prompt instead of CoT "
                         "(reference data_tools/rephrasing_data.py)")
    args = ap.parse_args(argv)

    import pandas as pd

    df = pd.read_parquet(args.input)
    if args.read_nums:
        df = df.head(args.read_nums)
    stats = process_dataframe(
        df, args.output, base_url=args.base_url, model=args.model,
        api_key=os.environ.get(args.api_key_env, ""), workers=args.workers,
        rephrase=args.rephrase)
    print(f"[cot_gen] done={stats['done']} skipped={stats['skipped']} "
          f"failed={stats['failed']} -> {args.output}")
    return stats


if __name__ == "__main__":
    main()
