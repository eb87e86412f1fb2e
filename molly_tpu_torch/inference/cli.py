"""Inference CLI, the counterpart of ``molly_tpu/inference/cli.py``: read a
parquet of prompts, run the fusion model with sampling, append JSONL rows
``{decoded_output, input, gt_output, gt_label, task, kind}`` that
``molly_tpu.evalsuite`` scores.

Usage:
  python -m molly_tpu_torch.inference.cli --input-file data.parquet \
      --output-file out.jsonl [--batch-size 32] [--int8] [--greedy] ...
  ... --serve [--serve-chunk 64] [--serve-admit 8] [--serve-kv-int8]
  ... --serve --serve-paged [--page-size 64] [--kv-pages N] [--serve-kv-int8]

Static batches (the default) wait for their longest row; ``--serve`` runs
continuous batching (``inference.server``), where slots free at EOS and
backfill from the queue, and ``--serve-paged`` puts its KV cache in pages
(``inference.paged``). The loops themselves are ``run_batches`` and
``run_serve``, which take already-encoded samples
(``OmicsSampleEncoder.encode_test`` rows), so a caller without pandas can
drive them. Weights are random from ``--seed`` unless ``--checkpoint`` names
a train-state directory of this package's own format
(``training.checkpoint``); ``--adapter`` grafts an exported ``.npz`` (LoRA +
projectors) and merges it once at load. HF checkpoint import, the offline
ring, speculative decoding and the HTTP API are not ported: their flags
parse and are refused with the ROADMAP.md entry that tracks them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("molly_tpu_torch batch inference")
    p.add_argument("--input-file", required=True,
                   help="parquet of prompts [task, input, output, label, "
                        "kind] with inline <dna>/<rna>/<protein> tags")
    p.add_argument("--output-file", required=True, help="JSONL sink")
    p.add_argument("--text-model-path", default=None,
                   help="local HF dir for the text tokenizer (default: the "
                        "byte-level tokenizer)")
    p.add_argument("--checkpoint", default=None,
                   help="train-state dir written by "
                        "molly_tpu_torch.training (params are read from it)")
    p.add_argument("--adapter", default=None,
                   help="adapter .npz from training.export_adapter")
    p.add_argument("--peft-adapter", default=None,
                   help="reference-style PEFT adapter dir (not ported: "
                        "refused)")
    p.add_argument("--lora-r", type=int, default=64)
    p.add_argument("--lora-alpha", type=float, default=None,
                   help="merge scale override; default = recorded adapter "
                        "meta, else 64")
    p.add_argument("--preset", default="qwen3-1.7b")
    p.add_argument("--dna-rna-preset", default="nt-500m")
    p.add_argument("--protein-preset", default="esm2-650m")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-length", type=int, default=3072)
    p.add_argument("--max-new-tokens", type=int, default=3072)
    p.add_argument("--dna-rna-k-tokens", type=int, default=1024)
    p.add_argument("--protein-k-tokens", type=int, default=1024)
    p.add_argument("--max-dna-rna-segments", type=int, default=4)
    p.add_argument("--max-protein-segments", type=int, default=4)
    p.add_argument("--strict-segments", action="store_true",
                   help="error on segment-slot overflow instead of "
                        "degrading loudly")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--top-k", type=int, default=20)
    p.add_argument("--repetition-penalty", type=float, default=1.1)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only decode of the text model")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="make the text decoder a sparse MoE with this many "
                        "experts (matches the train CLI flag; needed to "
                        "load a checkpoint trained with --moe-experts)")
    p.add_argument("--moe-topk", type=int, default=2,
                   help="experts per token under --moe-experts")
    p.add_argument("--read-nums", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model matching the train CLI's --tiny")
    p.add_argument("--serve", action="store_true",
                   help="continuous batching (inference.server): slots free "
                        "at EOS and backfill from the queue instead of "
                        "static batches that wait for the longest row; "
                        "--batch-size sets the slot count")
    p.add_argument("--serve-chunk", type=int, default=64,
                   help="max decode steps per scheduler round under --serve "
                        "(a chunk ends sooner once a backfill group's worth "
                        "of slots finish)")
    p.add_argument("--serve-admit", type=int, default=8,
                   help="backfill group size under --serve (chunks exit "
                        "early once this many slots sit finished while "
                        "requests are queued)")
    p.add_argument("--serve-paged", action="store_true",
                   help="with --serve: paged KV (inference.paged) — the "
                        "cache is a pool of fixed-size pages allocated "
                        "per sequence on demand instead of a per-slot "
                        "[max_length + cap] rectangle. Memory scales with "
                        "tokens actually held; the pool may be "
                        "oversubscribed (--kv-pages), preempting the "
                        "youngest request when it runs dry")
    p.add_argument("--page-size", type=int, default=64,
                   help="tokens per KV page under --serve-paged")
    p.add_argument("--kv-pages", type=int, default=None,
                   help="per-layer page-pool size under --serve-paged; "
                        "default fully provisions slots x (prompt + cap), "
                        "lower it to oversubscribe device memory")
    p.add_argument("--serve-kv-int8", action="store_true",
                   help="int8 KV under --serve / --serve-paged (halves KV "
                        "memory and bandwidth; ~1e-2 logit noise)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache in the batch engine (halves the "
                        "[L,B,Nkv,S,2Dh] pool)")
    # flags of the JAX CLI whose paths are not ported: parsed, then refused
    # (--lookup-k/-n and --host/--port only parse: they act only under
    # --decoding lookup and --api-serve, which are refused)
    p.add_argument("--decoding", default="engine",
                   choices=["engine", "lookup"])
    p.add_argument("--lookup-k", type=int, default=8,
                   help="draft tokens per lookup round (--decoding lookup)")
    p.add_argument("--lookup-n", type=int, default=3,
                   help="n-gram length matched against the history "
                        "(--decoding lookup)")
    p.add_argument("--offline-ring", action="store_true")
    p.add_argument("--ring-spec", type=int, default=0)
    p.add_argument("--ring-spec-adapt", type=float, default=None)
    p.add_argument("--serve-adapter", action="append", default=[])
    p.add_argument("--api-serve", action="store_true")
    p.add_argument("--host", default="127.0.0.1", help="--api-serve's host")
    p.add_argument("--port", type=int, default=8000,
                   help="--api-serve's port")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only on "
                        "request)")
    return p


def build_config(args, text_tok, dna_tok, prot_tok):
    """FusionConfig from the flags, as ``molly_tpu.inference.cli.main``
    builds it (the demo mode sizes the text vocab to the tokenizer)."""
    from ..models.configs import (ESM_PRESETS, QWEN3_PRESETS, FusionConfig,
                                  tiny_esm, tiny_qwen3)
    if args.tiny:
        cfg = FusionConfig(
            text=tiny_qwen3(vocab_size=-(-text_tok.vocab_size // 128) * 128,
                            dtype="float32"),
            dna_rna=tiny_esm(vocab_size=dna_tok.vocab_size, mask_token_id=2,
                             dtype="float32"),
            protein=tiny_esm(vocab_size=prot_tok.vocab_size,
                             mask_token_id=prot_tok.mask_id,
                             dtype="float32"),
            dna_rna_k_tokens=args.dna_rna_k_tokens,
            protein_k_tokens=args.protein_k_tokens)
    else:
        text_cfg = QWEN3_PRESETS[args.preset]
        if text_tok.vocab_size > text_cfg.vocab_size or \
                args.text_model_path is None:
            # byte-fallback tokenizer / demo mode: size the embedding to the
            # tokenizer (rounded to a multiple of 128)
            text_cfg = dataclasses.replace(
                text_cfg, vocab_size=-(-text_tok.vocab_size // 128) * 128)
        cfg = FusionConfig(
            text=text_cfg,
            dna_rna=ESM_PRESETS[args.dna_rna_preset],
            protein=ESM_PRESETS[args.protein_preset],
            dna_rna_k_tokens=args.dna_rna_k_tokens,
            protein_k_tokens=args.protein_k_tokens)
    if args.moe_experts:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, num_experts=args.moe_experts,
            num_experts_per_tok=args.moe_topk))
    return cfg


def _load_params(args, cfg, device):
    """Random weights from ``--seed``, then ``--checkpoint`` (params of a
    saved train state) and ``--adapter`` (LoRA + projectors, merged once
    here so decode never pays the merge again)."""
    from ..models import fusion
    from ..utils.tree import tree_to
    g = torch.Generator(device=device).manual_seed(args.seed)
    params = fusion.init_params(cfg, g, device)
    lora = None
    if args.checkpoint:
        from ..training.checkpoint import graft_params, load_params
        saved = load_params(args.checkpoint)
        lora = saved.pop("lora", None)
        if any(isinstance(w, dict)
               for w in saved["text"]["layers"].values()):
            # a QLoRA state: keep its int8 base, merge_lora dequantizes it
            params["text"] = tree_to(saved.pop("text"), device)
        params = {**params, **graft_params(
            {k: params[k] for k in saved}, saved)}
        if lora is not None:
            lora = tree_to(lora, device)
    lora_alpha = args.lora_alpha  # explicit flag wins
    if args.adapter:
        from ..training.checkpoint import adapter_meta, load_adapter
        params = load_adapter(args.adapter, params)
        lora = params.pop("lora", lora)
        meta = adapter_meta(args.adapter)
        if meta is not None and lora_alpha is None:
            lora_alpha = meta["alpha"]
    if lora is not None:
        from ..models.lora import LoraConfig, merge_lora
        r = lora["layers"]["q_proj"]["a"].shape[-1]
        params["text"] = merge_lora(
            params["text"], lora,
            LoraConfig(r=r, alpha=float(lora_alpha if lora_alpha is not None
                                        else 64.0)))
    return params


_UNPORTED = {
    "peft_adapter": ("--peft-adapter",
                     "queue 1 item 7 (models/hf_import.py:peft_lora_from_hf)"),
    "offline_ring": ("--offline-ring", "queue 1 item 9 (inference/offline.py)"),
    "ring_spec": ("--ring-spec", "queue 1 item 9 (inference/offline.py)"),
    "ring_spec_adapt": ("--ring-spec-adapt",
                        "queue 1 item 9 (inference/offline.py)"),
    "api_serve": ("--api-serve", "queue 1 item 9 (inference/api_server.py)"),
    "serve_adapter": ("--serve-adapter",
                      "queue 1 item 9 (inference/api_server.py)"),
}


def refuse_unported(args) -> None:
    """Stop on a flag whose path this package does not have yet."""
    for dest, (flag, entry) in _UNPORTED.items():
        if getattr(args, dest):
            raise SystemExit(f"{flag} is not ported yet: ROADMAP.md, {entry}")
    if args.decoding == "lookup":
        raise SystemExit("--decoding lookup is not ported yet: ROADMAP.md, "
                         "queue 1 item 9 (inference/speculative.py)")


def _record(text_tok, gen, out_ids: np.ndarray, meta: Dict[str, Any]
            ) -> Dict[str, Any]:
    out_ids = out_ids[out_ids != gen.pad_token_id]
    return {
        "decoded_output": text_tok.decode(out_ids.tolist(),
                                          skip_special_tokens=True),
        "input": meta["raw_input"], "gt_output": meta["raw_output"],
        "gt_label": meta["raw_label"], "task": meta["task"],
        "kind": meta["kind"],
    }


_META_KEYS = ("raw_input", "raw_output", "raw_label", "task", "kind")


def run_batches(samples: Iterable[Dict[str, Any]], params, cfg, gen,
                text_tok, out_fh, *, batch_size: int,
                generator: Optional[torch.Generator] = None,
                total: Optional[int] = None,
                stats: Optional[Dict[str, float]] = None,
                kv_quant: Optional[str] = None
                ) -> List[Dict[str, Any]]:
    """Collate encoded samples into batches, generate, and write one JSONL
    record per sample to ``out_fh``; returns the records. ``stats`` collects
    per-phase seconds (see ``engine.generate``)."""
    from ..data import collate_test

    from .engine import generate

    records: List[Dict[str, Any]] = []
    buf: List[Dict[str, Any]] = []

    def flush():
        batch = collate_test(buf)
        arrs = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        tokens = generate(params, cfg, arrs, gen, generator, stats,
                          kv_quant=kv_quant).cpu().numpy()
        for i in range(tokens.shape[0]):
            rec = _record(text_tok, gen, tokens[i],
                          {k: batch[k][i] for k in _META_KEYS})
            out_fh.write(json.dumps(rec) + "\n")
            records.append(rec)
        buf.clear()
        print(f"[inference] {len(records)}/{total if total is not None else '?'}",
              flush=True)

    for s in samples:
        buf.append(s)
        if len(buf) == batch_size:
            flush()
    if buf:
        flush()
    return records


def run_serve(samples: Iterable[Dict[str, Any]], params, cfg, gen,
              text_tok, out_fh, *, n_slots: int, max_length: int,
              prefix_ids, paged: bool = False, page_size: int = 64,
              kv_pages: Optional[int] = None, kv_int8: bool = False,
              decode_chunk: int = 64, admit_batch: int = 8,
              generator: Optional[torch.Generator] = None,
              stats: Optional[Dict[str, Any]] = None
              ) -> List[Dict[str, Any]]:
    """Continuous batching over encoded samples: one Request per sample,
    slots backfilled as generations finish; writes one JSONL record per
    sample to ``out_fh`` in sample order and returns the records.

    Every prompt starts with the dataset's fixed system prompt
    (``prefix_ids``): the dense ring computes its KV once and copies it into
    each slot, the paged engine stores its full pages once and shares them
    across all slots' page tables (the sub-page remainder rides each
    request's suffix). Buckets bound the per-request SUFFIX. ``stats``, when
    given, receives the engine's counters, per-phase seconds (which
    synchronizes the device at each phase) and whether every chosen token's
    log-probability was finite (the engine then keeps them)."""
    from ..data import collate_test
    from .server import Request, ServingEngine

    kv_quant = "int8" if kv_int8 else None
    common = dict(n_slots=n_slots, decode_chunk=decode_chunk,
                  admit_batch=admit_batch, kv_quant=kv_quant,
                  prefix_ids=prefix_ids, generator=generator,
                  time_phases=stats is not None, logprobs=stats is not None)
    if paged:
        from .paged import PagedServingEngine
        P = page_size
        s_share = (len(prefix_ids) // P) * P
        bucket = -(-(max_length - s_share) // P) * P
        eng = PagedServingEngine(params, cfg, gen, page_size=P,
                                 n_pages=kv_pages, prefill_buckets=(bucket,),
                                 **common)
    else:
        eng = ServingEngine(params, cfg, gen,
                            max_len=max_length + gen.max_new_tokens,
                            prefill_buckets=(max_length - len(prefix_ids),),
                            **common)
    meta = {}
    arr_keys = ("input_ids", "attention_mask", "dna_rna_tokens",
                "dna_rna_pos", "protein_tokens", "protein_pos")
    for uid, sample in enumerate(samples):
        row = collate_test([sample])
        eng.submit(Request(uid=uid, batch={
            k: row[k] for k in arr_keys if k in row}))
        meta[uid] = {k: row[k][0] for k in _META_KEYS}
    results = eng.run([])
    records = []
    for uid in sorted(results):
        rec = _record(text_tok, gen, results[uid], meta[uid])
        out_fh.write(json.dumps(rec) + "\n")
        records.append(rec)
    if stats is not None:
        stats.update(eng.stats)
        stats["tokens_out"] = int(sum(len(v) for v in results.values()))
        stats["logprobs_finite"] = all(
            bool(np.isfinite(eng.pop_logprobs(uid)).all())
            for uid in results)
        if paged:
            stats["free_pages"] = len(eng._free_pages)
            stats["n_pages"] = eng.n_pages
            stats["n_shared_pages"] = eng._n_shared
    print(f"[inference --serve] {len(results)}/{len(meta)} done", flush=True)
    return records


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    refuse_unported(args)

    from ..data import (DataConfig, OmicsDataset,
                        default_modality_tokenizers, load_text_tokenizer)

    from ..models import qwen3

    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to run on "
                         "the CPU")
    device = torch.device(args.device or "cuda")
    text_tok = load_text_tokenizer(args.text_model_path)
    dcfg = DataConfig(max_len=args.max_length,
                      dna_rna_k_tokens=args.dna_rna_k_tokens,
                      protein_k_tokens=args.protein_k_tokens,
                      max_dna_rna_segments=args.max_dna_rna_segments,
                      max_protein_segments=args.max_protein_segments,
                      strict_segments=args.strict_segments)
    dna_tok, prot_tok = default_modality_tokenizers()
    ds = OmicsDataset(args.input_file, text_tok, dna_tok, prot_tok, dcfg,
                      mode="test", read_nums=args.read_nums)
    cfg = build_config(args, text_tok, dna_tok, prot_tok)

    params = _load_params(args, cfg, device)
    if args.int8:
        # the expert stacks of an MoE decoder are quantized too, and the
        # bf16 ones released as their int8 replacements are built
        params["text"] = qwen3.quantize_for_decode(
            params["text"], cfg.text,
            moe_experts=bool(cfg.text.num_experts), donate=True)
    from ..models.configs import GenerationConfig
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        do_sample=not args.greedy,
        temperature=args.temperature, top_p=args.top_p, top_k=args.top_k,
        repetition_penalty=args.repetition_penalty,
        eos_token_id=text_tok.eos_token_id,
        pad_token_id=text_tok.pad_token_id or 0)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    samples = (ds[i] for i in range(len(ds)))
    with open(args.output_file, "a") as fh:
        if args.serve:
            run_serve(samples, params, cfg, gen, text_tok, fh,
                      n_slots=args.batch_size, max_length=args.max_length,
                      prefix_ids=ds.encoder.system_prompt_ids,
                      paged=args.serve_paged, page_size=args.page_size,
                      kv_pages=args.kv_pages, kv_int8=args.serve_kv_int8,
                      decode_chunk=args.serve_chunk,
                      admit_batch=args.serve_admit, generator=generator)
        else:
            run_batches(samples, params, cfg, gen, text_tok, fh,
                        batch_size=args.batch_size, generator=generator,
                        total=len(ds),
                        kv_quant="int8" if args.kv_int8 else None)
    print(f"[inference] done in {time.perf_counter() - t0:.1f}s on {device}",
          flush=True)


if __name__ == "__main__":
    main()
