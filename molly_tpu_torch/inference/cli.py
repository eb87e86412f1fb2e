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
an HF checkpoint directory (``*.safetensors`` or ``*.bin``: the text decoder
is imported by ``models.hf_import``) or a train-state directory of this
package's own format (``training.checkpoint``); ``--adapter`` grafts an
exported ``.npz`` (LoRA + projectors) and ``--peft-adapter`` a reference-style
PEFT directory, each merged once at load.

  ... --decoding lookup [--lookup-k 8] [--lookup-n 3]
  ... --offline-ring [--ring-spec K [--ring-spec-adapt THRESHOLD]]
  ... --api-serve [--host 127.0.0.1] [--port 8000] [--serve-paged]
      [--serve-adapter NAME=PEFT_DIR ...]

``--decoding lookup`` decodes one request at a time by prompt-lookup
speculation (``inference.speculative``, ``run_lookup``); ``--offline-ring``
runs the whole file through the admission ring (``inference.offline``,
``run_offline_ring``); ``--api-serve`` serves the OpenAI-style HTTP API
(``inference.api_server``) instead of reading ``--input-file``, with
``--serve-adapter`` adapters stacked into one multi-LoRA bank.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import itertools
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("molly_tpu_torch batch inference")
    p.add_argument("--input-file", default=None,
                   help="parquet of prompts [task, input, output, label, "
                        "kind] with inline <dna>/<rna>/<protein> tags "
                        "(required unless --api-serve)")
    p.add_argument("--output-file", default=None,
                   help="JSONL sink (required unless --api-serve)")
    p.add_argument("--text-model-path", default=None,
                   help="local HF dir for the text tokenizer (default: the "
                        "byte-level tokenizer)")
    p.add_argument("--checkpoint", default=None,
                   help="HF checkpoint dir (*.safetensors / *.bin: the text "
                        "decoder is imported) or a train-state dir written "
                        "by molly_tpu_torch.training (params are read from "
                        "it)")
    p.add_argument("--adapter", default=None,
                   help="adapter .npz from training.export_adapter")
    p.add_argument("--peft-adapter", default=None,
                   help="reference-style PEFT adapter dir "
                        "(adapter_model.safetensors or .bin, "
                        "adapter_config.json, dna_rna_projector.bin, "
                        "protein_projector.bin), merged once at load")
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
    p.add_argument("--decoding", default="engine",
                   choices=["engine", "lookup"],
                   help="'lookup' = prompt-lookup speculative decoding "
                        "(n-gram drafts verified in one forward; "
                        "token-exact, one request at a time)")
    p.add_argument("--lookup-k", type=int, default=8,
                   help="draft tokens per lookup round")
    p.add_argument("--lookup-n", type=int, default=3,
                   help="n-gram length matched against the history")
    p.add_argument("--offline-ring", action="store_true",
                   help="the admission ring (inference.offline): the whole "
                        "file is queued on the device at once, admitted in "
                        "groups of --serve-admit into --batch-size slots "
                        "and decoded to the end")
    p.add_argument("--ring-spec", type=int, default=0,
                   help="with --offline-ring: prompt-lookup speculation, N "
                        "draft tokens per round (greedy token-exact, "
                        "sampled distribution-exact)")
    p.add_argument("--ring-spec-adapt", type=float, default=None,
                   metavar="THRESHOLD",
                   help="with --ring-spec: the acceptance-adaptive ring — "
                        "speculate only while the acceptance-rate EMA "
                        "stays at or above THRESHOLD (plain ticks keep the "
                        "EMA live through a shadow draft); outputs are "
                        "unchanged either way")
    p.add_argument("--serve-adapter", action="append", default=[],
                   metavar="NAME=PATH",
                   help="multi-LoRA serving under --api-serve: a PEFT "
                        "adapter dir served as OpenAI model NAME "
                        "(repeatable); a request picks it with its "
                        "'model' field, the base model serves any other")
    p.add_argument("--api-serve", action="store_true",
                   help="serve an OpenAI-compatible HTTP API "
                        "(/v1/completions, /v1/chat/completions, "
                        "/v1/embeddings) over the continuous-batching "
                        "engine instead of reading --input-file; "
                        "--batch-size sets the slot count")
    p.add_argument("--host", default="127.0.0.1", help="--api-serve's host")
    p.add_argument("--port", type=int, default=8000,
                   help="--api-serve's port (0: any free port)")
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
        if text_tok.vocab_size > text_cfg.vocab_size or (
                args.text_model_path is None and args.checkpoint is None):
            # byte-fallback tokenizer / demo mode: size the embedding to the
            # tokenizer (rounded to a multiple of 128); a checkpoint keeps
            # the preset's vocabulary
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


def is_hf_dir(path: Optional[str]) -> bool:
    """A directory that holds ``*.safetensors`` or ``*.bin`` files: an HF
    checkpoint, not a train state of this package."""
    return bool(path) and os.path.isdir(path) and any(
        f.endswith((".safetensors", ".bin")) for f in os.listdir(path))


def load_peft_adapter(adir: str, text_cfg, default_r: int = 64,
                      device="cpu"):
    """A reference-style PEFT adapter directory, UNMERGED: the LoRA tree from
    ``adapter_model*.safetensors`` (else ``adapter_model*.bin``) and
    ``lora_alpha`` from ``adapter_config.json`` (None without one)."""
    from ..models.hf_import import load_hf_state, peft_lora_from_hf
    try:
        state = load_hf_state(adir)
    except FileNotFoundError:
        bins = sorted(glob.glob(os.path.join(adir, "adapter_model*.bin")))
        if not bins:
            raise FileNotFoundError(f"no adapter_model*.safetensors or "
                                    f"adapter_model*.bin in {adir}")
        state = torch.load(bins[0], map_location="cpu", weights_only=True)
    lora = peft_lora_from_hf(state, text_cfg, default_r, device=device)
    alpha = None
    acfg = os.path.join(adir, "adapter_config.json")
    if os.path.exists(acfg):
        with open(acfg) as f:
            alpha = json.load(f).get("lora_alpha")
    return lora, alpha


def _load_params(args, cfg, device):
    """Random weights from ``--seed``, then ``--checkpoint`` (an HF
    directory: the text decoder is imported, the encoders keep their random
    init as in the JAX CLI; any other directory: the params of a saved train
    state), ``--adapter`` (LoRA + projectors from an ``.npz``) and
    ``--peft-adapter`` (a PEFT directory and its projector ``.bin`` files).
    A LoRA is merged once here so decode never pays the merge again."""
    from ..models import fusion
    from ..utils.tree import tree_to
    g = torch.Generator(device=device).manual_seed(args.seed)
    lora = None
    hf = is_hf_dir(args.checkpoint)
    if hf:
        from ..models.hf_import import load_hf_state, qwen3_from_hf
        text = qwen3_from_hf(load_hf_state(args.checkpoint), cfg.text,
                             device=device)
        params = fusion.init_params(cfg, g, device, given={"text": text})
    else:
        params = fusion.init_params(cfg, g, device)
    if args.checkpoint and not hf:
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
    if args.peft_adapter:
        from ..models.hf_import import projector_from_hf
        lora, peft_alpha = load_peft_adapter(args.peft_adapter, cfg.text,
                                             args.lora_r, device)
        if lora_alpha is None:
            lora_alpha = peft_alpha
        for name in ("dna_rna_projector", "protein_projector"):
            bp = os.path.join(args.peft_adapter, f"{name}.bin")
            if os.path.exists(bp):
                params[name] = projector_from_hf(
                    torch.load(bp, map_location="cpu", weights_only=True),
                    device=device)
    if lora is not None:
        from ..models.lora import LoraConfig, merge_lora
        r = lora["layers"]["q_proj"]["a"].shape[-1]
        params["text"] = merge_lora(
            params["text"], lora,
            LoraConfig(r=r, alpha=float(lora_alpha if lora_alpha is not None
                                        else 64.0)))
    return params


def refuse_unported(args) -> None:
    """Stop on a flag that would act on nothing — a mode's options given
    without the mode (the JAX CLI ignores them silently) — or a malformed
    --serve-adapter, before anything loads."""
    for flag, dest, mode in (("--ring-spec", "ring_spec", "offline_ring"),
                             ("--ring-spec-adapt", "ring_spec_adapt",
                              "offline_ring"),
                             ("--serve-adapter", "serve_adapter",
                              "api_serve")):
        if getattr(args, dest) and not getattr(args, mode):
            raise SystemExit(f"{flag} acts only with --"
                             f"{mode.replace('_', '-')}")
    if args.ring_spec_adapt is not None and not args.ring_spec:
        raise SystemExit("--ring-spec-adapt acts only with --ring-spec")
    for spec in args.serve_adapter:
        name, _, path = spec.partition("=")
        if not (name and path):
            raise SystemExit(f"--serve-adapter expects NAME=PATH, got "
                             f"{spec!r}")


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
    per-phase seconds (see ``engine.generate``) and, under a recording made
    for each batch, its spans and counts (``utils.profiling``): encoding
    the samples, collating, generating, the tokens' copy to the host and
    the write-out."""
    from ..data import collate_test
    from ..utils import profiling

    from .engine import generate

    records: List[Dict[str, Any]] = []
    it = iter(samples)
    while True:
        with profiling.recording(stats):
            # each encode_test of the batch runs as it is drawn, inside
            buf = list(itertools.islice(it, batch_size))
            if not buf:
                return records
            with profiling.span("molly/collate"):
                batch = collate_test(buf)
                arrs = {k: v for k, v in batch.items()
                        if isinstance(v, np.ndarray)}
            tokens = generate(params, cfg, arrs, gen, generator, stats,
                              kv_quant=kv_quant)
            with profiling.sync("tokens"):
                tokens = tokens.cpu().numpy()
            with profiling.span("molly/write"):
                for i in range(tokens.shape[0]):
                    rec = _record(text_tok, gen, tokens[i],
                                  {k: batch[k][i] for k in _META_KEYS})
                    out_fh.write(json.dumps(rec) + "\n")
                    records.append(rec)
        print(f"[inference] {len(records)}/{total if total is not None else '?'}",
              flush=True)


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
    from .server import REQUEST_KEYS, Request, ServingEngine

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
    for uid, sample in enumerate(samples):
        row = collate_test([sample])
        eng.submit(Request(uid=uid, batch={
            k: row[k] for k in REQUEST_KEYS if k in row}))
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


def _strip_left_pad(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A single-sample test batch without its left padding, omics segment
    starts shifted to match: prompt lookup attends every prompt column, so
    the prompt must hold real tokens only (the batch engine masks the pad
    columns instead)."""
    mask = np.asarray(batch["attention_mask"])[0]
    start = int(np.argmax(mask)) if mask.any() else mask.size
    out = dict(batch)
    out["input_ids"] = np.asarray(batch["input_ids"])[:, start:]
    out["attention_mask"] = np.asarray(batch["attention_mask"])[:, start:]
    for key in ("dna_rna_pos", "protein_pos"):
        if key in batch:
            pos = np.asarray(batch[key])
            out[key] = np.where(pos >= 0, pos - start, pos)
    return out


def run_lookup(samples: Iterable[Dict[str, Any]], params, cfg, gen,
               text_tok, out_fh, *, k: int, n: int,
               generator: Optional[torch.Generator] = None,
               total: Optional[int] = None,
               stats: Optional[Dict[str, Any]] = None
               ) -> List[Dict[str, Any]]:
    """``--decoding lookup``: prompt-lookup speculative decoding, one
    request at a time (``speculative.generate_lookup``) on its unpadded
    prompt; writes one JSONL record per sample to ``out_fh`` and returns
    the records. ``stats``, when given, sums ``rounds``, ``accepted`` (draft
    tokens) and ``tokens`` (emitted before padding)."""
    from ..data import collate_test
    from ..models import fusion
    from .server import REQUEST_KEYS
    from .speculative import generate_lookup

    dev = params["text"]["embed"].device
    records: List[Dict[str, Any]] = []
    for s in samples:
        row = collate_test([s])
        batch = _strip_left_pad({key: row[key] for key in REQUEST_KEYS
                                 if key in row})
        arrs = {key: torch.as_tensor(v, device=dev)
                for key, v in batch.items()}
        with torch.inference_mode():
            embeds = fusion.build_inputs_embeds(params, cfg, arrs)
        tokens, rounds, accepted = generate_lookup(
            params["text"], cfg.text, arrs["input_ids"], gen, k=k, n=n,
            generator=generator, return_stats=True, inputs_embeds=embeds)
        tokens = tokens[0].cpu().numpy()
        rec = _record(text_tok, gen, tokens,
                      {key: row[key][0] for key in _META_KEYS})
        out_fh.write(json.dumps(rec) + "\n")
        records.append(rec)
        if stats is not None:
            stats["rounds"] = stats.get("rounds", 0) + rounds
            stats["accepted"] = stats.get("accepted", 0) + accepted
            stats["tokens"] = stats.get("tokens", 0) + int(
                np.sum(tokens != gen.pad_token_id))
        print(f"[inference] {len(records)}/"
              f"{total if total is not None else '?'}", flush=True)
    return records


def run_offline_ring(samples: Iterable[Dict[str, Any]], params, cfg, gen,
                     text_tok, out_fh, *, n_slots: int, max_length: int,
                     admit_group: int = 8, kv_int8: bool = False,
                     ring_spec: int = 0,
                     ring_spec_adapt: Optional[float] = None,
                     generator: Optional[torch.Generator] = None,
                     total: Optional[int] = None,
                     stats: Optional[Dict[str, Any]] = None
                     ) -> List[Dict[str, Any]]:
    """``--offline-ring``: every prompt and its omics segments are queued on
    the device at once, and the admission ring (``offline.run_offline``)
    admits, prefills (the encoders included), decodes and harvests the
    whole file; writes one JSONL record per sample in sample order and
    returns the records. ``stats``, when given, receives ``run_offline``'s
    counters (ticks, host syncs, accepted drafts)."""
    from ..data import collate_test
    from .offline import run_offline
    from .server import REQUEST_KEYS, _pad_to_bucket

    bucket = max_length
    rows, meta = [], []
    for s in samples:
        row = collate_test([s])
        rows.append(_pad_to_bucket({key: row[key] for key in REQUEST_KEYS
                                    if key in row}, bucket,
                                   gen.pad_token_id))
        meta.append({key: row[key][0] for key in _META_KEYS})
    n = len(rows)

    def stack_omics(tok_key, pos_key, fill_tok):
        gmax = max((r[pos_key].shape[1] for r in rows if pos_key in r),
                   default=0)
        if not gmax:
            return {}
        kseg = next(r[tok_key].shape[2] for r in rows if tok_key in r)
        toks = np.full((n, gmax, kseg), fill_tok, np.int32)
        pos = np.full((n, gmax), -1, np.int32)
        for i, r in enumerate(rows):
            if pos_key in r:
                g = r[pos_key].shape[1]
                toks[i, :g] = r[tok_key][0]
                pos[i, :g] = r[pos_key][0]
        return {tok_key: toks, pos_key: pos}

    omics = {**stack_omics("dna_rna_tokens", "dna_rna_pos", 1),
             **stack_omics("protein_tokens", "protein_pos", 1)}
    out = run_offline(
        params, cfg, gen,
        np.concatenate([r["input_ids"] for r in rows]),
        np.concatenate([r["attention_mask"] for r in rows]),
        n_slots=n_slots,
        # + ring_spec: tentative KV columns need headroom past the cap
        max_len=bucket + gen.max_new_tokens + ring_spec,
        admit_group=admit_group, kv_quant="int8" if kv_int8 else None,
        spec_lookup=ring_spec, spec_threshold=ring_spec_adapt,
        queue_omics=omics or None, generator=generator)
    records = []
    for i in range(n):
        rec = _record(text_tok, gen, out["tokens"][i, :out["lengths"][i]],
                      meta[i])
        out_fh.write(json.dumps(rec) + "\n")
        records.append(rec)
    if stats is not None:
        stats.update({key: v for key, v in out.items()
                      if key not in ("tokens", "lengths")})
        stats["tokens_out"] = int(out["lengths"].sum())
    print(f"[inference --offline-ring] {n}/"
          f"{total if total is not None else n} done in {out['ticks']} "
          f"ticks ({out['host_syncs']} host syncs)", flush=True)
    return records


def _serve_bank(args, cfg, device):
    """--serve-adapter NAME=PATH ... stacked into one multi-LoRA bank:
    (bank, names), each adapter's alpha / r folded into its B."""
    from ..models.lora import stack_adapters
    adapters, scales, names = [], [], []
    for spec in args.serve_adapter:
        name, _, path = spec.partition("=")
        lora, alpha = load_peft_adapter(path, cfg.text, args.lora_r, device)
        r = lora["layers"]["q_proj"]["a"].shape[-1]
        adapters.append(lora)
        scales.append(float(alpha if alpha is not None else 64.0) / r)
        names.append(name)
    return stack_adapters(adapters, scales=scales), names


def main(argv=None) -> None:
    parser = build_argparser()
    args = parser.parse_args(argv)
    if not args.api_serve and not (args.input_file and args.output_file):
        parser.error("--input-file and --output-file are required "
                     "(unless --api-serve)")
    refuse_unported(args)

    from ..data import (DataConfig, OmicsDataset,
                        default_modality_tokenizers, load_text_tokenizer)

    from ..models import decoders

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
    ds = None
    if args.input_file:
        ds = OmicsDataset(args.input_file, text_tok, dna_tok, prot_tok, dcfg,
                          mode="test", read_nums=args.read_nums)
    cfg = build_config(args, text_tok, dna_tok, prot_tok)

    params = _load_params(args, cfg, device)
    if args.int8:
        # the expert stacks of an MoE decoder are quantized too, and the
        # bf16 ones released as their int8 replacements are built;
        # multi-LoRA serving keeps one int8 leaf a target (fuse=False)
        params["text"] = decoders.of(cfg.text).quantize_for_decode(
            params["text"], cfg.text,
            fuse=not (args.api_serve and args.serve_adapter),
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
    if args.api_serve:
        from .api_server import run_api_server
        bank, names = (_serve_bank(args, cfg, device) if args.serve_adapter
                       else (None, None))
        return run_api_server(args, params, cfg, gen, text_tok, dna_tok,
                              prot_tok, dcfg, lora_bank=bank,
                              adapter_names=names, generator=generator)
    t0 = time.perf_counter()
    samples = (ds[i] for i in range(len(ds)))
    with open(args.output_file, "a") as fh:
        if args.offline_ring:
            run_offline_ring(samples, params, cfg, gen, text_tok, fh,
                             n_slots=args.batch_size,
                             max_length=args.max_length,
                             admit_group=args.serve_admit,
                             kv_int8=args.serve_kv_int8,
                             ring_spec=args.ring_spec,
                             ring_spec_adapt=args.ring_spec_adapt,
                             generator=generator, total=len(ds))
        elif args.serve:
            run_serve(samples, params, cfg, gen, text_tok, fh,
                      n_slots=args.batch_size, max_length=args.max_length,
                      prefix_ids=ds.encoder.system_prompt_ids,
                      paged=args.serve_paged, page_size=args.page_size,
                      kv_pages=args.kv_pages, kv_int8=args.serve_kv_int8,
                      decode_chunk=args.serve_chunk,
                      admit_batch=args.serve_admit, generator=generator)
        elif args.decoding == "lookup":
            run_lookup(samples, params, cfg, gen, text_tok, fh,
                       k=args.lookup_k, n=args.lookup_n,
                       generator=generator, total=len(ds))
        else:
            run_batches(samples, params, cfg, gen, text_tok, fh,
                        batch_size=args.batch_size, generator=generator,
                        total=len(ds),
                        kv_quant="int8" if args.kv_int8 else None)
    print(f"[inference] done in {time.perf_counter() - t0:.1f}s on {device}",
          flush=True)


if __name__ == "__main__":
    main()
