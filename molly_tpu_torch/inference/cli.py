"""Batch inference CLI, the counterpart of ``molly_tpu/inference/cli.py``'s
batch path: read a parquet of prompts, run the fusion model with sampling,
append JSONL rows ``{decoded_output, input, gt_output, gt_label, task,
kind}`` that ``molly_tpu.evalsuite`` scores.

Usage:
  python -m molly_tpu_torch.inference.cli --input-file data.parquet \
      --output-file out.jsonl [--batch-size 32] [--int8] [--greedy] ...

The decode loop itself is ``run_batches``, which takes already-encoded
samples (``OmicsSampleEncoder.encode_test`` rows), so a caller without
pandas can drive it. Weights are random from ``--seed`` unless
``--checkpoint`` names a train-state directory of this package's own format
(``training.checkpoint``); ``--adapter`` grafts an exported ``.npz`` (LoRA +
projectors) and merges it once at load. HF checkpoint import and the
serving, offline-ring, API and lookup flags of the JAX CLI belong to later
slices.
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
    p.add_argument("--read-nums", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model matching the train CLI's --tiny")
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
        return FusionConfig(
            text=tiny_qwen3(vocab_size=-(-text_tok.vocab_size // 128) * 128,
                            dtype="float32"),
            dna_rna=tiny_esm(vocab_size=dna_tok.vocab_size, mask_token_id=2,
                             dtype="float32"),
            protein=tiny_esm(vocab_size=prot_tok.vocab_size,
                             mask_token_id=prot_tok.mask_id,
                             dtype="float32"),
            dna_rna_k_tokens=args.dna_rna_k_tokens,
            protein_k_tokens=args.protein_k_tokens)
    text_cfg = QWEN3_PRESETS[args.preset]
    if text_tok.vocab_size > text_cfg.vocab_size or \
            args.text_model_path is None:
        # byte-fallback tokenizer / demo mode: size the embedding to the
        # tokenizer (rounded to a multiple of 128)
        text_cfg = dataclasses.replace(
            text_cfg, vocab_size=-(-text_tok.vocab_size // 128) * 128)
    return FusionConfig(
        text=text_cfg,
        dna_rna=ESM_PRESETS[args.dna_rna_preset],
        protein=ESM_PRESETS[args.protein_preset],
        dna_rna_k_tokens=args.dna_rna_k_tokens,
        protein_k_tokens=args.protein_k_tokens)


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




def run_batches(samples: Iterable[Dict[str, Any]], params, cfg, gen,
                text_tok, out_fh, *, batch_size: int,
                generator: Optional[torch.Generator] = None,
                total: Optional[int] = None,
                stats: Optional[Dict[str, float]] = None
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
        tokens = generate(params, cfg, arrs, gen, generator,
                          stats).cpu().numpy()
        for i in range(tokens.shape[0]):
            out_ids = tokens[i]
            out_ids = out_ids[out_ids != gen.pad_token_id]
            rec = {
                "decoded_output": text_tok.decode(out_ids.tolist(),
                                                  skip_special_tokens=True),
                "input": batch["raw_input"][i],
                "gt_output": batch["raw_output"][i],
                "gt_label": batch["raw_label"][i],
                "task": batch["task"][i],
                "kind": batch["kind"][i],
            }
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


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)

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
        params["text"] = qwen3.quantize_for_decode(params["text"], cfg.text)
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
    with open(args.output_file, "a") as fh:
        run_batches((ds[i] for i in range(len(ds))), params, cfg, gen,
                    text_tok, fh, batch_size=args.batch_size,
                    generator=generator, total=len(ds))
    print(f"[inference] done in {time.perf_counter() - t0:.1f}s on {device}",
          flush=True)


if __name__ == "__main__":
    main()
