"""Real-checkpoint parity runner: the port against HF transformers, the
counterpart of ``molly_tpu/tools/parity.py``.

Given local HF checkpoint directories, it writes a machine-readable parity
report:

  python -m molly_tpu_torch.tools.parity \\
      --text /ckpt/molly-1.7b [--dna-rna /ckpt/nt] [--protein /ckpt/esm] \\
      [--output parity_molly-1.7b.json] [--device cpu] [--full-gate]

The checkpoints are read by the port's own importer
(``models.hf_import``), and the port's side runs on ``--device`` (the card
unless ``--device cpu``); the HF side runs on the CPU in fp32, as in the
JAX tool. Checks, each with max|delta| and pass/fail against its tolerance:
  1. text decoder: layer-by-layer hidden diff and final logits;
  2. each encoder: layer-by-layer and final hidden diff;
  3. end-to-end fusion logits: encoder -> projector -> placeholder injection
     -> decoder, with the reference's in-place overwrite reproduced on the
     HF side;
  4. greedy decode match over N prompts against HF
     ``generate(do_sample=False)``, through the port's engine;
  5. ``--full-gate``: greedy generation of ``--gate-prompts`` omics prompts
     through both stacks, both JSONLs scored by the port's evalsuite, gated
     on the per-task score deltas.

The report has the JAX tool's keys and verdicts. fp32 accumulation order
puts the logit envelope at ~5e-3 (``--logit-atol``). Needs
``transformers`` (host side only; the importer does not).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("molly_tpu_torch parity runner")
    p.add_argument("--text", required=True,
                   help="HF dir: Qwen3 decoder (or full molly checkpoint)")
    p.add_argument("--dna-rna", default=None,
                   help="HF dir: nucleotide-transformer encoder")
    p.add_argument("--protein", default=None, help="HF dir: ESM-2 encoder")
    p.add_argument("--output", default=None,
                   help="report path (default benchmarks/parity_<name>.json)")
    p.add_argument("--prompts", type=int, default=16,
                   help="greedy-decode prompts (reference gate: 16)")
    p.add_argument("--seq-len", type=int, default=48)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--logit-atol", type=float, default=5e-3,
                   help="fp32 accumulation-order envelope")
    p.add_argument("--hidden-atol", type=float, default=2e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trust-remote-code", action="store_true",
                   help="needed by some nucleotide-transformer checkpoints")
    p.add_argument("--full-gate", action="store_true",
                   help="the second gate on top of the logit checks: "
                        "greedy-generate --gate-prompts prompts (with "
                        "injected omics segments) through BOTH stacks, "
                        "score both JSONLs with the port's evalsuite, and "
                        "gate on per-task score deltas. Needs --dna-rna and "
                        "--protein.")
    p.add_argument("--gate-prompts", type=int, default=100,
                   help="--full-gate prompt count (gate spec: 100)")
    p.add_argument("--score-tol", type=float, default=1.0,
                   help="--full-gate max per-task score delta "
                        "(x100-scaled points)")
    p.add_argument("--device", default=None,
                   help="torch device of the port's side (default: cuda; "
                        "the CPU only on request)")
    return p


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _layerwise_report(ours_per_layer, hf_hidden_states, mask=None
                      ) -> List[Dict[str, float]]:
    """ours: [L, B, S, H]; hf_hidden_states: tuple(L+1 or L+2 of [B, S, H]).
    HF index i+1 = output of layer i (the final tuple entry is post-norm in
    Llama-style models, so compare only pure layer outputs)."""
    rows = []
    L = ours_per_layer.shape[0]
    n_cmp = min(L - 1, len(hf_hidden_states) - 1)  # skip post-norm final
    for i in range(n_cmp):
        ref = np.asarray(hf_hidden_states[i + 1], dtype=np.float32)
        got = np.asarray(ours_per_layer[i], dtype=np.float32)
        if mask is not None:
            m = mask.astype(bool)
            d = np.abs(ref[m] - got[m])
        else:
            d = np.abs(ref - got)
        rows.append({"layer": i, "max_abs": float(d.max()),
                     "mean_abs": float(d.mean())})
    return rows


def _check(name: str, maxdiff: float, atol: float,
           extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    row = {"check": name, "max_abs_diff": maxdiff, "atol": atol,
           "pass": bool(maxdiff < atol)}
    if extra:
        row.update(extra)
    return row


def _greedy(T: int):
    from ..models.configs import GenerationConfig
    return GenerationConfig(max_new_tokens=T, do_sample=False,
                            temperature=1.0, top_p=1.0, top_k=0,
                            repetition_penalty=1.0, eos_token_id=-1,
                            pad_token_id=0)


def run_text_parity(args, report: Dict[str, Any], device):
    import torch
    from transformers import AutoModelForCausalLM

    from ..models import qwen3
    from ..models.hf_import import (load_hf_state, qwen3_cfg_from_hf_config,
                                    qwen3_from_hf)

    model = AutoModelForCausalLM.from_pretrained(
        args.text, torch_dtype=torch.float32,
        attn_implementation="eager").eval()
    cfg = qwen3_cfg_from_hf_config(model.config, dtype="float32")
    params = qwen3_from_hf(load_hf_state(args.text), cfg, dtype="float32",
                           device=device)

    rng = np.random.default_rng(args.seed)
    B, S = 4, args.seq_len
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    mask = np.ones((B, S), np.int64)
    mask[1, -S // 4:] = 0  # right padding on one row

    with torch.no_grad():
        out = model(torch.tensor(ids), attention_mask=torch.tensor(mask),
                    output_hidden_states=True)
        got, _, per_layer = qwen3.forward_hidden(
            params, cfg, input_ids=torch.as_tensor(ids, device=device),
            attention_mask=torch.as_tensor(mask, device=device),
            output_hidden_states=True)
        logits = _np(qwen3.logits_from_hidden(params, cfg, got))

    m = mask.astype(bool)
    ref_logits = out.logits.numpy()
    report["text_layerwise"] = _layerwise_report(
        _np(per_layer), out.hidden_states, mask)
    report["checks"].append(_check(
        "text_logits", float(np.abs(ref_logits[m] - logits[m]).max()),
        args.logit_atol))

    run_greedy_match(args, report, model, params, cfg, device)
    return params, cfg


def run_greedy_match(args, report, hf_model, params, cfg, device):
    """Greedy tokens of HF ``generate`` against the port's engine (the
    prompt fed as embeddings, as the fusion path decodes)."""
    import torch

    from ..inference.engine import _generate_from_embeds
    from ..models import qwen3

    rng = np.random.default_rng(args.seed + 1)
    B, S, T = args.prompts, args.seq_len, args.new_tokens
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    mask = np.ones((B, S), np.int64)

    with torch.no_grad():
        hf_out = hf_model.generate(
            torch.tensor(ids), attention_mask=torch.tensor(mask),
            max_new_tokens=T, do_sample=False, num_beams=1,
            pad_token_id=0, eos_token_id=None)
    ref = hf_out[:, S:].numpy()

    embeds = qwen3.embed_tokens(params, torch.as_tensor(ids, device=device))
    got = _generate_from_embeds(
        params, cfg, embeds,
        torch.as_tensor(mask, dtype=torch.int32, device=device),
        _greedy(T)).cpu().numpy()

    match = (ref == got)
    per_prompt = match.all(axis=1)
    first_div = int(np.argmin(match.all(axis=0))) if not match.all() else -1
    report["checks"].append({
        "check": "greedy_decode_match",
        "prompts": B, "new_tokens": T,
        "exact_match_fraction": float(per_prompt.mean()),
        "token_match_fraction": float(match.mean()),
        "first_divergence_step": first_div,
        "pass": bool(per_prompt.mean() == 1.0),
    })


def run_encoder_parity(args, report, path: str, modality: str, device):
    import torch
    from transformers import AutoModelForMaskedLM

    from ..models import esm
    from ..models.hf_import import (esm_cfg_from_hf_config, esm_from_hf,
                                    load_hf_state)

    model = AutoModelForMaskedLM.from_pretrained(
        path, torch_dtype=torch.float32, attn_implementation="eager",
        trust_remote_code=args.trust_remote_code).eval()
    cfg = esm_cfg_from_hf_config(model.config, dtype="float32")
    params = esm_from_hf(load_hf_state(path), cfg, dtype="float32",
                         device=device)

    rng = np.random.default_rng(args.seed + 2)
    B, S = 4, min(args.seq_len, cfg.max_position_embeddings - 2)
    ids = rng.integers(4, cfg.vocab_size, (B, S))
    ids[:, 0] = 0  # cls
    mask = np.ones((B, S), np.int64)
    mask[2, -S // 4:] = 0
    ids[2, -S // 4:] = cfg.pad_token_id

    with torch.no_grad():
        out = model.esm(torch.tensor(ids),
                        attention_mask=torch.tensor(mask),
                        output_hidden_states=True)
        got, per_layer = esm.forward_hidden(
            params, cfg, torch.as_tensor(ids, device=device),
            torch.as_tensor(mask, device=device), output_hidden_states=True)

    m = mask.astype(bool)
    ref = out.last_hidden_state.numpy()
    report[f"{modality}_layerwise"] = _layerwise_report(
        _np(per_layer), out.hidden_states, mask)
    report["checks"].append(_check(
        f"{modality}_final_hidden",
        float(np.abs(ref[m] - _np(got)[m]).max()), args.hidden_atol))
    return params, cfg


def _projectors(text_cfg, dna_cfg, prot_cfg):
    """Seeded random projectors, identical on both sides, so the fusion
    checks gate the MECHANISM with or without trained projector weights."""
    H = text_cfg.hidden_size

    def make_proj(seed, h_in):
        r = np.random.default_rng(seed)
        return {"kernel": (r.standard_normal((h_in, H)) * 0.02
                           ).astype(np.float32),
                "bias": np.zeros((H,), np.float32)}

    return make_proj(10, dna_cfg.hidden_size), make_proj(11,
                                                         prot_cfg.hidden_size)


def _hf_injected_embeds(text_model, dna_model, prot_model, dproj, pproj,
                        ids, dna_ids, prot_ids, dna_pos, prot_pos, K):
    """The reference's fusion on the HF side: token embeddings with each
    segment's projected encoder states written over its K placeholder rows
    in place."""
    import torch
    B = ids.shape[0]
    emb = text_model.get_input_embeddings()(torch.tensor(ids))
    d_emb = dna_model.esm(torch.tensor(dna_ids.reshape(B, K))
                          ).last_hidden_state \
        @ torch.tensor(dproj["kernel"]) + torch.tensor(dproj["bias"])
    p_emb = prot_model.esm(torch.tensor(prot_ids.reshape(B, K))
                           ).last_hidden_state \
        @ torch.tensor(pproj["kernel"]) + torch.tensor(pproj["bias"])
    for b in range(B):
        s = int(dna_pos[b, 0])
        emb[b, s + 1: s + 1 + K] = d_emb[b]
        s = int(prot_pos[b, 0])
        emb[b, s + 1: s + 1 + K] = p_emb[b]
    return emb


def _port_params(text_params, dna_params, prot_params, dproj, pproj, device):
    import torch

    def proj(p):
        return {k: torch.as_tensor(v, device=device) for k, v in p.items()}

    return {"text": text_params, "dna_rna": dna_params,
            "protein": prot_params, "dna_rna_projector": proj(dproj),
            "protein_projector": proj(pproj)}


def run_fusion_parity(args, report, text, dna, protein, device):
    """End-to-end fusion logits: the reference's in-place injection with
    torch/HF primitives against ``models.fusion.forward_logits``."""
    import torch

    from ..models import fusion
    from ..models.configs import FusionConfig

    (text_model, text_params, text_cfg) = text
    (dna_model, dna_params, dna_cfg) = dna
    (prot_model, prot_params, prot_cfg) = protein

    K = 8
    cfg = FusionConfig(text=text_cfg, dna_rna=dna_cfg, protein=prot_cfg,
                       dna_rna_k_tokens=K, protein_k_tokens=K)
    rng = np.random.default_rng(args.seed + 3)
    dproj, pproj = _projectors(text_cfg, dna_cfg, prot_cfg)

    B, S = 2, 2 * (K + 2) + 12
    ids = rng.integers(0, text_cfg.vocab_size, (B, S))
    dna_ids = rng.integers(4, dna_cfg.vocab_size, (B, 1, K))
    prot_ids = rng.integers(4, prot_cfg.vocab_size, (B, 1, K))
    dna_pos = np.array([[1], [2]], np.int32)
    prot_pos = np.array([[K + 4], [K + 5]], np.int32)

    with torch.no_grad():
        emb = _hf_injected_embeds(text_model, dna_model, prot_model, dproj,
                                  pproj, ids, dna_ids, prot_ids, dna_pos,
                                  prot_pos, K)
        ref_logits = text_model(inputs_embeds=emb).logits.numpy()

        def t(a, dt=torch.int32):
            return torch.as_tensor(a, dtype=dt, device=device)

        params = _port_params(text_params, dna_params, prot_params, dproj,
                              pproj, device)
        batch = {"input_ids": t(ids), "attention_mask": t(np.ones((B, S))),
                 "dna_rna_tokens": t(dna_ids), "dna_rna_pos": t(dna_pos),
                 "protein_tokens": t(prot_ids), "protein_pos": t(prot_pos)}
        got = _np(fusion.forward_logits(params, cfg, batch))
    report["checks"].append(_check(
        "fusion_logits", float(np.abs(ref_logits - got).max()),
        args.logit_atol))


GATE_TASKS = ("pd-prom_300_all", "emp-H3K4me1", "Solubility",
              "tf_h-0", "cpd-prom_core_all")


def run_eval_score_gate(args, report, text, dna, protein, device):
    """--full-gate leg: the eval-score parity gate as one command.

    Greedy-generates ``--gate-prompts`` omics prompts (binary tasks with
    injected DNA/protein segments) through BOTH stacks (the HF reference
    composition with in-place injection, and the port's fusion engine),
    writes each side's inference JSONL, scores both with the port's
    evalsuite, and gates on the max per-task x100-score delta
    (``--score-tol``). Outputs are decoded with the text checkpoint's
    tokenizer when present, else a deterministic id -> "t<i>" fallback
    (identical on both sides)."""
    import torch

    from ..evalsuite.harness import evaluate_file
    from ..inference.engine import _generate_from_embeds
    from ..models import fusion
    from ..models.configs import FusionConfig

    (text_model, text_params, text_cfg) = text
    (dna_model, dna_params, dna_cfg) = dna
    (prot_model, prot_params, prot_cfg) = protein

    K = 8
    cfg = FusionConfig(text=text_cfg, dna_rna=dna_cfg, protein=prot_cfg,
                       dna_rna_k_tokens=K, protein_k_tokens=K)
    rng = np.random.default_rng(args.seed + 4)
    B, T = args.gate_prompts, args.new_tokens
    S = 2 * (K + 2) + 16

    ids = rng.integers(0, text_cfg.vocab_size, (B, S))
    dna_ids = rng.integers(4, dna_cfg.vocab_size, (B, 1, K))
    prot_ids = rng.integers(4, prot_cfg.vocab_size, (B, 1, K))
    dna_pos = np.full((B, 1), 1, np.int32)
    prot_pos = np.full((B, 1), K + 4, np.int32)
    tasks = [GATE_TASKS[i % len(GATE_TASKS)] for i in range(B)]
    labels = ["positive" if i % 2 == 0 else "negative" for i in range(B)]
    dproj, pproj = _projectors(text_cfg, dna_cfg, prot_cfg)

    # ---- reference stack: HF embed + in-place injection + generate ----
    with torch.no_grad():
        emb = _hf_injected_embeds(text_model, dna_model, prot_model, dproj,
                                  pproj, ids, dna_ids, prot_ids, dna_pos,
                                  prot_pos, K)
        hf_out = text_model.generate(
            inputs_embeds=emb,
            attention_mask=torch.ones((B, S), dtype=torch.long),
            max_new_tokens=T, do_sample=False, num_beams=1,
            pad_token_id=0, eos_token_id=None)
    # generate(inputs_embeds=...) returns ONLY the new tokens
    ref_toks = hf_out[:, -T:].numpy()

    # ---- the port's stack: fusion engine, greedy ----
    def t(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    params = _port_params(text_params, dna_params, prot_params, dproj,
                          pproj, device)
    with torch.no_grad():
        embeds = fusion.build_inputs_embeds(params, cfg, {
            "input_ids": t(ids), "dna_rna_tokens": t(dna_ids),
            "dna_rna_pos": t(dna_pos), "protein_tokens": t(prot_ids),
            "protein_pos": t(prot_pos)})
    got_toks = _generate_from_embeds(
        text_params, text_cfg, embeds, t(np.ones((B, S))),
        _greedy(T)).cpu().numpy()

    # ---- decode (identical function both sides) ----
    try:
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(args.text)

        def decode(row):
            return tok.decode([int(t) for t in row],
                              skip_special_tokens=True)
    except Exception:
        def decode(row):
            return " ".join(f"t{int(t)}" for t in row)

    out_dir = os.path.dirname(os.path.abspath(
        args.output or "benchmarks/x")) or "."
    paths = {}
    for name, toks in (("reference", ref_toks), ("molly_tpu", got_toks)):
        path = os.path.join(out_dir, f"gate_infer_{name}.jsonl")
        with open(path, "w") as f:
            for i in range(B):
                f.write(json.dumps({
                    "task": tasks[i], "label": labels[i],
                    "model_output": decode(toks[i])}) + "\n")
        paths[name] = path
    ref_scores = evaluate_file(paths["reference"])
    got_scores = evaluate_file(paths["molly_tpu"])

    deltas = {}
    for omics, tasks_d in ref_scores.items():
        for task, md in tasks_d.items():
            for metric, v in md.items():
                g = got_scores.get(omics, {}).get(task, {}).get(metric)
                if isinstance(v, (int, float)) and isinstance(
                        g, (int, float)):
                    deltas[f"{task}/{metric}"] = round(abs(v - g), 4)
    max_delta = max(deltas.values()) if deltas else float("inf")
    tok_match = float((ref_toks == got_toks).mean())
    report["eval_score_gate"] = {
        "per_task_delta": deltas, "reference_scores": ref_scores,
        "molly_tpu_scores": got_scores, "jsonl": paths}
    report["checks"].append({
        "check": "eval_score_parity", "prompts": B, "new_tokens": T,
        "max_abs_diff": max_delta, "atol": args.score_tol,
        "token_match_fraction": tok_match,
        "pass": bool(deltas and max_delta <= args.score_tol),
    })


def main(argv=None) -> Dict[str, Any]:
    import torch

    args = build_argparser().parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to run "
                         "the port's side on the CPU")
    device = torch.device(args.device or "cuda")
    name = os.path.basename(os.path.normpath(args.text))
    out_path = args.output or os.path.join("benchmarks",
                                           f"parity_{name}.json")
    report: Dict[str, Any] = {
        "text": args.text, "dna_rna": args.dna_rna,
        "protein": args.protein, "checks": [],
    }

    text_params, text_cfg = run_text_parity(args, report, device)

    dna = prot = None
    if args.dna_rna:
        dna = run_encoder_parity(args, report, args.dna_rna, "dna_rna",
                                 device)
    if args.protein:
        prot = run_encoder_parity(args, report, args.protein, "protein",
                                  device)

    if dna and prot:
        from transformers import AutoModelForCausalLM, AutoModelForMaskedLM

        def hf(cls, path):
            return cls.from_pretrained(path, torch_dtype=torch.float32,
                                       attn_implementation="eager").eval()

        text = (hf(AutoModelForCausalLM, args.text), text_params, text_cfg)
        dna = (hf(AutoModelForMaskedLM, args.dna_rna), *dna)
        prot = (hf(AutoModelForMaskedLM, args.protein), *prot)
        run_fusion_parity(args, report, text, dna, prot, device)
        if args.full_gate:
            run_eval_score_gate(args, report, text, dna, prot, device)
    elif args.full_gate:
        raise SystemExit("--full-gate needs --dna-rna and --protein")

    report["all_pass"] = all(c["pass"] for c in report["checks"])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    for c in report["checks"]:
        status = "PASS" if c["pass"] else "FAIL"
        detail = (f"max|Δ|={c['max_abs_diff']:.2e}"
                  if "max_abs_diff" in c else
                  f"exact={c['exact_match_fraction']:.3f}")
        print(f"[parity] {c['check']}: {status} ({detail})")
    print(f"[parity] report -> {out_path} "
          f"(all_pass={report['all_pass']}, port on {device})")
    return report


if __name__ == "__main__":
    main()
