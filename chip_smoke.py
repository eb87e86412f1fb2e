#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``molly_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each printed with its time; any failure exits non-zero:
  1. preamble: TF32 off for matmuls and cuDNN; the card's name and power
     limit from nvidia-smi.
  2. build: compile every CUDA kernel in ``molly_tpu_torch/csrc`` with nvcc
     for sm_90a (all sources in parallel).
  3. kernel parity: each kernel against its plain PyTorch version (run in
     fp32 from the same bf16 inputs) at the shapes the main path gives it,
     with the tolerances stated below, plus kernel and plain times.
  4. small reference: a small fp32 fusion model on the card (through the
     kernels) against the same weights on the CPU (plain versions): logits
     and greedy tokens must agree.
  5. main path, bf16: molly-1.7B width — qwen3-1.7b (vocab 151,936, 28
     layers) fused with nt-500m and esm2-650m, k = 1024 tokens and 4 slots
     per modality, max length 3072 — random weights from --seed, four
     tri-modal requests encoded by OmicsSampleEncoder.encode_test and
     decoded by the batch CLI's ``run_batches`` with sampling.
  6. main path, int8: the same requests after ``quantize_for_decode``,
     greedy.
  7. checks: every kernel of each main-path run launched at least once in
     that run (counts set to 0 just before it, read just after).

Cut against the CLI's defaults: batch 4 instead of 32, and 64 (bf16) / 32
(int8) new tokens instead of 3072. The last two lines of standard output
are the kernels JSON line and the device JSON line.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

# tolerances (stated here, checked below)
FLASH_O_ATOL = 2e-2     # bf16 output of unit-scale attention
FLASH_LSE_ATOL = 1e-3   # fp32 LSE, same fp32 math on both sides
RMS_REL = 2.0 ** -7     # one bf16 ulp at the top of a binade: the kernel
#                         rounds twice (x_hat, then w * x_hat) like the
#                         reference's weight-after-cast
INT8_REL = 1e-2         # of the output's max-abs (bf16 output rounding)
SMALL_LOGIT_ATOL = 1e-3  # fp32 small model, card kernels vs CPU plain path

REPLACES = {
    "flash_attention_fwd": "molly_tpu/ops/flash_attention.py:61",
    "rmsnorm_fwd": "molly_tpu/ops/rmsnorm_pallas.py:26",
    "int8_matmul": "molly_tpu/ops/quant.py:46",
}
SOURCES = {
    "flash_attention_fwd": ("cuda", "molly_tpu_torch/csrc/flash_attention_fwd.cu"),
    "rmsnorm_fwd": ("triton", "molly_tpu_torch/ops/rmsnorm_triton.py"),
    "int8_matmul": ("cuda", "molly_tpu_torch/csrc/int8_matmul.cu"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"[phase] {self.name} ...")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch
        if exc_type is None:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"[phase] {self.name}: {status} in {dt:.2f} s")
        return False


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def counters():
    from molly_tpu_torch.ops import flash_attention, quant, rmsnorm_triton
    return {"flash_attention_fwd": flash_attention.flash_attention_fwd,
            "rmsnorm_fwd": rmsnorm_triton.rms_norm,
            "int8_matmul": quant.int8_matmul}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------


def parity_flash(g, results):
    import torch

    from molly_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    dev = "cuda"

    def case(name, q, k, v, mask, causal, scale, valid_rows, iters):
        o, lse = flash_attention_fwd(q, k, v, mask, causal, scale, 0)
        ro, rlse = flash_attention_plain(q.float(), k.float(), v.float(),
                                         mask, causal, scale, 0)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(o).all()) or not bool(
                torch.isfinite(lse).all()):
            raise AssertionError(f"flash {name}: non-finite output")
        vr = valid_rows[:, :, None, None]                   # [B, Sq, 1, 1]
        err = ((o.float() - ro).abs() * vr).max().item()
        lse_err = ((lse - rlse).abs()
                   * valid_rows[:, None, :]).max().item()
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal,
                                                 scale, 0), iters)
        plain_ms = time_ms(lambda: flash_attention_plain(
            q, k, v, mask, causal, scale, 0), max(1, iters // 2))
        log(f"  flash {name}: max|dO| {err:.3e} (tol {FLASH_O_ATOL}), "
            f"max|dLSE| {lse_err:.3e} (tol {FLASH_LSE_ATOL}); "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if not (err <= FLASH_O_ATOL and lse_err <= FLASH_LSE_ATOL):
            raise AssertionError(f"flash {name}: parity miss")
        del ro, rlse
        torch.cuda.empty_cache()
        return {"case": name, "max_abs_err": err, "lse_err": lse_err,
                "ms": ms, "plain_ms": plain_ms}

    cases = []
    # decoder prefill: q [4, 3072, 16, 128] over the [4, 8, 3136, 256]
    # bnsd cache window (k = [..., :128], v = [..., 128:]), causal, with the
    # engine's full-cache mask (left padding, empty decode columns)
    B, S, T, N, Nkv, D = 4, 3072, 64, 16, 8, 128
    q = torch.randn((B, S, N, D), generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn((B, Nkv, S + T, 2 * D), generator=g,
                     device=dev).to(torch.bfloat16)
    k, v = kv[..., :D].transpose(1, 2), kv[..., D:].transpose(1, 2)
    mask = torch.zeros((B, S + T), dtype=torch.int32, device=dev)
    pads = (0, 517, 1203, 2999)
    for b, p in enumerate(pads):
        mask[b, p:S] = 1
    valid = (torch.cumsum(mask[:, :S], dim=1) > 0).float()
    cases.append(case("decoder_prefill_bf16[4,3072,16,128]x3136", q, k, v,
                      mask, True, D ** -0.5, valid, 5))
    del q, kv, k, v
    # encoders: [16, 1024, 20, 64] bidirectional at scale 1.0 (ESM scales q
    # by Dh^-0.5 before rotary); dummy segments attend to position 0 only
    B, S, N, D = 16, 1024, 20, 64
    q = (torch.randn((B, S, N, D), generator=g, device=dev)
         * D ** -0.5).to(torch.bfloat16)
    k = torch.randn((B, S, N, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, N, D), generator=g, device=dev).to(torch.bfloat16)
    lengths = (1024, 669, 602, 1, 1, 1, 1, 1, 1024, 311, 1, 1, 77, 1, 1, 1)
    mask = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1
    valid = torch.ones((B, S), device=dev)
    cases.append(case("encoder_bf16[16,1024,20,64]", q, k, v, mask, False,
                      1.0, valid, 10))
    results["flash_attention_fwd"] = cases


def parity_rmsnorm(g, results):
    import torch

    from molly_tpu_torch.ops.rmsnorm_triton import rms_norm, rms_norm_plain
    dev = "cuda"

    def case(name, x, w, iters):
        y = rms_norm(x, w, 1e-6)
        ref = rms_norm_plain(x.float(), w.float(), 1e-6)
        err = (y.float() - ref).abs()
        rel_excess = (err - RMS_REL * ref.abs()).max().item()
        max_err = err.max().item()
        ms = time_ms(lambda: rms_norm(x, w, 1e-6), iters)
        plain_ms = time_ms(lambda: rms_norm_plain(x, w, 1e-6), iters)
        log(f"  rmsnorm {name}: max|err| {max_err:.3e}, max(err - 2^-7|ref|)"
            f" {rel_excess:.3e} (must be <= 0); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        if rel_excess > 0 or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"rmsnorm {name}: parity miss")
        return {"case": name, "max_abs_err": max_err, "ms": ms,
                "plain_ms": plain_ms}

    x = torch.randn((4 * 3072, 2048), generator=g, device=dev).to(
        torch.bfloat16)
    w = (1 + 0.1 * torch.randn((2048,), generator=g, device=dev)).to(
        torch.bfloat16)
    cases = [case("hidden_bf16[12288,2048]", x, w, 20)]
    # fused decode branch: stacked qk_norm over [B, S, Nq+Nkv, Dh]
    x = torch.randn((4, 3072, 24, 128), generator=g, device=dev).to(
        torch.bfloat16)
    w = (1 + 0.1 * torch.randn((24, 128), generator=g, device=dev)).to(
        torch.bfloat16)
    cases.append(case("qk_norm_bf16[4,3072,24,128]x[24,128]", x, w, 20))
    # decode step: [4, 1, 2048]
    x = torch.randn((4, 1, 2048), generator=g, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((2048,), generator=g, device=dev)).to(
        torch.bfloat16)
    cases.append(case("decode_bf16[4,1,2048]", x, w, 50))
    results["rmsnorm_fwd"] = cases


def parity_int8(g, results):
    import torch

    from molly_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain
    dev = "cuda"

    def case(name, M, K, N, iters):
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        w_q = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                            dtype=torch.int8)
        scale = (torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-4)
        q = {"w_q": w_q, "scale": scale}
        y = int8_matmul(x, q)
        ref = int8_matmul_plain(x.float(), q)
        err = (y.float() - ref).abs().max().item()
        tol = INT8_REL * ref.abs().max().item()
        ms = time_ms(lambda: int8_matmul(x, q), iters)
        plain_ms = time_ms(lambda: int8_matmul_plain(x, q), iters)
        log(f"  int8 {name}: max|err| {err:.3e} (tol {tol:.3e}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= tol or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"int8 {name}: parity miss")
        return {"case": name, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms}

    results["int8_matmul"] = [
        case("lm_head_decode_bf16[4,2048]x[2048,151936]", 4, 2048, 151936,
             20),
        case("qkv_prefill_bf16[12288,2048]x[2048,4096]", 12288, 2048, 4096,
             5),
        case("down_decode_bf16[4,6144]x[6144,2048]", 4, 6144, 2048, 50),
    ]


# ---------------------------------------------------------------------------
# small reference and main path
# ---------------------------------------------------------------------------


def small_reference(seed: int):
    """A small fp32 fusion model (head dims the kernels take) on the card
    against the same weights on the CPU (plain versions)."""
    import torch

    from molly_tpu_torch.inference.engine import generate
    from molly_tpu_torch.models import (FusionConfig, GenerationConfig,
                                        fusion, qwen3, tiny_esm, tiny_qwen3)

    cfg = FusionConfig(
        text=tiny_qwen3(vocab_size=384, hidden_size=256,
                        intermediate_size=512, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=64),
        dna_rna=tiny_esm(vocab_size=4107, hidden_size=128,
                         intermediate_size=256, num_attention_heads=2,
                         mask_token_id=2, mlp_type="swiglu", mlp_bias=False),
        protein=tiny_esm(vocab_size=33, hidden_size=128,
                         intermediate_size=256, num_attention_heads=2),
        dna_rna_k_tokens=16, protein_k_tokens=16)
    cpu = fusion.init_params(cfg, torch.Generator().manual_seed(seed))
    gpu = _tree_to(cpu, "cuda")
    g = torch.Generator().manual_seed(seed + 1)
    B, S = 3, 96
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[1, :20] = 0
    mask[2, :70] = 0
    batch = {
        "input_ids": torch.randint(0, 384, (B, S), generator=g),
        "attention_mask": mask,
        "dna_rna_tokens": torch.randint(6, 4102, (B, 2, 16), generator=g),
        "dna_rna_pos": torch.tensor([[2, 40], [30, -1], [-1, -1]]),
        "protein_tokens": torch.randint(4, 24, (B, 1, 16), generator=g),
        "protein_pos": torch.tensor([[60], [-1], [75]]),
    }
    out = {}
    with torch.inference_mode():
        for name, p in (("plain", cpu), ("kernels", gpu)):
            dev = "cpu" if name == "plain" else "cuda"
            b = {k: t.to(dev) for k, t in batch.items()}
            for tag, params in (("", p), ("_int8", {
                    **p, "text": qwen3.quantize_for_decode(p["text"],
                                                           cfg.text)})):
                logits = fusion.forward_logits(params, cfg, b)
                toks = generate(params, cfg, b, GenerationConfig(
                    max_new_tokens=8, do_sample=False, eos_token_id=-1))
                out[name + tag] = (logits.float().cpu(), toks.cpu())
    errs = {}
    for tag in ("", "_int8"):
        lp, tp = out["plain" + tag]
        lk, tk = out["kernels" + tag]
        if not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"small reference{tag}: non-finite logits")
        valid = mask.bool()[:, :, None]
        err = ((lk - lp).abs() * valid).max().item()
        errs[tag or "_bf"] = err
        log(f"  small reference{tag or ''}: max|dlogits| {err:.3e} "
            f"(tol {SMALL_LOGIT_ATOL}); greedy tokens equal: "
            f"{bool(torch.equal(tk, tp))}")
        if err > SMALL_LOGIT_ATOL or not torch.equal(tk, tp):
            raise AssertionError(f"small reference{tag}: kernels disagree "
                                 f"with the plain path")
    return errs


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def make_requests(seed: int):
    """Four tri-modal prompts with inline <dna>/<rna>/<protein> tags."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def dna(n):
        return "".join(rng.choice(list("ACGT"), n))

    def protein(n):
        return "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))

    return [
        {"task": "pd-prom_300", "kind": "DNA",
         "input": f"Is this a promoter? <dna>{dna(4000)}</dna> "
                  "Answer yes or no.", "output": "yes", "label": "1"},
        {"task": "Solubility-Solubility", "kind": "Protein",
         "input": f"Predict the solubility of <protein>{protein(600)}"
                  "</protein>.", "output": "soluble", "label": "1"},
        {"task": "rna_protein_interaction", "kind": "Multi",
         "input": f"Does <rna>{dna(2500)}</rna> bind <protein>"
                  f"{protein(400)}</protein>?", "output": "no", "label": "0"},
        {"task": "promoter_enhancer_interaction", "kind": "DNA",
         "input": f"Promoter <dna>{dna(1500)}</dna> and enhancer "
                  f"<dna>{dna(1800)}</dna>: do they interact?",
         "output": "yes", "label": "1"},
    ]


def main_path(params, cfg, samples, text_tok, gen, seed, label):
    import torch

    from molly_tpu_torch.inference.cli import run_batches

    stats = {}
    buf = io.StringIO()
    reset_counts()
    records = run_batches(samples, params, cfg, gen, text_tok, buf,
                          batch_size=4,
                          generator=torch.Generator("cuda").manual_seed(seed),
                          total=len(samples), stats=stats)
    counts = read_counts()
    lines = buf.getvalue().splitlines()
    steps = stats.get("decode_steps", 0)
    log(f"  {label}: encoders {stats['encode_s']:.3f} s, prefill "
        f"{stats['prefill_s']:.3f} s, decode {steps} steps in "
        f"{stats['decode_s']:.3f} s = "
        f"{len(samples) * steps / max(stats['decode_s'], 1e-9):.1f} tok/s "
        f"(batch {len(samples)}); launches {counts}")
    log(f"  {label}: first record: {lines[0][:300]}")
    if len(records) != len(samples) or not stats.get("logits_finite"):
        raise AssertionError(f"{label}: bad output (records "
                             f"{len(records)}, finite "
                             f"{stats.get('logits_finite')})")
    for line in lines:
        rec = json.loads(line)
        assert set(rec) == {"decoded_output", "input", "gt_output",
                            "gt_label", "task", "kind"}, rec.keys()
    return counts


def drive_main_paths(seed: int):
    """Phases 5-7: the bf16 and int8 runs at molly-1.7B width; returns each
    kernel's launches summed over both runs."""
    import torch

    from molly_tpu.data import (DataConfig, OmicsSampleEncoder,
                                default_modality_tokenizers,
                                load_text_tokenizer)

    from molly_tpu_torch.models import (ESM_PRESETS, QWEN3_PRESETS,
                                        FusionConfig, GenerationConfig,
                                        fusion, qwen3)
    text_tok = load_text_tokenizer(None)
    dna_tok, prot_tok = default_modality_tokenizers()
    enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=3072, dna_rna_k_tokens=1024, protein_k_tokens=1024,
        max_dna_rna_segments=4, max_protein_segments=4))
    samples = [enc.encode_test(r) for r in make_requests(seed)]
    cfg = FusionConfig(text=QWEN3_PRESETS["qwen3-1.7b"],
                       dna_rna=ESM_PRESETS["nt-500m"],
                       protein=ESM_PRESETS["esm2-650m"],
                       dna_rna_k_tokens=1024, protein_k_tokens=1024)
    with Phase("init molly-1.7B-width params"):
        params = fusion.init_params(
            cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    common = dict(temperature=0.8, top_p=0.95, top_k=20,
                  repetition_penalty=1.1, eos_token_id=text_tok.eos_token_id,
                  pad_token_id=text_tok.pad_token_id)
    launches = {name: 0 for name in REPLACES}

    def run_path(label, gen, needed):
        with Phase(f"main path {label}, {gen.max_new_tokens} new tokens"):
            counts = main_path(params, cfg, samples, text_tok, gen, seed,
                               label)
        for name in needed:
            if counts[name] <= 0:
                raise AssertionError(f"{label} main path never launched "
                                     f"{name}")
        for name, n in counts.items():
            launches[name] += n

    run_path("bf16 sampled",
             GenerationConfig(max_new_tokens=64, do_sample=True, **common),
             ("flash_attention_fwd", "rmsnorm_fwd"))
    with Phase("quantize_for_decode"):
        params["text"] = qwen3.quantize_for_decode(params["text"], cfg.text)
    run_path("int8 greedy",
             GenerationConfig(max_new_tokens=32, do_sample=False, **common),
             tuple(REPLACES))
    log(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def run(args) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from molly_tpu_torch.ops import _cuda_build

    with Phase(f"build ({len(_cuda_build.SOURCES)} CUDA sources, nvcc "
               f"in parallel)"):
        _cuda_build.build()

    g = torch.Generator("cuda").manual_seed(args.seed)
    parity = {}
    with Phase("parity flash_attention_fwd"):
        parity_flash(g, parity)
    with Phase("parity rmsnorm_fwd"):
        parity_rmsnorm(g, parity)
    with Phase("parity int8_matmul"):
        parity_int8(g, parity)
    with Phase("small reference"):
        small_reference(args.seed)

    launches = drive_main_paths(args.seed)

    kernels = []
    for name, cases in parity.items():
        route, source = SOURCES[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
            "cases": cases})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    return run(ap.parse_args())


if __name__ == "__main__":
    sys.exit(main())
