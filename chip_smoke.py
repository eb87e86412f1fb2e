#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``molly_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--profile-dir DIR]

Phases, each printed with its time; any failure exits non-zero:
  1. preamble: TF32 off for matmuls and cuDNN; the card's name and power
     limit from nvidia-smi.
  2. build: compile every CUDA kernel in ``molly_tpu_torch/csrc`` with nvcc
     for sm_90a (all sources in parallel).
  3. kernel parity: each of the six kernels against its plain PyTorch
     version (run in fp32 from the same bf16 inputs) at the shapes the main
     paths give it, with the tolerances stated below; kernel and plain
     times by CUDA events, the time of the one PyTorch call that computes
     the same function (``library_ms``, used nowhere in the port), and the
     bound: the least time the card could take, the larger of bytes / 3.35
     TB/s (each input read once, each output written once) and operations
     / peak rate (989 TFLOP/s for bf16 products, 67 TFLOP/s fp32
     otherwise), counting only the (query, key) pairs this run's masks
     allow.
  4. small reference, generation: a small fp32 fusion model on the card
     (through the kernels) against the same weights on the CPU (plain
     versions): logits and greedy tokens must agree.
  5. small reference, training: the same model, one full fine-tune step and
     one LoRA step on the card against the CPU (loss and every trainable
     gradient), and five steps on one repeated batch must lower the loss.
  6. main path, generation, bf16: molly-1.7B width — qwen3-1.7b (vocab
     151,936, 28 layers) fused with nt-500m and esm2-650m, k = 1024 tokens
     and 4 slots per modality, max length 3072 — random weights from
     --seed, four tri-modal requests encoded by
     OmicsSampleEncoder.encode_test and decoded by the batch CLI's
     ``run_batches`` with sampling.
  7. main path, training, full fine-tune: the same weights, the train CLI's
     defaults (batch 4, max length 1024, k = 128 tokens and 4 slots per
     modality, train-llm and train-mlp, frozen encoders, fused LCE, no
     remat), four tri-modal samples through
     OmicsSampleEncoder.encode_train and ``train_loop`` for 3 steps.
  8. main path, training, QLoRA: the same with --use-lora --qlora (r 64,
     dropout 0.05) over an int8 base, 3 steps, then export_adapter,
     load_adapter, merge_lora and 8 greedy tokens through ``run_batches``.
  9. main path, generation, int8: the requests of phase 6 after
     ``quantize_for_decode``, greedy.
 10. checks: every kernel of each main-path run launched at least once in
     that run (counts set to 0 just before it, read just after).

Cut against the CLIs' defaults: generation runs batch 4 instead of 32 and
32 (bf16) / 16 (int8) new tokens instead of 3072; training runs 3 steps.
The last two lines of standard output are the kernels JSON line and the
device JSON line.
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
FLASH_BWD_REL = 1e-2    # of the reference's max-abs: one bf16 rounding of
#                         dQ/dK/dV (2^-8 of the value) plus the few P and dS
#                         terms that round to the other bf16 neighbour
RMS_BWD_REL = 2.0 ** -7  # dx: one bf16 rounding of the output ...
RMS_BWD_ABS = 1e-5      # ... plus the fp32 sums' order where dx cancels to 0
RMS_DW_REL = 1e-2       # of max|dw|: dw is a sum over up to 65,536 rows,
#                         rounded once to bf16 at the end
TRAIN_LOSS_ATOL = 1e-4  # fp32 small model, one step, card vs CPU
TRAIN_GRAD_REL = 1e-3   # of each gradient's max-abs

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

REPLACES = {
    "flash_attention_fwd": "molly_tpu/ops/flash_attention.py:61",
    "flash_attention_dq": "molly_tpu/ops/flash_attention.py:221",
    "flash_attention_dkv": "molly_tpu/ops/flash_attention.py:264",
    "rmsnorm_fwd": "molly_tpu/ops/rmsnorm_pallas.py:26",
    "rmsnorm_bwd": "molly_tpu/ops/rmsnorm_pallas.py:34",
    "int8_matmul": "molly_tpu/ops/quant.py:46",
}
_FWD_CU = "molly_tpu_torch/csrc/flash_attention_fwd.cu"
_BWD_CU = "molly_tpu_torch/csrc/flash_attention_bwd.cu"
SOURCES = {
    "flash_attention_fwd": ("cuda", _FWD_CU),
    "flash_attention_dq": ("cuda", _BWD_CU),
    "flash_attention_dkv": ("cuda", _BWD_CU),
    "rmsnorm_fwd": ("triton", "molly_tpu_torch/ops/rmsnorm_triton.py"),
    "rmsnorm_bwd": ("triton", "molly_tpu_torch/ops/rmsnorm_triton.py"),
    "int8_matmul": ("cuda", "molly_tpu_torch/csrc/int8_matmul.cu"),
}
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "rmsnorm_fwd", "rmsnorm_bwd")


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


def time_ms(fn, iters: int, warmup: int = 1, setup=None) -> float:
    """Device milliseconds per call: ``iters`` calls are captured into one
    CUDA graph and the graph's replay is timed with CUDA events, so the
    host's cost of launching (tens of microseconds for a small kernel,
    which would otherwise be all that is measured) does not count.
    ``setup``, when given, runs once on the capturing stream and its result
    is handed to ``fn`` (a forward pass whose backward is what is timed:
    autograd runs a backward on its forward's stream)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        if setup is not None:
            ctx = setup()
            call = lambda: fn(ctx)  # noqa: E731
        else:
            call = fn
        for _ in range(warmup):
            call()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def eager_ms(fn, iters: int) -> float:
    """Milliseconds per call of ``iters`` eager calls in a row: the host's
    launch cost included, which bounds a small kernel in an eager loop."""
    import torch
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
            "flash_attention_dq": flash_attention.flash_attention_dq,
            "flash_attention_dkv": flash_attention.flash_attention_dkv,
            "rmsnorm_fwd": rmsnorm_triton.rms_norm,
            "rmsnorm_bwd": rmsnorm_triton.rms_norm_bwd,
            "int8_matmul": quant.int8_matmul}


def bound(nbytes: float, flops: float, kind: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def allowed_pairs(mask, Sq, causal, q_offset=0) -> int:
    """(query, key) pairs per head that the padding mask and the causal
    rule allow, summed over the batch: the work this run's data needs."""
    import torch
    keep = (mask != 0)                                   # [B, Skv]
    if not causal:
        return int(keep.sum().item()) * Sq
    # query i sees keys <= q_offset + i
    csum = torch.cumsum(keep.to(torch.int64), dim=1)
    idx = torch.arange(Sq, device=mask.device) + q_offset
    idx = idx.clamp(max=mask.shape[1] - 1)
    return int(csum[:, idx].sum().item())


def sdpa_inputs(q, k, v, mask, causal, q_offset=0):
    """The same attention as one ``scaled_dot_product_attention`` call:
    [B, N, S, D] views and one boolean mask [B, 1, Sq, Skv]."""
    import torch
    Sq, Skv = q.shape[1], k.shape[1]
    allow = (mask != 0)[:, None, None, :].expand(-1, 1, Sq, -1)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        allow = allow & (q_pos >= torch.arange(Skv, device=q.device))
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            allow.contiguous())


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
    import torch.nn.functional as F

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
        sq, sk, sv, allow = sdpa_inputs(q, k, v, mask, causal)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=allow, scale=scale,
            enable_gqa=q.shape[2] != k.shape[2]), iters)
        pairs = allowed_pairs(mask, q.shape[1], causal)
        bound_ms, bound_by = bound(
            nbytes(q, k, v, o, lse),
            2 * 2 * q.shape[3] * pairs * q.shape[2], "bf16")
        log(f"  flash {name}: max|dO| {err:.3e} (tol {FLASH_O_ATOL}), "
            f"max|dLSE| {lse_err:.3e} (tol {FLASH_LSE_ATOL}); "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
            f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not (err <= FLASH_O_ATOL and lse_err <= FLASH_LSE_ATOL):
            raise AssertionError(f"flash {name}: parity miss")
        del ro, rlse, allow
        torch.cuda.empty_cache()
        return {"case": name, "max_abs_err": err, "lse_err": lse_err,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}

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
    del q, k, v
    # the training forward: [4, 1024, 16, 128] over 8 kv heads, causal,
    # right-padded
    q, k, v, _, mask = train_attention_inputs(g)
    valid = torch.ones((4, 1024), device=dev)
    cases.append(case("train_bf16[4,1024,16,128]", q, k, v, mask, True,
                      128 ** -0.5, valid, 10))
    results["flash_attention_fwd"] = cases


def train_attention_inputs(g, B=4, S=1024, N=16, Nkv=8, D=128,
                           lengths=(1024, 913, 660, 402), q_scale=1.0):
    """q, k, v, dO and the right-padded mask at the train step's shapes."""
    import torch
    dev = "cuda"

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q = (rand(B, S, N, D) * q_scale).to(torch.bfloat16)
    k = rand(B, S, Nkv, D).to(torch.bfloat16)
    v = rand(B, S, Nkv, D).to(torch.bfloat16)
    dout = rand(B, S, N, D).to(torch.bfloat16)
    mask = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b in range(B):
        mask[b, :lengths[b % len(lengths)]] = 1
    return q, k, v, dout, mask


def parity_flash_bwd(g, results):
    import torch
    import torch.nn.functional as F

    from molly_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_dkv, flash_attention_dq,
        flash_attention_fwd)

    def case(name, q, k, v, dout, mask, causal, scale, iters):
        N, D = q.shape[2], q.shape[3]
        o, lse = flash_attention_fwd(q, k, v, mask, causal, scale, 0)
        # rows without a valid key (none here under right padding, but the
        # rule holds for any mask): dO is zero there, as in the model
        has_key = (torch.cumsum(mask, dim=1) > 0) if causal else \
            (mask.sum(dim=1, keepdim=True) > 0).expand_as(mask)
        dout = dout * has_key[:, :, None, None].to(dout.dtype)
        delta = torch.einsum("bsnd,bsnd->bns", dout.float(),
                             o.float()).contiguous()
        args = (q, k, v, mask, lse, delta, dout, causal, scale, 0)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        # the plain version on the same bf16 tensors: fp32 math inside, P
        # and dS rounded to bf16 before their second product as the kernel
        # rounds them
        rq, rk, rv = (t.float() for t in flash_attention_bwd_plain(*args))
        torch.cuda.synchronize()
        errs = {}
        for nm, a, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"flash bwd {name}: non-finite {nm}")
            err = (a.float() - r).abs().max().item()
            tol = FLASH_BWD_REL * r.abs().max().item()
            errs[nm] = err
            if not err <= tol:
                raise AssertionError(f"flash bwd {name}: {nm} max err "
                                     f"{err:.3e} > {tol:.3e}")
        # random dO on every row must still come out finite
        noise = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
        nargs = (q, k, v, mask, lse, delta, noise, causal, scale, 0)
        for t in (flash_attention_dq(*nargs), *flash_attention_dkv(*nargs)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"flash bwd {name}: non-finite with "
                                     f"random dO")
        dq_ms = time_ms(lambda: flash_attention_dq(*args), iters)
        dkv_ms = time_ms(lambda: flash_attention_dkv(*args), iters)
        plain_ms = time_ms(lambda: flash_attention_bwd_plain(*args),
                           max(1, iters // 2))
        # the library's backward computes dQ, dK and dV in one call
        sq, sk, sv, allow = sdpa_inputs(q, k, v, mask, causal)
        sq, sk, sv = (t.detach().requires_grad_(True) for t in (sq, sk, sv))
        sdo = dout.transpose(1, 2)
        library_ms = time_ms(
            lambda so: torch.autograd.grad(so, (sq, sk, sv), sdo,
                                           retain_graph=True),
            iters, setup=lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=allow, scale=scale,
                enable_gqa=q.shape[2] != k.shape[2]))
        pairs = allowed_pairs(mask, q.shape[1], causal)
        dq_bound = bound(nbytes(q, k, v, dout, lse, delta, dq),
                         3 * 2 * D * pairs * N, "bf16")
        dkv_bound = bound(nbytes(q, k, v, dout, lse, delta, dk, dv),
                          4 * 2 * D * pairs * N, "bf16")
        log(f"  flash bwd {name}: max err dq {errs['dq']:.3e} dk "
            f"{errs['dk']:.3e} dv {errs['dv']:.3e} (tol {FLASH_BWD_REL} of "
            f"max|ref|); dq {dq_ms:.3f} ms (bound {dq_bound[0]:.4f} ms, "
            f"{dq_bound[1]}), dkv {dkv_ms:.3f} ms (bound "
            f"{dkv_bound[0]:.4f} ms, {dkv_bound[1]}), plain dq+dkv "
            f"{plain_ms:.3f} ms, library dq+dkv {library_ms:.3f} ms")
        del rq, rk, rv, allow
        torch.cuda.empty_cache()
        common = {"case": name, "plain_ms": plain_ms,
                  "library_ms": library_ms,
                  "note": "plain_ms and library_ms time dQ, dK and dV "
                          "together"}
        return ({**common, "max_abs_err": errs["dq"], "ms": dq_ms,
                 "bound_ms": dq_bound[0], "bound_by": dq_bound[1]},
                {**common, "max_abs_err": max(errs["dk"], errs["dv"]),
                 "ms": dkv_ms, "bound_ms": dkv_bound[0],
                 "bound_by": dkv_bound[1]})

    dq_cases, dkv_cases = [], []
    q, k, v, dout, mask = train_attention_inputs(g)
    a, b = case("train_bf16[4,1024,16,128]x8kv", q, k, v, dout, mask, True,
                128 ** -0.5, 5)
    dq_cases.append(a)
    dkv_cases.append(b)
    del q, k, v, dout
    # bidirectional, D = 64, an encoder's head count (the train step's
    # encoder shape; the encoders are frozen there, so this is parity only)
    q, k, v, dout, mask = train_attention_inputs(
        g, B=16, S=128, N=20, Nkv=20, D=64, lengths=(128, 97, 31, 1),
        q_scale=64 ** -0.5)
    a, b = case("encoder_bf16[16,128,20,64]", q, k, v, dout, mask, False,
                1.0, 10)
    dq_cases.append(a)
    dkv_cases.append(b)
    results["flash_attention_dq"] = dq_cases
    results["flash_attention_dkv"] = dkv_cases


def parity_rmsnorm(g, results):
    import torch
    import torch.nn.functional as F

    from molly_tpu_torch.ops.rmsnorm_triton import (rms_norm, rms_norm_bwd,
                                                    rms_norm_bwd_plain,
                                                    rms_norm_plain)
    dev = "cuda"

    def case(name, x, w, iters):
        y = rms_norm(x, w, 1e-6)
        ref = rms_norm_plain(x.float(), w.float(), 1e-6)
        err = (y.float() - ref).abs()
        rel_excess = (err - RMS_REL * ref.abs()).max().item()
        max_err = err.max().item()
        ms = time_ms(lambda: rms_norm(x, w, 1e-6), iters)
        eager = eager_ms(lambda: rms_norm(x, w, 1e-6), iters)
        plain_ms = time_ms(lambda: rms_norm_plain(x, w, 1e-6), iters)
        # the library call exists for a 1-D weight only
        library_ms = (time_ms(lambda: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
                              iters) if w.ndim == 1 else None)
        bound_ms, bound_by = bound(nbytes(x, w, y), 4 * x.numel(), "fp32")
        log(f"  rmsnorm {name}: max|err| {max_err:.3e}, max(err - 2^-7|ref|)"
            f" {rel_excess:.3e} (must be <= 0); kernel {ms:.4f} ms "
            f"({eager:.4f} ms a call in an eager loop), "
            f"plain {plain_ms:.4f} ms, library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if rel_excess > 0 or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"rmsnorm {name}: parity miss")
        return {"case": name, "max_abs_err": max_err, "ms": ms,
                "eager_ms": eager, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    def bwd_case(name, shape, iters):
        H = shape[-1]
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        gr = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn((H,), generator=g, device=dev)).to(
            torch.bfloat16)
        dx, dw = rms_norm_bwd(x, w, gr, 1e-6, True)
        dx_only, none = rms_norm_bwd(x, w, gr, 1e-6, False)
        rx, rw = rms_norm_bwd_plain(x.float(), w.float(), gr.float(), 1e-6)
        torch.cuda.synchronize()
        err = (dx.float() - rx).abs()
        dx_excess = (err - RMS_BWD_REL * rx.abs() - RMS_BWD_ABS).max().item()
        dw_err = (dw.float() - rw).abs().max().item()
        dw_tol = RMS_DW_REL * rw.abs().max().item()
        ms = time_ms(lambda: rms_norm_bwd(x, w, gr, 1e-6, True), iters)
        eager = eager_ms(lambda: rms_norm_bwd(x, w, gr, 1e-6, True), iters)
        dx_ms = time_ms(lambda: rms_norm_bwd(x, w, gr, 1e-6, False), iters)
        plain_ms = time_ms(lambda: rms_norm_bwd_plain(x, w, gr, 1e-6), iters)
        xl = x.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)
        library_ms = time_ms(
            lambda yl: torch.autograd.grad(yl, (xl, wl), gr,
                                           retain_graph=True),
            iters, setup=lambda: F.rms_norm(xl, (H,), wl, 1e-6))
        bound_ms, bound_by = bound(nbytes(x, gr, w, dx, dw), 12 * x.numel(),
                                   "fp32")
        log(f"  rmsnorm bwd {name}: max|dx err| {err.max().item():.3e}, "
            f"max(err - 2^-7|ref| - 1e-5) {dx_excess:.3e} (must be <= 0), "
            f"max|dw err| {dw_err:.3e} (tol {dw_tol:.3e}); kernel "
            f"{ms:.4f} ms ({dx_ms:.4f} ms without dw, {eager:.4f} ms a call "
            f"in an eager loop), plain "
            f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        if dx_excess > 0 or dw_err > dw_tol or none is not None or \
                not torch.equal(dx, dx_only) or \
                not bool(torch.isfinite(dx).all()):
            raise AssertionError(f"rmsnorm bwd {name}: parity miss")
        return {"case": name, "max_abs_err": max(err.max().item(), dw_err),
                "ms": ms, "ms_without_dw": dx_ms, "eager_ms": eager,
                "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

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
    # the train step's shapes: hidden rows, and per-head rows of 128
    x = torch.randn((4096, 2048), generator=g, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((2048,), generator=g, device=dev)).to(
        torch.bfloat16)
    cases.append(case("train_hidden_bf16[4096,2048]", x, w, 20))
    x = torch.randn((4, 1024, 16, 128), generator=g, device=dev).to(
        torch.bfloat16)
    w = (1 + 0.1 * torch.randn((128,), generator=g, device=dev)).to(
        torch.bfloat16)
    cases.append(case("train_q_norm_bf16[4,1024,16,128]x[128]", x, w, 20))
    results["rmsnorm_fwd"] = cases
    results["rmsnorm_bwd"] = [
        bwd_case("train_hidden_bf16[4096,2048]", (4096, 2048), 20),
        bwd_case("train_q_norm_bf16[4,1024,16,128]x[128]",
                 (4, 1024, 16, 128), 20),
        bwd_case("train_k_norm_bf16[4,1024,8,128]x[128]",
                 (4, 1024, 8, 128), 20),
    ]


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
        bound_ms, bound_by = bound(nbytes(x, w_q, scale, y), 2 * M * N * K,
                                   "bf16")
        log(f"  int8 {name}: max|err| {err:.3e} (tol {tol:.3e}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none "
            f"(no PyTorch call multiplies bf16 by int8 weights), bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        if not err <= tol or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"int8 {name}: parity miss")
        return {"case": name, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by}

    results["int8_matmul"] = [
        case("lm_head_decode_bf16[4,2048]x[2048,151936]", 4, 2048, 151936,
             20),
        case("qkv_prefill_bf16[12288,2048]x[2048,4096]", 12288, 2048, 4096,
             5),
        case("down_decode_bf16[4,6144]x[6144,2048]", 4, 6144, 2048, 50),
        # the QLoRA train step's base products
        case("qlora_gate_bf16[4096,2048]x[2048,6144]", 4096, 2048, 6144, 5),
        case("qlora_down_bf16[4096,6144]x[6144,2048]", 4096, 6144, 2048, 5),
    ]


# ---------------------------------------------------------------------------
# small reference and main path
# ---------------------------------------------------------------------------


def small_config():
    """A small fp32 fusion model with head dims the kernels take."""
    from molly_tpu_torch.models import FusionConfig, tiny_esm, tiny_qwen3
    return FusionConfig(
        text=tiny_qwen3(vocab_size=384, hidden_size=256,
                        intermediate_size=512, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=64),
        dna_rna=tiny_esm(vocab_size=4107, hidden_size=128,
                         intermediate_size=256, num_attention_heads=2,
                         mask_token_id=2, mlp_type="swiglu", mlp_bias=False),
        protein=tiny_esm(vocab_size=33, hidden_size=128,
                         intermediate_size=256, num_attention_heads=2),
        dna_rna_k_tokens=16, protein_k_tokens=16)


def small_reference(seed: int):
    """The small model on the card (through the kernels) against the same
    weights on the CPU (plain versions): logits and greedy tokens."""
    import torch

    from molly_tpu_torch.inference.engine import generate
    from molly_tpu_torch.models import GenerationConfig, fusion, qwen3
    from molly_tpu_torch.utils.tree import tree_to

    cfg = small_config()
    cpu = fusion.init_params(cfg, torch.Generator().manual_seed(seed))
    gpu = tree_to(cpu, "cuda")
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


def small_reference_training(seed: int):
    """The small model's train step on the card (through the kernels)
    against the same step on the CPU (plain versions): loss and every
    trainable gradient for a full fine-tune step and a LoRA step; then five
    steps on one repeated batch at lr 1e-3 must lower the loss."""
    import torch

    from molly_tpu_torch.models import fusion
    from molly_tpu_torch.models.lora import LoraConfig
    from molly_tpu_torch.training.trainer import (TrainConfig, attach_lora,
                                                  init_train_state,
                                                  make_grad_fn,
                                                  make_train_step)
    from molly_tpu_torch.utils.tree import tree_to

    cfg = small_config()
    g = torch.Generator().manual_seed(seed + 2)
    B, S = 4, 96
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[1, 80:] = 0   # training batches are right-padded
    mask[3, 50:] = 0
    ids = torch.randint(0, 384, (B, S), generator=g)
    labels = torch.where(mask.bool(), ids, -100)
    labels[:, :30] = -100
    batch = {
        "input_ids": ids, "labels": labels, "attention_mask": mask,
        "dna_rna_tokens": torch.randint(6, 4102, (B, 2, 16), generator=g),
        "dna_rna_pos": torch.tensor([[2, 40], [30, -1], [-1, -1], [5, -1]]),
        "protein_tokens": torch.randint(4, 24, (B, 1, 16), generator=g),
        "protein_pos": torch.tensor([[60], [-1], [75], [25]]),
        "task_label": torch.tensor([0, 3, 100, 7]),
    }
    gpu_batch = {k: t.cuda() for k, t in batch.items()}
    regimes = {
        "full fine-tune": TrainConfig(learning_rate=1e-3, total_steps=5,
                                      warmup_ratio=0.0, schedule="constant"),
        "LoRA": TrainConfig(learning_rate=1e-3, total_steps=5,
                            warmup_ratio=0.0, schedule="constant",
                            lora=LoraConfig(r=8, alpha=16.0, dropout=0.0)),
    }
    for name, tc in regimes.items():
        cpu = fusion.init_params(cfg, torch.Generator().manual_seed(seed))
        if tc.lora is not None:
            cpu = attach_lora(cpu, cfg, tc.lora,
                              torch.Generator().manual_seed(seed + 1))
            for ab in cpu["lora"]["layers"].values():  # B starts at zero:
                ab["b"].normal_(0.0, 0.02, generator=g)  # give A a gradient
        gpu = tree_to(cpu, "cuda")
        init_train_state(cpu, tc)
        state = init_train_state(gpu, tc)
        grad_fn = make_grad_fn(cfg, tc)
        gc, mc = grad_fn(cpu, batch)
        gg, mg = grad_fn(gpu, gpu_batch)
        dloss = abs(float(mc["loss"]) - float(mg["loss"]))
        worst = 0.0
        for a, b in zip(gc, gg):
            ref = a.abs().max().item()
            rel = (a - b.cpu()).abs().max().item() / max(ref, 1e-12)
            worst = max(worst, rel)
        log(f"  small training reference, {name}: |dloss| {dloss:.3e} (tol "
            f"{TRAIN_LOSS_ATOL}), worst gradient error {worst:.3e} of its "
            f"max (tol {TRAIN_GRAD_REL}) over {len(gc)} leaves")
        if not (dloss <= TRAIN_LOSS_ATOL and worst <= TRAIN_GRAD_REL):
            raise AssertionError(f"small training reference, {name}: the "
                                 f"card disagrees with the CPU")
        if tc.lora is None:
            step = make_train_step(cfg, tc)
            losses = []
            for _ in range(5):
                state, m = step(state, gpu_batch, None)
                losses.append(float(m["loss"]))
            log(f"  small training reference: five steps on one batch, loss "
                f"{' -> '.join(f'{x:.4f}' for x in losses)}")
            if not losses[-1] < losses[0]:
                raise AssertionError("small training reference: the loss "
                                     "did not fall")


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


def train_main_path(params, cfg, samples, tc, label, seed, needed,
                    profile_dir=None):
    """Drive ``train_loop`` for 3 steps on the four samples; returns (the
    launch counts of the run, the trained state)."""
    import torch

    from molly_tpu_torch.training.cli import train_loop
    from molly_tpu_torch.training.trainer import init_train_state

    state = init_train_state(params, tc)
    probe = params["protein_projector"]["bias"]
    before = probe.detach().clone()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = {}
    result = train_loop(state, cfg, tc, samples, batch_size=4, epochs=3,
                        total_steps=3, seed=seed, device="cuda",
                        output_dir=None, profile_log_dir=profile_dir,
                        stats=stats)
    counts = read_counts()
    hist = result["history"]
    for h in hist:
        ph = h["phases"]
        log(f"  {label}: step {h['step']}: loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.4f}, {h['seconds']:.3f} s (device: forward "
            f"{ph['forward_s']:.3f}, backward {ph['backward_s']:.3f}, "
            f"optimizer {ph['optimizer_s']:.3f}), skipped {h['skipped']}")
    rows = len(samples) * samples[0]["input_ids"].shape[0]
    # step 1 warms up (Triton compiles, allocator); a traced step 3 carries
    # the profiler's overhead
    steady = hist[1:2] if profile_dir else hist[1:]
    log(f"  {label}: {rows * len(steady) / sum(h['seconds'] for h in steady):.0f}"
        f" tokens/s over step{' 2' if profile_dir else 's 2-3'} ({rows} "
        f"token positions a step, {hist[-1]['tokens']} supervised), peak "
        f"device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{counts}")
    import math
    if len(hist) != 3 or any(
            not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 and h["grad_norm"] > 0) or h["skipped"] for h in hist):
        raise AssertionError(f"{label}: a step was skipped or not finite")
    if torch.equal(before, probe.detach()):
        raise AssertionError(f"{label}: the projector did not change")
    for name in needed:
        if counts[name] <= 0:
            raise AssertionError(f"{label} never launched {name}")
    return counts, result["state"]


def drive_main_paths(seed: int, profile_dir=None):
    """Phases 6-10: generation (bf16, int8) and training (full fine-tune,
    QLoRA) at molly-1.7B width; returns each kernel's launches summed over
    the four runs."""
    import dataclasses
    import tempfile

    import torch

    from molly_tpu_torch.data import (DataConfig, OmicsSampleEncoder,
                                      default_modality_tokenizers,
                                      load_text_tokenizer)
    from molly_tpu_torch.models import (ESM_PRESETS, QWEN3_PRESETS,
                                        FusionConfig, GenerationConfig,
                                        fusion, qwen3)
    from molly_tpu_torch.models.lora import LoraConfig, merge_lora
    from molly_tpu_torch.training import checkpoint as ckpt
    from molly_tpu_torch.training.trainer import TrainConfig, attach_lora
    from molly_tpu_torch.utils.tree import leaves

    text_tok = load_text_tokenizer(None)
    dna_tok, prot_tok = default_modality_tokenizers()
    enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=3072, dna_rna_k_tokens=1024, protein_k_tokens=1024,
        max_dna_rna_segments=4, max_protein_segments=4))
    requests = make_requests(seed)
    samples = [enc.encode_test(r) for r in requests]
    cfg = FusionConfig(text=QWEN3_PRESETS["qwen3-1.7b"],
                       dna_rna=ESM_PRESETS["nt-500m"],
                       protein=ESM_PRESETS["esm2-650m"],
                       dna_rna_k_tokens=1024, protein_k_tokens=1024)
    # the train CLI's defaults: max length 1024, k = 128, 4 slots
    train_enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=1024, dna_rna_k_tokens=128, protein_k_tokens=128,
        max_dna_rna_segments=4, max_protein_segments=4))
    train_samples = [train_enc.encode_train(r) for r in requests]
    train_cfg = dataclasses.replace(cfg, dna_rna_k_tokens=128,
                                    protein_k_tokens=128)
    with Phase("init molly-1.7B-width params"):
        params = fusion.init_params(
            cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    n_params = sum(t.numel() for t in leaves(params))
    log(f"  {n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    common = dict(temperature=0.8, top_p=0.95, top_k=20,
                  repetition_penalty=1.1, eos_token_id=text_tok.eos_token_id,
                  pad_token_id=text_tok.pad_token_id)
    launches = {name: 0 for name in REPLACES}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    def run_path(label, run_params, run_cfg, run_samples, gen, needed):
        with Phase(f"main path {label}, {gen.max_new_tokens} new tokens"):
            counts = main_path(run_params, run_cfg, run_samples, text_tok,
                               gen, seed, label)
        for name in needed:
            if counts[name] <= 0:
                raise AssertionError(f"{label} main path never launched "
                                     f"{name}")
        add(counts)

    run_path("generation, bf16 sampled", params, cfg, samples,
             GenerationConfig(max_new_tokens=32, do_sample=True, **common),
             ("flash_attention_fwd", "rmsnorm_fwd"))

    with Phase("main path training, full fine-tune, 3 steps"):
        counts, state = train_main_path(
            params, train_cfg, train_samples, TrainConfig(total_steps=3),
            "full fine-tune", seed, TRAIN_KERNELS, profile_dir)
        add(counts)
    del state
    torch.cuda.empty_cache()

    lora_cfg = LoraConfig(r=64, alpha=64.0, dropout=0.05)
    with Phase("main path training, QLoRA, 3 steps"):
        qparams = attach_lora(params, train_cfg, lora_cfg,
                              torch.Generator("cuda").manual_seed(seed + 1))
        with torch.no_grad():
            qparams["text"] = qwen3.quantize_for_training(
                qparams["text"], train_cfg.text)
        counts, state = train_main_path(
            qparams, train_cfg, train_samples,
            TrainConfig(total_steps=3, lora=lora_cfg), "QLoRA", seed,
            TRAIN_KERNELS + ("int8_matmul",))
        add(counts)
    with Phase("QLoRA: export_adapter, load_adapter, merge_lora, 8 greedy "
               "tokens"):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "adapter.npz")
            ckpt.export_adapter(path, state.params, lora_cfg=lora_cfg)
            meta = ckpt.adapter_meta(path)
            fresh = ckpt.load_adapter(path, dict(params))
        assert meta == {"r": 64, "alpha": 64.0}, meta
        lora = fresh.pop("lora")
        with torch.no_grad():
            fresh["text"] = merge_lora(
                fresh["text"], lora, LoraConfig(r=meta["r"],
                                                alpha=meta["alpha"]))
        del lora, state, qparams
        torch.cuda.empty_cache()
        main_path(fresh, train_cfg,
                  [train_enc.encode_test(r) for r in requests], text_tok,
                  GenerationConfig(max_new_tokens=8, do_sample=False,
                                   **common), seed, "merged adapter, greedy")
        del fresh
        torch.cuda.empty_cache()

    with Phase("quantize_for_decode"), torch.no_grad():
        params["text"] = qwen3.quantize_for_decode(params["text"], cfg.text)
    run_path("generation, int8 greedy", params, cfg, samples,
             GenerationConfig(max_new_tokens=16, do_sample=False, **common),
             ("flash_attention_fwd", "rmsnorm_fwd", "int8_matmul"))
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
    with Phase("parity flash_attention_dq, flash_attention_dkv"):
        parity_flash_bwd(g, parity)
    with Phase("parity rmsnorm_fwd, rmsnorm_bwd"):
        parity_rmsnorm(g, parity)
    with Phase("parity int8_matmul"):
        parity_int8(g, parity)
    with Phase("small reference, generation"):
        small_reference(args.seed)
    with Phase("small reference, training"):
        small_reference_training(args.seed)

    launches = drive_main_paths(args.seed, args.profile_dir)

    kernels = []
    for name in REPLACES:
        cases = parity[name]
        route, source = SOURCES[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
            "bound_ms": cases[0]["bound_ms"],
            "bound_by": cases[0]["bound_by"],
            "library_ms": cases[0]["library_ms"], "cases": cases})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the third full "
                         "fine-tune step here (trace.json, "
                         "key_averages.txt, summary.json)")
    return run(ap.parse_args())


if __name__ == "__main__":
    sys.exit(main())
