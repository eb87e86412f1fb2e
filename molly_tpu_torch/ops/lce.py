"""Fused (chunked) linear + cross-entropy, the counterpart of
``molly_tpu/ops/lce.py``.

One chunked op returns PER-TOKEN nll without materializing the [T, V]
logits, so the domain losses are a cheap segment sum downstream. Tokens go
through in chunks (a Python loop where JAX scans): each chunk computes its
[C, V] logits in fp32, reduces them to lse and the target logit, and drops
them. The autograd function recomputes the chunk logits in the backward
pass (one extra matmul per chunk instead of O(T * V) saved memory).

The matrix products are ``torch.matmul`` (the JAX package leaves them to
XLA). ``_mm`` keeps what ``jnp.dot(..., preferred_element_type=float32)``
gives there: operands in their storage dtype, an fp32 result. On a CUDA
device bf16 operands go through ``torch.mm(..., out_dtype=torch.float32)``
where this PyTorch has it (full tensor-core rate, no rounding of the
logits); otherwise, and on the CPU, both operands are upcast to fp32 first
— the same numbers, at the fp32 rate of the device and with an fp32 copy
of the weight alive for the length of the call (1.2 GB for [2048, 151936]).
The logits are never rounded to bf16.
"""

from __future__ import annotations

from typing import Tuple

import torch

IGNORE_INDEX = -100
DEFAULT_CHUNK = 256

_HAS_MM_OUT_DTYPE = "out_dtype" in (torch.mm.__doc__ or "")


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result, whatever the (shared) operand dtype."""
    if a.dtype == torch.float32:
        return a @ b
    if _HAS_MM_OUT_DTYPE and a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(T: int, chunk_size: int):
    C = max(1, min(chunk_size, T))
    return [(s, min(s + C, T)) for s in range(0, T, C)]


def _chunk_stats(h_c, w, l_c, ignore_index):
    logits = _mm(h_c, w)                                   # [C, V] fp32
    lse = torch.logsumexp(logits, dim=-1)
    valid = (l_c != ignore_index).to(torch.float32)
    safe = torch.where(l_c == ignore_index, 0, l_c).to(torch.long)
    return logits, lse, valid, safe


class _FusedLCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, w, labels, chunk_size, z_loss, ignore_index,
                need_dw):
        ctx.save_for_backward(hidden, w, labels)
        ctx.args = (chunk_size, z_loss, ignore_index, need_dw)
        out = []
        for s, e in _chunks(hidden.shape[0], chunk_size):
            logits, lse, valid, safe = _chunk_stats(
                hidden[s:e], w, labels[s:e], ignore_index)
            tgt = torch.gather(logits, 1, safe[:, None])[:, 0]
            nll = (lse - tgt) * valid
            if z_loss:
                nll = nll + z_loss * torch.square(lse) * valid
            out.append(nll)
        return torch.cat(out) if out else hidden.new_zeros(
            (0,), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        hidden, w, labels = ctx.saved_tensors
        chunk_size, z_loss, ignore_index, need_dw = ctx.args
        need_dw = need_dw and ctx.needs_input_grad[1]
        g = g.to(torch.float32)
        dh = torch.empty_like(hidden)
        dw = (torch.zeros(w.shape, dtype=torch.float32, device=w.device)
              if need_dw else None)
        wt = w.T
        for s, e in _chunks(hidden.shape[0], chunk_size):
            h_c = hidden[s:e]
            logits, lse, valid, safe = _chunk_stats(h_c, w, labels[s:e],
                                                    ignore_index)
            p = torch.exp(logits - lse[:, None])
            coeff = g[s:e] * valid
            dl = p * coeff[:, None]
            dl[torch.arange(e - s, device=dl.device), safe] -= coeff
            if z_loss:
                dl = dl + (2.0 * z_loss * lse * coeff)[:, None] * p
            # grad matmuls in the weight's storage dtype, fp32 accumulation
            dl = dl.to(w.dtype)
            dh[s:e] = _mm(dl, wt).to(hidden.dtype)
            if need_dw:
                dw += _mm(h_c.T, dl)
        return (dh, None if dw is None else dw.to(w.dtype), None, None,
                None, None, None)


def fused_linear_cross_entropy(hidden: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor,
                               chunk_size: int = DEFAULT_CHUNK,
                               z_loss: float = 0.0,
                               ignore_index: int = IGNORE_INDEX,
                               need_dw: bool = True) -> torch.Tensor:
    """hidden [T, H], w [H, V] (``embed.T`` for a tied head: a transposed
    view, whose gradient autograd carries back to ``embed``), labels [T]
    -> per-token nll [T] fp32 (0 at ignored positions).

    need_dw=False: the head is FROZEN (LoRA / QLoRA / --train-llm false):
    the backward skips the h^T @ dlogits product of every chunk."""
    return _FusedLCE.apply(hidden, w, labels, chunk_size, z_loss,
                           ignore_index, need_dw)


def causal_lm_loss(hidden: torch.Tensor, w: torch.Tensor,
                   labels: torch.Tensor, *, chunk_size: int = DEFAULT_CHUNK,
                   z_loss: float = 0.0, pre_shifted: bool = False,
                   need_dw: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Next-token LM loss without logit materialization: (mean_loss,
    per_sample_nll_sum [B], per_sample_token_count [B]).

    pre_shifted=True: labels[t] is already the next-token target of
    position t; no shift is applied here."""
    B, S, H = hidden.shape
    if pre_shifted:
        h, l = hidden.reshape(-1, H), labels.reshape(-1)
    else:
        h, l = hidden[:, :-1].reshape(-1, H), labels[:, 1:].reshape(-1)
    nll = fused_linear_cross_entropy(h, w, l, chunk_size, z_loss,
                                     IGNORE_INDEX, need_dw).reshape(B, -1)
    valid = (labels != IGNORE_INDEX) if pre_shifted else (
        labels[:, 1:] != IGNORE_INDEX)
    per_sample_tokens = valid.sum(dim=-1)
    per_sample_nll = nll.sum(dim=-1)
    total = torch.clamp(per_sample_tokens.sum(), min=1)
    return per_sample_nll.sum() / total, per_sample_nll, per_sample_tokens
