"""Logit processing + sampling, the counterpart of
``molly_tpu/inference/sampling.py``: HF's processor order (repetition
penalty -> temperature -> top-k -> top-p within the k candidates) and one
categorical draw from an explicit ``torch.Generator``. The draw gives other
numbers than ``jax.random`` from the same seed; what must match is the
filtered distribution (``filter_logits``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = torch.finfo(torch.float32).min


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: for seen tokens, positive logits
    are divided by the penalty, negative multiplied. presence: [B, V] bool."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering (HF convention: keep the smallest set with
    cumulative prob > p, always keeping the most probable token)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    threshold = torch.where(keep_sorted, sorted_logits,
                            torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, NEG_INF, logits)


def filter_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  repetition_penalty: float = 1.0,
                  presence: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The sampled path's processors. With top_k: (candidate logits [B, k]
    in descending order, masked to NEG_INF outside the nucleus, their vocab
    ids [B, k]); without: (filtered full-vocab logits, None)."""
    logits = logits.to(torch.float32)
    if presence is not None:
        logits = apply_repetition_penalty(logits, presence, repetition_penalty)
    if temperature != 1.0:
        logits = logits / temperature
    if top_k:
        # top-k once, then top-p within the (already sorted) k candidates
        vals, idx = torch.topk(logits, top_k, dim=-1)
        if top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = (cum - probs) < top_p  # always keeps the top candidate
            vals = torch.where(keep, vals, NEG_INF)
        return vals, idx
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    return logits, None


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    generator: Optional[torch.Generator],
    *,
    do_sample: bool = True,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    repetition_penalty: float = 1.0,
    presence: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Next token ids [B] (int64)."""
    if not do_sample:
        logits = logits.to(torch.float32)
        if presence is not None:
            logits = apply_repetition_penalty(logits, presence,
                                              repetition_penalty)
        return torch.argmax(logits, dim=-1)
    vals, idx = filter_logits(logits, temperature=temperature, top_k=top_k,
                              top_p=top_p,
                              repetition_penalty=repetition_penalty,
                              presence=presence)
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                               generator=generator)
    if idx is None:
        return choice[:, 0]
    return torch.gather(idx, 1, choice)[:, 0]
