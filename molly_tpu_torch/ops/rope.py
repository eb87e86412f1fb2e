"""Rotary position embeddings (GPT-NeoX half-split convention), the
counterpart of ``molly_tpu/ops/rope.py``. Qwen3 uses theta 1e6, ESM 1e4."""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32):
    """cos/sin tables [..., head_dim] for int positions [...], computed in
    float32 and then cast to ``dtype`` (HF runs the table in fp32)."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [B, S, N, Dh]; cos/sin: [B, S, Dh] or [S, Dh] (broadcast over
    heads)."""
    if cos.ndim < x.ndim:  # insert the head axis before Dh
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    return x * cos + rotate_half(x) * sin
