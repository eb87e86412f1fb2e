"""Attention dispatch, the counterpart of ``molly_tpu/ops/attention.py``.

The JAX package's rule picks the flash kernel when Sq > 1, ``q_offset`` is
a static int and the mask is 2-D or absent; everything else (decode steps,
a per-row ``q_offset``, 4-D masks) is the plain grouped-query einsum. The
port keeps that rule on every device: the flash wrapper launches the CUDA
kernel for a CUDA tensor and runs its plain version for a CPU tensor.
Decode (Sq == 1) is plain PyTorch here exactly as it is plain XLA there.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

from ..utils import profiling
from .flash_attention import flash_attention


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Nkv, Dh] -> [B, S, Nkv*n_rep, Dh] (GQA head expansion)."""
    if n_rep == 1:
        return x
    b, s, nkv, dh = x.shape
    return x[:, :, :, None, :].expand(b, s, nkv, n_rep, dh).reshape(
        b, s, nkv * n_rep, dh)


def dot_product_attention(
    q: torch.Tensor,  # [B, Sq, Nq, Dh]
    k: torch.Tensor,  # [B, Skv, Nkv, Dh] ("bsnd") or [B, Nkv, Skv, Dh]
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,  # [B, Skv] 1=keep, or bool [B,1,Sq,Skv]
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: Union[int, torch.Tensor] = 0,  # absolute position of q[0]
    kv_layout: str = "bsnd",  # or "bnsd" (head-major KV cache)
    kv_scales: Optional[torch.Tensor] = None,  # int8 KV cache: [B,Nkv,Skv,2]
    #   per-column symmetric scales (k half, v half); the k scale multiplies
    #   the logit column, the v scale folds into the softmax weights
) -> torch.Tensor:
    """Scaled dot-product attention with GQA, padding mask, causal mask;
    softmax in fp32 whatever the input dtype. Reads of an int8 cache
    (``kv_scales``) take the plain path, as they are XLA-only there."""
    if (q.shape[1] > 1 and isinstance(q_offset, int) and kv_scales is None
            and (mask is None or mask.ndim == 2)):
        if kv_layout == "bnsd":
            # views, not copies: the kernel reads the cache through strides
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        return flash_attention(q, k, v, mask, causal, scale, q_offset)
    return plain_attention(q, k, v, mask=mask, causal=causal, scale=scale,
                           q_offset=q_offset, kv_layout=kv_layout,
                           kv_scales=kv_scales)


def plain_attention(q, k, v, *, mask, causal, scale, q_offset=0,
                    kv_layout="bsnd", kv_scales=None):
    """Port of ``molly_tpu.ops.attention._xla_attention``: grouped-query
    einsum that never repeats K/V, logits and the P.V product accumulated in
    fp32 as ``preferred_element_type`` does there. With ``kv_scales`` k and v
    are the int8 cache halves, converted to q's dtype for the products."""
    b, sq, nq, dh = q.shape
    if kv_layout == "bsnd":
        skv, nkv = k.shape[1], k.shape[2]
        k_sub = "bknd"
    else:
        nkv, skv = k.shape[1], k.shape[2]
        k_sub = "bnkd"
    if scale is None:
        scale = dh ** -0.5
    n_rep = nq // nkv
    qg = q.reshape(b, sq, nkv, n_rep, dh)
    if kv_scales is not None:  # int8 KV cache (bnsd decode path only)
        assert kv_layout == "bnsd", kv_layout
        k, v = k.to(q.dtype), v.to(q.dtype)

    with profiling.span("molly/attn/logits"):
        # [B, Nkv, G, Sq, Skv]
        logits = torch.einsum(f"bqngd,{k_sub}->bngqk", qg.float(),
                              k.float())
        logits = logits * scale
        if kv_scales is not None:
            # per-column k scale multiplies its logit column
            logits = logits * kv_scales[..., 0][:, :, None, None, :]
    neg = torch.finfo(torch.float32).min
    with profiling.span("molly/attn/mask"):
        if mask is not None:
            if mask.ndim == 2:  # [B, Skv] padding mask
                keep = (mask != 0)[:, None, None, None, :]
            else:  # bool [B, 1, Sq, Skv]
                keep = mask[:, :, None]
            logits = logits + torch.where(keep, 0.0, neg)
        if causal:
            # a host int copied to the device waits for the device's backlog
            with (contextlib.nullcontext() if torch.is_tensor(q_offset)
                  else profiling.sync("q_offset")):
                q_off = torch.as_tensor(q_offset,
                                        device=q.device).reshape(-1)
            q_pos = (torch.arange(sq, device=q.device)[None, :]
                     + q_off[:, None])
            kv_pos = torch.arange(skv, device=q.device)
            causal_mask = q_pos[..., None] >= kv_pos  # [B|1, sq, skv]
            logits = torch.where(causal_mask[:, None, None], logits, neg)

    with profiling.span("molly/attn/pv"):
        probs = torch.softmax(logits, dim=-1)
        if kv_scales is not None:
            # per-column v scale folds into the softmax weights
            probs = probs * kv_scales[..., 1][:, :, None, None, :]
        out = torch.einsum(f"bngqk,{k_sub}->bqngd",
                           probs.to(v.dtype).float(), v.float())
        return out.reshape(b, sq, nq, dh).to(q.dtype)
