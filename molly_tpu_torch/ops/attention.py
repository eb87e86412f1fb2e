"""Attention dispatch, the counterpart of ``molly_tpu/ops/attention.py``.

The JAX package's rule picks the flash kernel when Sq > 1, ``q_offset`` is
a static int and the mask is 2-D or absent; everything else (decode steps,
a per-row ``q_offset``, 4-D masks) is the plain grouped-query einsum. The
port keeps that rule on every device: the flash wrapper launches the CUDA
kernel for a CUDA tensor and runs its plain version for a CPU tensor.
Decode (Sq == 1) is plain PyTorch here exactly as it is plain XLA there.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .flash_attention import flash_attention


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
) -> torch.Tensor:
    """Scaled dot-product attention with GQA, padding mask, causal mask;
    softmax in fp32 whatever the input dtype."""
    if (q.shape[1] > 1 and isinstance(q_offset, int)
            and (mask is None or mask.ndim == 2)):
        if kv_layout == "bnsd":
            # views, not copies: the kernel reads the cache through strides
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        return flash_attention(q, k, v, mask, causal, scale, q_offset)
    return plain_attention(q, k, v, mask=mask, causal=causal, scale=scale,
                           q_offset=q_offset, kv_layout=kv_layout)


def plain_attention(q, k, v, *, mask, causal, scale, q_offset=0,
                    kv_layout="bsnd"):
    """Port of ``molly_tpu.ops.attention._xla_attention`` (without the int8
    KV-cache scales): grouped-query einsum that never repeats K/V, logits
    and the P.V product accumulated in fp32 as ``preferred_element_type``
    does there."""
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

    # [B, Nkv, G, Sq, Skv]
    logits = torch.einsum(f"bqngd,{k_sub}->bngqk", qg.float(), k.float())
    logits = logits * scale
    neg = torch.finfo(torch.float32).min
    if mask is not None:
        if mask.ndim == 2:  # [B, Skv] padding mask
            keep = (mask != 0)[:, None, None, None, :]
        else:  # bool [B, 1, Sq, Skv]
            keep = mask[:, :, None]
        logits = logits + torch.where(keep, 0.0, neg)
    if causal:
        q_off = torch.as_tensor(q_offset, device=q.device).reshape(-1)
        q_pos = torch.arange(sq, device=q.device)[None, :] + q_off[:, None]
        kv_pos = torch.arange(skv, device=q.device)
        causal_mask = q_pos[..., None] >= kv_pos  # [B|1, sq, skv]
        logits = torch.where(causal_mask[:, None, None], logits, neg)

    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum(f"bngqk,{k_sub}->bqngd",
                       probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, nq, dh).to(q.dtype)
