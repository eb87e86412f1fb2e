"""ESM-family bidirectional encoder (ESM-2 protein + nucleotide-transformer
DNA/RNA) in PyTorch, the counterpart of ``molly_tpu/models/esm.py``.

Details kept for logit parity with HF ``modeling_esm.py``: the token-dropout
embedding rescale, embeddings multiplied by the attention mask, pre-LN
blocks with Q scaled by head_dim^-0.5 BEFORE rotary (attention then runs at
scale 1.0), rotary theta 1e4 or RoBERTa-style absolute positions, exact-erf
GELU or the bias-free SwiGLU of NT-v2, and the final LayerNorm. Params keep
the JAX layout: stacked [L, ...] weights, [in, out] linears.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops import quant
from ..ops.attention import dot_product_attention
from ..ops.norms import layer_norm
from ..ops.rope import apply_rope, rope_cos_sin
from .configs import EsmConfig
from .qwen3 import _unstack_layers, torch_dtype

Params = Dict[str, Any]

MASK_RATIO_TRAIN = 0.15 * 0.8  # hardcoded in ESM (modeling_esm.py:217)


def init_params(cfg: EsmConfig, generator: torch.Generator,
                device="cpu") -> Params:
    dt = torch_dtype(cfg.dtype)
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers

    def lin(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(0.02).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ln(*shape):
        return {"weight": torch.ones(shape, dtype=dt, device=device),
                "bias": zeros(*shape)}

    layers = {
        "attn_ln": ln(L, H),
        "q": lin(L, H, H), "q_b": zeros(L, H),
        "k": lin(L, H, H), "k_b": zeros(L, H),
        "v": lin(L, H, H), "v_b": zeros(L, H),
        "attn_out": lin(L, H, H), "attn_out_b": zeros(L, H),
        "ffn_ln": ln(L, H),
        "ffn_in": lin(L, H, I), "ffn_in_b": zeros(L, I),
        "ffn_out": lin(L, I, H), "ffn_out_b": zeros(L, H),
    }
    if cfg.mlp_type == "swiglu":
        layers["ffn_gate"] = lin(L, H, I)
    params: Params = {"embed": lin(cfg.vocab_size, H), "layers": layers,
                      "final_ln": ln(H)}
    if cfg.emb_layer_norm_before:
        params["emb_ln"] = ln(H)
    if cfg.position_embedding_type == "absolute":
        params["pos_embed"] = lin(cfg.max_position_embeddings, H)
    return params


def _layer_norm(x, p, eps):
    return layer_norm(x, p["weight"], p["bias"], eps)


def _layer(cfg: EsmConfig, hidden, p, cos, sin, mask):
    B, S, H = hidden.shape
    N, Dh = cfg.num_attention_heads, cfg.head_dim

    x = _layer_norm(hidden, p["attn_ln"], cfg.layer_norm_eps)
    q = (quant.linear(x, p["q"]) + p["q_b"]).reshape(B, S, N, Dh)
    k = (quant.linear(x, p["k"]) + p["k_b"]).reshape(B, S, N, Dh)
    v = (quant.linear(x, p["v"]) + p["v_b"]).reshape(B, S, N, Dh)
    # ESM scales Q before rotary, so attention itself runs at scale 1
    q = q * (Dh ** -0.5)
    if cfg.position_embedding_type == "rotary":
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    attn = dot_product_attention(q, k, v, mask=mask, causal=False, scale=1.0)
    attn = quant.linear(attn.reshape(B, S, H), p["attn_out"]) + p["attn_out_b"]
    hidden = hidden + attn

    x = _layer_norm(hidden, p["ffn_ln"], cfg.layer_norm_eps)
    if cfg.mlp_type == "swiglu":
        x = F.silu(quant.linear(x, p["ffn_gate"])) * quant.linear(
            x, p["ffn_in"])
    else:
        x = F.gelu(quant.linear(x, p["ffn_in"]) + p["ffn_in_b"])  # exact erf
    x = quant.linear(x, p["ffn_out"])
    if cfg.mlp_bias:
        x = x + p["ffn_out_b"]
    return hidden + x


def forward_hidden(params: Params, cfg: EsmConfig, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None,
                   output_hidden_states: bool = False) -> torch.Tensor:
    """input_ids [B, S] -> final hidden states [B, S, H] (after the final
    LayerNorm): what the fusion model projects. With
    ``output_hidden_states``, returns (final, each layer's output
    [L, B, S, H])."""
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    dt = torch_dtype(cfg.dtype)
    table = params["embed"]
    emb = table[input_ids.clamp(0, table.shape[0] - 1)]

    if cfg.token_dropout:
        is_mask = input_ids == cfg.mask_token_id
        emb = emb.masked_fill(is_mask[..., None], 0.0)
        src_len = attention_mask.sum(dim=-1).to(torch.float32)
        observed = is_mask.sum(dim=-1).to(torch.float32) / src_len
        scale = (1.0 - MASK_RATIO_TRAIN) / (1.0 - observed)
        emb = (emb * scale[:, None, None]).to(dt)

    if cfg.position_embedding_type == "absolute":
        # RoBERTa-style pad-offset ids (modeling_esm.py create_position_ids)
        m = attention_mask.to(torch.int32)
        pos_ids = torch.cumsum(m, dim=1) * m + cfg.pad_token_id
        pos_table = params["pos_embed"]
        emb = emb + pos_table[pos_ids.clamp(0, pos_table.shape[0] - 1)]

    if cfg.emb_layer_norm_before:
        emb = _layer_norm(emb, params["emb_ln"], cfg.layer_norm_eps)
    emb = (emb * attention_mask[..., None]).to(dt)

    S = input_ids.shape[1]
    cos, sin = rope_cos_sin(torch.arange(S, device=input_ids.device),
                            cfg.head_dim, 10000.0, dtype=dt)
    hidden = emb
    per_layer = []
    for lp in _unstack_layers(params["layers"], cfg.num_hidden_layers):
        hidden = _layer(cfg, hidden, lp, cos, sin, attention_mask)
        if output_hidden_states:
            per_layer.append(hidden)
    hidden = _layer_norm(hidden, params["final_ln"], cfg.layer_norm_eps)
    if output_hidden_states:
        return hidden, torch.stack(per_layer)
    return hidden
