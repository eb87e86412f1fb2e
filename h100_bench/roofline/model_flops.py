"""The model FLOPs that a batch's inputs need, for the whole step's share
of the card's peak (``mfu``): matrix products and attention, 2 operations a
multiply-add. Only live segments count for the encoders, only real prompt
tokens for the prefill (the head only at each row's last position), and
only tokens a row emitted, its EOS included, for decode; the first emitted
token is the prefill's."""

from __future__ import annotations

from typing import Any, Dict


def encoder_token(enc: Dict[str, Any]) -> int:
    """Matrix-product operations of one encoder token through all layers."""
    H, I = enc["hidden_size"], enc["intermediate_size"]
    mats = 3 if enc["mlp_type"] == "swiglu" else 2
    return 2 * enc["num_hidden_layers"] * (4 * H * H + mats * H * I)


def decoder_token(text: Dict[str, Any]) -> int:
    """Matrix-product operations of one decoder token through all layers,
    the head excluded (an MoE token: the router and its k experts)."""
    H, D = text["hidden_size"], text["head_dim"]
    Dq, Dkv = text["num_attention_heads"] * D, text["num_key_value_heads"] * D
    proj = H * Dq + 2 * H * Dkv + Dq * H
    if text.get("num_experts"):
        ffn = (H * text["num_experts"]
               + text["num_experts_per_tok"] * 3 * H
               * text["moe_intermediate_size"])
    else:
        ffn = 3 * H * text["intermediate_size"]
    return 2 * text["num_hidden_layers"] * (proj + ffn)


def generate(shape: Dict[str, Any], config: Dict[str, Any]) -> float:
    """Model FLOPs of one generate batch (``roofline.shapes.batch_shape``)."""
    text = config["text"]
    H, V, L = text["hidden_size"], text["vocab_size"], \
        text["num_hidden_layers"]
    Dq = text["num_attention_heads"] * text["head_dim"]
    head = 2 * H * V
    total = 0
    for r in shape["rows"]:
        for modality, n in r["segments"]:
            enc = config[modality]
            He = enc["hidden_size"]
            total += n * encoder_token(enc) \
                + 4 * n * n * He * enc["num_hidden_layers"] \
                + 2 * n * He * H
        n = r["n"]
        total += n * decoder_token(text) + 4 * Dq * L * n * (n + 1) // 2 \
            + head
        for j in range(max(r["emitted"] - 1, 0)):
            total += decoder_token(text) + 4 * Dq * L * (n + j + 1) + head
    return float(total)
