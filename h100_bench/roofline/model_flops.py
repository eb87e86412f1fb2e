"""The model FLOPs that a batch's inputs need, for the whole step's share
of the card's peak (``mfu``): matrix products and attention, 2 operations a
multiply-add. Only live segments count for the encoders, only real prompt
tokens for the prefill (the head only at each row's last position), and
only tokens a row emitted, its EOS included, for decode; the first emitted
token is the prefill's. The decoder's layers count as its
``reference/<decoder>.py`` says."""

from __future__ import annotations

from typing import Any, Dict


def encoder_token(enc: Dict[str, Any]) -> int:
    """Matrix-product operations of one encoder token through all layers."""
    H, I = enc["hidden_size"], enc["intermediate_size"]
    mats = 3 if enc["mlp_type"] == "swiglu" else 2
    return 2 * enc["num_hidden_layers"] * (4 * H * H + mats * H * I)


def generate(shape: Dict[str, Any], config: Dict[str, Any], decoder
             ) -> float:
    """Model FLOPs of one generate batch (``roofline.shapes.batch_shape``);
    the decoder's own from ``decoder`` (the configuration's
    ``reference/<decoder>.py``: ``token_flops``, ``attention_flops``)."""
    text = config["text"]
    H, V = text["hidden_size"], text["vocab_size"]
    head = 2 * H * V
    token = decoder.token_flops(text)
    total = 0
    for r in shape["rows"]:
        for modality, n in r["segments"]:
            enc = config[modality]
            He = enc["hidden_size"]
            total += n * encoder_token(enc) \
                + 4 * n * n * He * enc["num_hidden_layers"] \
                + 2 * n * He * H
        n = r["n"]
        total += n * token + decoder.attention_flops(text, 0, n) + head
        for j in range(max(r["emitted"] - 1, 0)):
            total += token + decoder.attention_flops(text, n + j, n + j + 1) \
                + head
    return float(total)
