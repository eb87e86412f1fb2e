"""The model's weights, drawn from the seed on the run's device in the
dtype they are served in, one call a leaf, in the program's tree layout
(stacked [L, ...] layer weights, [in, out] linears). The benchmark makes
them, so that the program and the plain reference are handed the same
weights and neither takes them from the other.

normal(0, 0.02) for every matrix and embedding, ones for norm weights,
zeros for biases, U(-1/sqrt(in), 1/sqrt(in)) for the projectors. The text
decoder's tree is its ``reference/<decoder>.py``'s ``draw``, first from
the same generator."""

from __future__ import annotations

from typing import Any, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _Draw:
    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.device, self.dtype = device, dtype

    def normal(self, *shape) -> torch.Tensor:
        w = torch.randn(shape, generator=self.g, device=self.device,
                        dtype=self.dtype)
        return w.mul_(0.02)

    def uniform(self, d_in: int, d_out: int) -> torch.Tensor:
        bound = d_in ** -0.5
        w = torch.rand((d_in, d_out), generator=self.g, device=self.device,
                       dtype=self.dtype)
        return w.mul_(2 * bound).sub_(bound)

    def ones(self, *shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)


def _encoder(d: _Draw, enc: Dict[str, Any]) -> Dict[str, Any]:
    H, I, L = (enc["hidden_size"], enc["intermediate_size"],
               enc["num_hidden_layers"])

    def ln(*shape):
        return {"weight": d.ones(*shape), "bias": d.zeros(*shape)}

    layers = {"attn_ln": ln(L, H),
              "q": d.normal(L, H, H), "q_b": d.zeros(L, H),
              "k": d.normal(L, H, H), "k_b": d.zeros(L, H),
              "v": d.normal(L, H, H), "v_b": d.zeros(L, H),
              "attn_out": d.normal(L, H, H), "attn_out_b": d.zeros(L, H),
              "ffn_ln": ln(L, H),
              "ffn_in": d.normal(L, H, I), "ffn_in_b": d.zeros(L, I),
              "ffn_out": d.normal(L, I, H), "ffn_out_b": d.zeros(L, H)}
    if enc["mlp_type"] == "swiglu":
        layers["ffn_gate"] = d.normal(L, H, I)
    out = {"embed": d.normal(enc["vocab_size"], H), "layers": layers,
           "final_ln": ln(H)}
    if enc.get("emb_layer_norm_before"):
        out["emb_ln"] = ln(H)
    if enc.get("position_embedding_type") == "absolute":
        out["pos_embed"] = d.normal(enc["max_position_embeddings"], H)
    return out


def make(config: Dict[str, Any], seed: int, device, decoder
         ) -> Dict[str, Any]:
    """The fusion model's weights for a configuration file's contents;
    ``decoder`` is the configuration's ``reference/<decoder>.py``."""
    d = _Draw(seed, device, DTYPES[config["dtype"]])
    H = config["text"]["hidden_size"]
    return {
        "text": decoder.draw(d, config["text"]),
        "dna_rna": _encoder(d, config["dna_rna"]),
        "protein": _encoder(d, config["protein"]),
        "dna_rna_projector": {
            "kernel": d.uniform(config["dna_rna"]["hidden_size"], H),
            "bias": d.zeros(H)},
        "protein_projector": {
            "kernel": d.uniform(config["protein"]["hidden_size"], H),
            "bias": d.zeros(H)},
    }
