"""Tri-modal fusion model: Qwen3 decoder + frozen ESM-family encoders with
linear projectors, the counterpart of ``molly_tpu/models/fusion.py``.

Semantics kept: one encoder call per modality over ALL [B, G] segment slots
(dummy slots included, their outputs dropped), the encoder mask
``tokens != 1`` with position 0 forced on, and projected hidden states
overwriting the K placeholder rows start+1 .. start+K. Where JAX scatters
with ``mode="drop"`` (inactive slots carry start = -1), the port masks those
rows out before an in-place ``index_put_``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from . import esm, qwen3
from .configs import EsmConfig, FusionConfig
from .qwen3 import torch_dtype

Params = Dict[str, Any]


def init_params(cfg: FusionConfig, generator: torch.Generator,
                device="cpu") -> Params:
    dt = torch_dtype(cfg.text.dtype)

    def projector(d_in, d_out):
        # nn.Linear default init: U(-1/sqrt(in), 1/sqrt(in))
        bound = d_in ** -0.5
        w = torch.rand((d_in, d_out), generator=generator,
                       dtype=torch.float32, device=device)
        return {"kernel": (w * (2 * bound) - bound).to(dt),
                "bias": torch.zeros((d_out,), dtype=dt, device=device)}

    return {
        "text": qwen3.init_params(cfg.text, generator, device),
        "dna_rna": esm.init_params(cfg.dna_rna, generator, device),
        "protein": esm.init_params(cfg.protein, generator, device),
        "dna_rna_projector": projector(cfg.dna_rna.hidden_size,
                                       cfg.text.hidden_size),
        "protein_projector": projector(cfg.protein.hidden_size,
                                       cfg.text.hidden_size),
    }


def encode_and_project(params: Params, enc_cfg: EsmConfig, proj_name: str,
                       enc_name: str, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, G, K] -> projected embeddings [B, G, K, H_text]."""
    B, G, K = tokens.shape
    flat = tokens.reshape(B * G, K)
    mask = (flat != 1).to(torch.int32)
    # dummy all-pad segments would have an empty mask; force position 0
    # attended (real segments start with a non-pad CLS anyway)
    mask[:, 0] = 1
    h = esm.forward_hidden(params[enc_name], enc_cfg, flat, mask)
    proj = params[proj_name]
    out = h @ proj["kernel"] + proj["bias"]
    return out.reshape(B, G, K, -1)


def inject(hidden: torch.Tensor, proj_emb: torch.Tensor,
           start_pos: torch.Tensor) -> torch.Tensor:
    """Overwrite placeholder rows with encoder embeddings, in place.

    hidden [B, S, H]; proj_emb [B, G, K, H]; start_pos [B, G], the index of
    the <|*_start|> token, -1 = inactive slot. Slot g of sample b writes rows
    start+1 .. start+K; rows of inactive slots, and rows past S, are dropped
    (JAX's scatter ``mode="drop"``)."""
    B, S, H = hidden.shape
    K = proj_emb.shape[2]
    offsets = torch.arange(K, device=hidden.device)[None, None, :]
    rows = start_pos[..., None].to(torch.long) + 1 + offsets   # [B, G, K]
    keep = (start_pos[..., None] >= 0) & (rows < S)
    batch_idx = torch.arange(B, device=hidden.device)[:, None, None].expand(
        rows.shape)
    hidden.index_put_((batch_idx[keep], rows[keep]),
                      proj_emb[keep].to(hidden.dtype))
    return hidden


def build_inputs_embeds(params: Params, cfg: FusionConfig,
                        batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings with omics segments injected."""
    hidden = qwen3.embed_tokens(params["text"], batch["input_ids"])
    if "dna_rna_tokens" in batch:
        demb = encode_and_project(params, cfg.dna_rna, "dna_rna_projector",
                                  "dna_rna", batch["dna_rna_tokens"])
        hidden = inject(hidden, demb, batch["dna_rna_pos"])
    if "protein_tokens" in batch:
        pemb = encode_and_project(params, cfg.protein, "protein_projector",
                                  "protein", batch["protein_tokens"])
        hidden = inject(hidden, pemb, batch["protein_pos"])
    return hidden


def forward_logits(params: Params, cfg: FusionConfig,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    embeds = build_inputs_embeds(params, cfg, batch)
    hidden, _ = qwen3.forward_hidden(
        params["text"], cfg.text, inputs_embeds=embeds,
        attention_mask=batch.get("attention_mask"))
    return qwen3.logits_from_hidden(params["text"], cfg.text, hidden)
