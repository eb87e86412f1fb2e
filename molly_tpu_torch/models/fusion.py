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

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.omics_dataset import (LABEL_IGNORE, NUM_DOMAIN_TASKS,
                                  UNKNOWN_TASK_ID)
from ..utils.tree import leaves
from . import esm, qwen3
from .configs import EsmConfig, FusionConfig, Qwen3Config
from .qwen3 import torch_dtype

Params = Dict[str, Any]



def init_params(cfg: FusionConfig, generator: torch.Generator,
                device="cpu", given: Optional[Params] = None) -> Params:
    """Random init from ``generator``. ``given`` maps subtree names
    (``text``, ``dna_rna``, ...) to params loaded already, such as an
    imported checkpoint: those are taken as they are and not drawn."""
    dt = torch_dtype(cfg.text.dtype)
    given = given or {}

    def projector(d_in, d_out):
        # nn.Linear default init: U(-1/sqrt(in), 1/sqrt(in))
        bound = d_in ** -0.5
        w = torch.rand((d_in, d_out), generator=generator,
                       dtype=torch.float32, device=device)
        return {"kernel": (w * (2 * bound) - bound).to(dt),
                "bias": torch.zeros((d_out,), dtype=dt, device=device)}

    draw = {
        "text": lambda: qwen3.init_params(cfg.text, generator, device),
        "dna_rna": lambda: esm.init_params(cfg.dna_rna, generator, device),
        "protein": lambda: esm.init_params(cfg.protein, generator, device),
        "dna_rna_projector": lambda: projector(cfg.dna_rna.hidden_size,
                                               cfg.text.hidden_size),
        "protein_projector": lambda: projector(cfg.protein.hidden_size,
                                               cfg.text.hidden_size),
    }
    return {k: given[k] if k in given else make() for k, make in draw.items()}


def encode_and_project(params: Params, enc_cfg: EsmConfig, proj_name: str,
                       enc_name: str, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, G, K] -> projected embeddings [B, G, K, H_text]."""
    B, G, K = tokens.shape
    flat = tokens.reshape(B * G, K)
    mask = (flat != 1).to(torch.int32)
    # dummy all-pad segments would have an empty mask; force position 0
    # attended (real segments start with a non-pad CLS anyway)
    mask[:, 0] = 1
    # a frozen encoder runs without autograd, so no backward exists for it
    # (the JAX step closes frozen subtrees over as constants)
    frozen = not any(t.requires_grad for t in leaves(params[enc_name]))
    with torch.no_grad() if frozen else torch.enable_grad():
        h = esm.forward_hidden(params[enc_name], enc_cfg, flat, mask)
    proj = params[proj_name]
    # fp32 projectors (a PEFT directory's .bin files) over a bf16 encoder
    # promote as JAX does: the product in fp32, rounded once at injection
    dt = torch.promote_types(h.dtype, proj["kernel"].dtype)
    out = h.to(dt) @ proj["kernel"].to(dt) + proj["bias"]
    return out.reshape(B, G, K, -1)


def inject(hidden: torch.Tensor, proj_emb: torch.Tensor,
           start_pos: torch.Tensor) -> torch.Tensor:
    """Overwrite placeholder rows with encoder embeddings (in place when
    autograd does not record, out of place when it does).

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
    idx = (batch_idx[keep], rows[keep])
    vals = proj_emb[keep].to(hidden.dtype)
    if torch.is_grad_enabled() and (hidden.requires_grad
                                    or vals.requires_grad):
        return hidden.index_put(idx, vals)
    hidden.index_put_(idx, vals)
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


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, S, V]
    labels: torch.Tensor,  # [B, S] with LABEL_IGNORE masking
    *,
    task_label: Optional[torch.Tensor] = None,  # [B]
    z_loss: float = 0.0,
    pre_shifted: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token CE over supervised positions (+ optional per-task
    domain-loss sums). pre_shifted=True: labels[t] already targets position
    t; skip the shift."""
    if not pre_shifted:
        logits, labels = logits[:, :-1], labels[:, 1:]
    valid = labels != LABEL_IGNORE
    labels_safe = torch.where(valid, labels, 0).to(torch.long)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, labels_safe[..., None])[..., 0]
    nll = (lse - tgt) * valid

    tokens_per_sample = valid.sum(dim=-1)
    total_tokens = torch.clamp(tokens_per_sample.sum(), min=1)
    loss = nll.sum() / total_tokens
    if z_loss:
        loss = loss + z_loss * (torch.square(lse) * valid).sum() / total_tokens
    metrics = {"loss": loss, "tokens": total_tokens}
    if task_label is not None:
        metrics.update(_domain_sums(nll.sum(dim=-1), tokens_per_sample,
                                    task_label))
    return loss, metrics


def _domain_sums(per_nll, per_tok, task_label) -> Dict[str, torch.Tensor]:
    """Per-sample mean loss -> per-task sums and counts (slot
    NUM_DOMAIN_TASKS collects unknown tasks)."""
    per_sample = per_nll / torch.clamp(per_tok, min=1)
    tid = torch.where(task_label == UNKNOWN_TASK_ID, NUM_DOMAIN_TASKS,
                      task_label).to(torch.long)
    onehot = F.one_hot(tid, NUM_DOMAIN_TASKS + 1).to(torch.float32)
    return {"domain_loss_sum": onehot.T @ per_sample.to(torch.float32),
            "domain_loss_count": onehot.sum(dim=0)}


def lm_head_weight(params: Params, cfg: Qwen3Config) -> torch.Tensor:
    text = params["text"] if "text" in params else params
    return text["embed"].T if cfg.tie_word_embeddings else text["lm_head"]


def loss_from_hidden(
    params: Params, cfg: FusionConfig, hidden: torch.Tensor,
    batch: Dict[str, torch.Tensor], *, z_loss: float = 0.0,
    fused_lce: bool = True, chunk_size: int = 256,
    pre_shifted: bool = False, lce_need_dw: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LM loss + metrics from final hidden states. fused_lce avoids the
    [B, S, V] logit tensor (``ops.lce``); the naive path materializes it.
    lce_need_dw=False skips the dead lm-head weight gradient when the text
    tower is frozen (LoRA / QLoRA)."""
    labels = batch["labels"]
    task_label = batch.get("task_label")
    if not fused_lce:
        logits = qwen3.logits_from_hidden(params["text"], cfg.text, hidden)
        return cross_entropy_loss(logits, labels, task_label=task_label,
                                  z_loss=z_loss, pre_shifted=pre_shifted)
    from ..ops.lce import causal_lm_loss
    w = lm_head_weight(params, cfg.text)
    loss, per_nll, per_tok = causal_lm_loss(
        hidden, w, labels, chunk_size=chunk_size, z_loss=z_loss,
        pre_shifted=pre_shifted, need_dw=lce_need_dw)
    metrics = {"loss": loss, "tokens": per_tok.sum()}
    if task_label is not None:
        metrics.update(_domain_sums(per_nll, per_tok, task_label))
    return loss, metrics


def loss_fn(params: Params, cfg: FusionConfig,
            batch: Dict[str, torch.Tensor], *, z_loss: float = 0.0,
            fused_lce: bool = True):
    embeds = build_inputs_embeds(params, cfg, batch)
    hidden, _ = qwen3.forward_hidden(
        params["text"], cfg.text, inputs_embeds=embeds,
        attention_mask=batch.get("attention_mask"))
    return loss_from_hidden(params, cfg, hidden, batch, z_loss=z_loss,
                            fused_lce=fused_lce)
