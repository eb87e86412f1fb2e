"""Tri-modal fusion model: a decoder (Qwen3, or the DeepSeek-V3 family,
found by ``models.decoders.of(cfg.text)``) + frozen ESM-family encoders with
linear projectors, the counterpart of ``molly_tpu/models/fusion.py``.

Semantics kept: the encoder mask ``tokens != 1`` with position 0 forced
on, and projected hidden states overwriting the K placeholder rows
start+1 .. start+K. A batch of tensors (``<m>_tokens`` [B, G, K],
``<m>_pos`` [B, G]) runs one encoder call per modality over ALL [B, G]
segment slots, dummy slots included, as JAX does; where JAX scatters with
``mode="drop"`` (inactive slots carry start = -1), the port masks those
rows out before an in-place ``index_put_``. A batch of host arrays can be
packed first (``pack_live_slots``): the encoders then run over the live
slots only, and their rows are written at indices picked on the host. Each
slot's encoder pass depends on its own row alone, so the rows written are
the same either way.

Under a mesh (``parallel.use_mesh``) the encoders and projectors are
gathered whole before use, and the loss is this rank's share of the global
batch's mean: its nll sum over the token count summed over the batch axes,
so the shares of all ranks add up to the loss GSPMD computes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.omics_dataset import (LABEL_IGNORE, NUM_DOMAIN_TASKS,
                                  UNKNOWN_TASK_ID)
from ..parallel import comm, sharding
from ..utils import profiling
from ..utils.tree import leaves
from . import decoders, esm
from .configs import EsmConfig, FusionConfig
from .qwen3 import torch_dtype

Params = Dict[str, Any]
MODALITIES = ("dna_rna", "protein")


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
        "text": lambda: decoders.of(cfg.text).init_params(cfg.text,
                                                          generator, device),
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
    """tokens [..., K] (all slots [B, G, K], or live ones [N, K]) ->
    projected embeddings [..., K, H_text]."""
    *lead, K = tokens.shape
    flat = tokens.reshape(-1, K)
    mask = (flat != 1).to(torch.int32)
    # dummy all-pad segments would have an empty mask; force position 0
    # attended (real segments start with a non-pad CLS anyway)
    mask[:, 0] = 1
    # a frozen encoder runs without autograd, so no backward exists for it
    # (the JAX step closes frozen subtrees over as constants)
    frozen = not any(t.requires_grad for t in leaves(params[enc_name]))
    with torch.no_grad() if frozen else torch.enable_grad():
        h = esm.forward_hidden(sharding.full_tree(params[enc_name]), enc_cfg,
                               flat, mask)
    proj = sharding.full_tree(params[proj_name])
    # fp32 projectors (a PEFT directory's .bin files) over a bf16 encoder
    # promote as JAX does: the product in fp32, rounded once at injection
    dt = torch.promote_types(h.dtype, proj["kernel"].dtype)
    out = h.to(dt) @ proj["kernel"].to(dt) + proj["bias"]
    return out.reshape(*lead, K, -1)


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
    with profiling.sync("inject", 3):  # each boolean mask waits for its count
        idx = (batch_idx[keep], rows[keep])
        vals = proj_emb[keep].to(hidden.dtype)
    return _put(hidden, idx, vals)


def inject_rows(hidden: torch.Tensor, proj_emb: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """``inject`` for live slots packed on the host (``pack_live_slots``):
    proj_emb [N, K, H]; rows [3, M], each written row's batch row, sequence
    row and row of proj_emb flattened to [N * K, H]. Every index is in
    range, so nothing is masked and nothing waits."""
    vals = proj_emb.reshape(-1, proj_emb.shape[-1])[rows[2]].to(hidden.dtype)
    return _put(hidden, (rows[0], rows[1]), vals)


def _put(hidden, idx, vals):
    if torch.is_grad_enabled() and (hidden.requires_grad
                                    or vals.requires_grad):
        return hidden.index_put(idx, vals)
    hidden.index_put_(idx, vals)
    return hidden


def packs_on_host(batch: Dict[str, Any], name: str) -> bool:
    """Does ``pack_live_slots`` pack modality ``name`` of ``batch``? Only
    where its tokens and starts are host arrays, not tensors: picking the
    live slots of a tensor would wait for the device."""
    return not any(isinstance(batch[f"{name}_{k}"], torch.Tensor)
                   for k in ("tokens", "pos"))


def pack_live_slots(batch: Dict[str, Any]) -> Dict[str, Any]:
    """``batch`` with each modality held in host arrays (``packs_on_host``)
    packed, in numpy, to its live slots (``<m>_pos >= 0``): ``<m>_tokens``
    [N, K], the live slots in row-major [B, G] order, and ``<m>_rows``
    [3, M] int64 (see ``inject_rows``) in place of ``<m>_tokens`` [B, G, K]
    and ``<m>_pos``. Rows start+1 .. start+K at S or beyond are left out,
    as JAX's scatter ``mode="drop"`` drops them. A modality with no live
    slot is left out whole: no encoder runs for it and nothing is
    written."""
    out = dict(batch)
    S = batch["input_ids"].shape[1]
    for name in MODALITIES:
        if f"{name}_tokens" not in batch or not packs_on_host(batch, name):
            continue
        tokens = np.asarray(out.pop(f"{name}_tokens"))
        pos = np.asarray(out.pop(f"{name}_pos"))
        b, g = np.nonzero(pos >= 0)
        if b.size == 0:
            continue
        K = tokens.shape[-1]
        rows = pos[b, g].astype(np.int64)[:, None] + 1 + np.arange(K)
        src = np.flatnonzero(rows < S)  # into the [N * K] outputs
        out[f"{name}_tokens"] = tokens[b, g]
        out[f"{name}_rows"] = np.stack([b[src // K], rows.ravel()[src], src])
    return out


def build_inputs_embeds(params: Params, cfg: FusionConfig,
                        batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings with omics segments injected: over every slot
    (``<m>_pos``), or over the live ones packed on the host
    (``<m>_rows``)."""
    with profiling.span("molly/encode", device=True):
        hidden = decoders.of(cfg.text).embed_tokens(params["text"],
                                                    batch["input_ids"])
        for name in MODALITIES:
            if f"{name}_tokens" not in batch:
                continue
            with profiling.span(f"molly/encode/{name}", device=True):
                emb = encode_and_project(params, getattr(cfg, name),
                                         f"{name}_projector", name,
                                         batch[f"{name}_tokens"])
                if f"{name}_rows" in batch:
                    hidden = inject_rows(hidden, emb, batch[f"{name}_rows"])
                else:
                    hidden = inject(hidden, emb, batch[f"{name}_pos"])
    return hidden


def forward_logits(params: Params, cfg: FusionConfig,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    embeds = build_inputs_embeds(params, cfg, batch)
    decoder = decoders.of(cfg.text)
    hidden, _ = decoder.forward_hidden(
        params["text"], cfg.text, inputs_embeds=embeds,
        attention_mask=batch.get("attention_mask"))
    return decoder.logits_from_hidden(params["text"], cfg.text, hidden)


def shift_for_next_token(logits: torch.Tensor, labels: torch.Tensor):
    """HF CausalLM convention: logits[:, :-1] predict labels[:, 1:]."""
    return logits[:, :-1], labels[:, 1:]


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
        logits, labels = shift_for_next_token(logits, labels)
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


def lm_head_weight(params: Params, cfg: Any) -> torch.Tensor:
    """The head [H, V] of the decoder's text configuration ``cfg``."""
    text = params["text"] if "text" in params else params
    if cfg.tie_word_embeddings:
        return sharding.full(text["embed"]).T
    return sharding.full(text["lm_head"])


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
        if batch_group() is not None:
            raise ValueError("under a mesh with batch axes the loss is the "
                             "fused one (fused_lce=True)")
        logits = decoders.of(cfg.text).logits_from_hidden(
            params["text"], cfg.text, hidden)
        return cross_entropy_loss(logits, labels, task_label=task_label,
                                  z_loss=z_loss, pre_shifted=pre_shifted)
    from ..ops.lce import causal_lm_loss
    w = lm_head_weight(params, cfg.text)
    loss, per_nll, per_tok = causal_lm_loss(
        hidden, w, labels, chunk_size=chunk_size, z_loss=z_loss,
        pre_shifted=pre_shifted, need_dw=lce_need_dw)
    metrics = {"loss": loss, "tokens": per_tok.sum()}
    group = batch_group()
    if group is not None:
        total = comm.all_reduce(per_tok.sum(), group)
        loss = per_nll.sum() / torch.clamp(total, min=1)
        metrics = {"loss": loss, "tokens": total}
    if task_label is not None:
        mesh = comm.current_mesh()
        rows = None
        if mesh is not None:
            # a sample's tokens may be split over seq: whole samples first,
            # then the sums over the ranks that hold other samples
            seq = mesh.group(sharding.SEQ_AXIS)
            per_nll = comm.all_reduce(per_nll.detach(), seq)
            per_tok = comm.all_reduce(per_tok, seq)
            rows = mesh.group(sharding.DATA_AXIS, sharding.FSDP_AXIS)
        metrics.update({k: comm.all_reduce(v, rows) for k, v in
                        _domain_sums(per_nll, per_tok, task_label).items()})
    return loss, metrics


def batch_group():
    """The process group of the current mesh's batch axes (the ranks that
    hold other tokens), or None."""
    mesh = comm.current_mesh()
    return mesh.group(*sharding.BATCH_AXES) if mesh is not None else None


def loss_fn(params: Params, cfg: FusionConfig,
            batch: Dict[str, torch.Tensor], *, z_loss: float = 0.0,
            fused_lce: bool = True):
    embeds = build_inputs_embeds(params, cfg, batch)
    hidden, _ = decoders.of(cfg.text).forward_hidden(
        params["text"], cfg.text, inputs_embeds=embeds,
        attention_mask=batch.get("attention_mask"))
    return loss_from_hidden(params, cfg, hidden, batch, z_loss=z_loss,
                            fused_lce=fused_lce)
