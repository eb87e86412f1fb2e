"""KV-cache generate loop: prefill from injected embeddings, then decode with
sampling — the counterpart of ``molly_tpu/inference/engine.py``. The
decoder is the text configuration's (``models.decoders.of``): Qwen3's dense
KV cache, or the DeepSeek-V3 family's latent cache.

Prompts are left-padded to a fixed length S; the cache holds S +
max_new_tokens columns; prefill writes the whole prompt at column 0 under a
mask over the whole cache, and each decode step writes one column in place.
Where JAX runs a ``lax.while_loop`` with an early exit once every row has
emitted EOS, this is a Python loop that checks the same condition.

Under a mesh (``parallel.use_mesh`` over ``shard_params(..., bare_text=True)``
blocks, or a fusion tree's) every rank runs the whole batch: the layers
gather their blocks as in training, attention and the KV cache hold this
rank's heads on the ``tensor`` axis, an MoE decoder keeps its experts on
their ranks under ``expert_parallel``, and the embedding and head are
gathered once before the loop. Every rank emits rank 0's tokens (a
broadcast after each sample), so sampled decoding agrees across ranks too.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models import decoders, fusion
from ..models.configs import FusionConfig, GenerationConfig
from ..parallel import comm, sharding
from ..utils import profiling
from .sampling import sample_tokens

EMBED_KEYS = ("input_ids", "dna_rna_tokens", "dna_rna_pos", "dna_rna_rows",
              "protein_tokens", "protein_pos", "protein_rows")


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


# the modality tokenizers' pad id (``fusion.encode_and_project`` masks it)
_SEGMENT_PAD = 1


def _count_work(batch: Dict[str, Any]) -> None:
    """The recording's counts of the batch's encoder and prefill work, run
    against live: tokens of the slots the encoders run (the live ones,
    ``pos >= 0``, where ``fusion.pack_live_slots`` packs the modality, else
    every slot) against the non-pad tokens of the live ones, and the slots
    not run, per modality and summed; prompt positions against the
    attention mask's ones. Read from the arrays as handed in (numpy on the
    host; a tensor's count is read when the recording closes)."""
    run = live = skipped = 0
    for m in fusion.MODALITIES:
        if f"{m}_tokens" not in batch:
            continue
        tok, pos = batch[f"{m}_tokens"], batch[f"{m}_pos"]
        slots = pos.shape[0] * pos.shape[1]
        m_skipped = (slots - int((pos >= 0).sum())
                     if fusion.packs_on_host(batch, m) else 0)
        m_run = (slots - m_skipped) * tok.shape[2]
        m_live = _total((tok != _SEGMENT_PAD) & (pos >= 0)[..., None])
        profiling.count(f"encoder_tokens_run/{m}", m_run)
        profiling.count(f"encoder_tokens_live/{m}", m_live)
        profiling.count(f"encoder_slots_skipped/{m}", m_skipped)
        run, live = run + m_run, live + m_live
        skipped += m_skipped
    profiling.count("encoder_tokens_run", run)
    profiling.count("encoder_tokens_live", live)
    profiling.count("encoder_slots_skipped", skipped)
    mask = batch["attention_mask"]
    profiling.count("prefill_positions_run", mask.shape[0] * mask.shape[1])
    profiling.count("prefill_positions_live", _total(mask))


def _total(x):
    """A host array's sum as an int; a tensor's stays on its device."""
    return x.sum() if isinstance(x, torch.Tensor) else int(x.sum())


@torch.inference_mode()
def generate(
    params: Dict[str, Any],
    cfg: FusionConfig,
    batch: Dict[str, Any],
    gen: GenerationConfig,
    generator: Optional[torch.Generator] = None,
    stats: Optional[Dict[str, float]] = None,
    lora_alpha: Optional[float] = None,
    kv_quant: Optional[str] = None,
) -> torch.Tensor:
    """Returns new tokens only, [B, max_new_tokens], rows padded with
    pad_token_id after EOS. ``batch`` holds numpy arrays or tensors; they go
    to the device of the text embedding. A modality held in numpy arrays
    is packed to its live slots first (``fusion.pack_live_slots``), so the
    encoders run those alone; one held in tensors runs every slot.
    ``stats``, when given, accumulates seconds per phase (``encode_s``,
    ``prefill_s``, ``decode_s``), counts
    ``decode_steps``, notes whether the prefill's logits were all finite
    (``logits_finite``) and takes the spans and counts of a recording
    (``utils.profiling.recording``; the caller's, when one is current); it
    synchronizes the device between phases. An
    unmerged ``params["lora"]`` is merged first with ``lora_alpha`` (default
    64). ``kv_quant="int8"`` stores the KV cache as int8 with per-column
    scales (half the cache bytes); prefill and decode then read it through
    the plain attention path, as the JAX engine does."""
    lora = params.get("lora")
    if lora is not None:
        # fold adapters into the base weights (PEFT merge_and_unload).
        # Callers doing repeated batched inference should merge once up
        # front (the CLI does); this per-call path is a convenience for
        # one-off use. A quantized decode base cannot be merged.
        assert "q_proj" in params["text"]["layers"], (
            "merge adapters before quantize_for_decode")
        from ..models.lora import LoraConfig, merge_lora
        r = lora["layers"]["q_proj"]["a"].shape[-1]
        alpha = float(lora_alpha) if lora_alpha is not None else 64.0
        params = {**params, "lora": None,
                  "text": merge_lora(params["text"], lora,
                                     LoraConfig(r=r, alpha=alpha))}
    device = params["text"]["embed"].device
    with profiling.recording(stats):
        mark = (profiling.phase_marks(stats, device) if stats is not None
                else None)
        with profiling.span("molly/generate", device=True):
            if profiling.active():
                _count_work(batch)
            # the live slots, picked from host arrays before they go up
            batch = fusion.pack_live_slots(batch)
            keys = [k for k in EMBED_KEYS if k in batch] + ["attention_mask"]
            with profiling.sync("upload", sum(
                    not (isinstance(batch[k], torch.Tensor)
                         and batch[k].device == device) for k in keys)):
                arrays = {k: _as_tensor(batch[k], device) for k in keys}
            mask = arrays.pop("attention_mask")
            embeds = fusion.build_inputs_embeds(params, cfg, arrays)
            if mark:
                mark("encode_s")
            tokens = _generate_from_embeds(
                params["text"], cfg.text, embeds, mask, gen, generator,
                mark, kv_quant, stats)
        if mark:  # after the span, so its closing event is waited for too
            mark("decode_s")
    return tokens


@torch.inference_mode()
def _generate_from_embeds(
    text_params: Dict[str, Any],
    cfg: Any,                      # the decoder's text configuration
    embeds: torch.Tensor,          # [B, S, H] (left-padded prompt)
    attention_mask: torch.Tensor,  # [B, S]
    gen: GenerationConfig,
    generator: Optional[torch.Generator] = None,
    mark: Optional[Callable[[str], None]] = None,
    kv_quant: Optional[str] = None,
    stats: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    B, S, _ = embeds.shape
    T = gen.max_new_tokens
    total = S + T
    dev = embeds.device
    mesh = comm.current_mesh()
    if mesh is not None:  # the embedding and head whole, once
        text_params = {**text_params, **{
            k: sharding.full(text_params[k]) for k in ("embed", "lm_head")
            if k in text_params}}

    decoder = decoders.of(cfg)
    cache = decoder.init_cache(cfg, B, total, device=dev, quant=kv_quant)
    full_mask = torch.zeros((B, total), dtype=torch.int32, device=dev)
    full_mask[:, :S] = attention_mask

    # positions: left-pad-aware (#real tokens before me)
    n_real = attention_mask.sum(dim=1)  # [B]
    positions = torch.clamp(
        torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1, min=0)

    def sample(logits, presence):
        with profiling.span("molly/sample"):
            tok = sample_tokens(
                logits, generator, do_sample=gen.do_sample,
                temperature=gen.temperature, top_k=gen.top_k,
                top_p=gen.top_p, repetition_penalty=gen.repetition_penalty,
                presence=presence)
            if mesh is not None and mesh.devices.size > 1:
                tok = comm.broadcast(tok, 0, torch.distributed.group.WORLD)
        return tok

    with profiling.span("molly/prefill", device=True):
        hidden, cache = decoder.forward_hidden(
            text_params, cfg, inputs_embeds=embeds, attention_mask=full_mask,
            positions=positions, cache=cache, cache_index=0)
        # last real token is at index S-1 (left padding)
        with profiling.span("molly/head"):
            logits0 = decoder.logits_from_hidden(text_params, cfg,
                                                 hidden[:, -1])
        rows = torch.arange(B, device=dev)
        presence = torch.zeros((B, cfg.vocab_size), dtype=torch.bool,
                               device=dev)
        tok0 = sample(logits0, presence)
        tokens = torch.full((B, T), gen.pad_token_id, dtype=torch.long,
                            device=dev)
        tokens[:, 0] = tok0
        with profiling.sync("presence"):  # the host scalar's copy waits
            presence[rows, tok0] = True
        done = tok0 == gen.eos_token_id
    if mark:
        stats["logits_finite"] = (stats.get("logits_finite", True)
                                  and bool(torch.isfinite(logits0).all()))
        mark("prefill_s")

    col = torch.arange(total, device=dev)[None, :]
    for i in range(1, T):
        with profiling.span("molly/decode_step", device=True):
            with profiling.sync("eos"):
                finished = bool(done.all())
            if finished:
                break
            if stats is not None:
                stats["decode_steps"] = stats.get("decode_steps", 0) + 1
            j = i - 1  # index of the token being fed; it sits at slot S+j
            emb = decoder.embed_tokens(text_params, tokens[:, j:j + 1])
            mask = torch.where(col < S, full_mask,
                               (col <= S + j).to(torch.int32))
            pos = (n_real + j)[:, None]
            hidden, cache = decoder.forward_hidden(
                text_params, cfg, inputs_embeds=emb, attention_mask=mask,
                positions=pos, cache=cache, cache_index=S + j)
            with profiling.span("molly/head"):
                logits = decoder.logits_from_hidden(text_params, cfg,
                                                    hidden[:, 0])
            nxt = sample(logits, presence)
            nxt = torch.where(done, gen.pad_token_id, nxt)
            tokens[:, i] = nxt
            with profiling.sync("presence"):
                presence[rows, nxt] = True
            done = done | (nxt == gen.eos_token_id)
    return tokens
