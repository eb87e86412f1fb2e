"""KV-cache generate loop: prefill from injected embeddings, then decode with
sampling — the counterpart of ``molly_tpu/inference/engine.py``.

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

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models import fusion, qwen3
from ..models.configs import FusionConfig, GenerationConfig, Qwen3Config
from ..parallel import comm, sharding
from .sampling import sample_tokens

EMBED_KEYS = ("input_ids", "dna_rna_tokens", "dna_rna_pos",
              "protein_tokens", "protein_pos")


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class _Clock:
    """Wall-clock phase timer for ``stats``; synchronizes the device at each
    mark, so it is only created when a caller asks for timings."""

    def __init__(self, stats: Dict[str, float], device: torch.device):
        self.stats, self.device = stats, device
        self._sync()
        self.t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.stats[name] = self.stats.get(name, 0.0) + now - self.t
        self.t = now


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
    to the device of the text embedding. ``stats``, when given, accumulates
    seconds per phase (``encode_s``, ``prefill_s``, ``decode_s``) and counts
    ``decode_steps``; it synchronizes the device between phases. An
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
    clock = _Clock(stats, device) if stats is not None else None
    embed_batch = {k: _as_tensor(batch[k], device) for k in EMBED_KEYS
                   if k in batch}
    embeds = fusion.build_inputs_embeds(params, cfg, embed_batch)
    if clock:
        clock.mark("encode_s")
    return _generate_from_embeds(
        params["text"], cfg.text, embeds,
        _as_tensor(batch["attention_mask"], device), gen, generator, clock,
        kv_quant)


@torch.inference_mode()
def _generate_from_embeds(
    text_params: Dict[str, Any],
    cfg: Qwen3Config,
    embeds: torch.Tensor,          # [B, S, H] (left-padded prompt)
    attention_mask: torch.Tensor,  # [B, S]
    gen: GenerationConfig,
    generator: Optional[torch.Generator] = None,
    clock: Optional[_Clock] = None,
    kv_quant: Optional[str] = None,
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

    cache = qwen3.init_cache(cfg, B, total, device=dev, quant=kv_quant)
    full_mask = torch.zeros((B, total), dtype=torch.int32, device=dev)
    full_mask[:, :S] = attention_mask

    # positions: left-pad-aware (#real tokens before me)
    n_real = attention_mask.sum(dim=1)  # [B]
    positions = torch.clamp(
        torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1, min=0)

    hidden, cache = qwen3.forward_hidden(
        text_params, cfg, inputs_embeds=embeds, attention_mask=full_mask,
        positions=positions, cache=cache, cache_index=0)
    # last real token is at index S-1 (left padding)
    logits0 = qwen3.logits_from_hidden(text_params, cfg, hidden[:, -1])

    def sample(logits, presence):
        tok = sample_tokens(
            logits, generator, do_sample=gen.do_sample,
            temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
            repetition_penalty=gen.repetition_penalty, presence=presence)
        if mesh is not None and mesh.devices.size > 1:
            tok = comm.broadcast(tok, 0, torch.distributed.group.WORLD)
        return tok

    rows = torch.arange(B, device=dev)
    presence = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=dev)
    tok0 = sample(logits0, presence)
    tokens = torch.full((B, T), gen.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = tok0
    presence[rows, tok0] = True
    done = tok0 == gen.eos_token_id
    if clock:
        clock.stats["logits_finite"] = (clock.stats.get("logits_finite", True)
                                        and bool(torch.isfinite(logits0).all()))
        clock.mark("prefill_s")

    col = torch.arange(total, device=dev)[None, :]
    for i in range(1, T):
        if bool(done.all()):
            break
        if clock:
            clock.stats["decode_steps"] = clock.stats.get("decode_steps", 0) + 1
        j = i - 1  # index of the token being fed; it sits at cache slot S+j
        emb = qwen3.embed_tokens(text_params, tokens[:, j:j + 1])
        mask = torch.where(col < S, full_mask,
                           (col <= S + j).to(torch.int32))
        pos = (n_real + j)[:, None]
        hidden, cache = qwen3.forward_hidden(
            text_params, cfg, inputs_embeds=emb, attention_mask=mask,
            positions=pos, cache=cache, cache_index=S + j)
        logits = qwen3.logits_from_hidden(text_params, cfg, hidden[:, 0])
        nxt = sample(logits, presence)
        nxt = torch.where(done, gen.pad_token_id, nxt)
        tokens[:, i] = nxt
        presence[rows, nxt] = True
        done = done | (nxt == gen.eos_token_id)
    if clock:
        clock.mark("decode_s")
    return tokens
