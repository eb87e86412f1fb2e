"""Continuous-batching serving engine (in-flight batching over KV slots), the
counterpart of ``molly_tpu/inference/server.py``.

Static batching makes every prompt of a batch wait for the longest
generation. This engine keeps

  - a fixed pool of ``n_slots`` KV-cache slots ([L, n_slots, Nkv, Smax,
    2*Dh]);
  - prefill per admission group on a padded length bucket, the resulting KV
    block inserted into free slots while other slots keep decoding;
  - decode steps that advance ALL active slots one token, with per-slot
    sampling state (presence sets for the repetition penalty) and per-slot
    EOS/length termination;
  - finished slots freed at once for the next queued request — no
    head-of-line blocking.

Cache layout: columns [0, prompt_cols) hold each slot's prefilled prompt;
columns [prompt_cols, Smax) are a GENERATION RING indexed by a global tick
counter shared by every slot, so all slots write the SAME column each decode
step (one slice store). Column order is not token order in the ring, so
attention runs mask-only (``causal=False``) with RoPE positions tracked per
slot; a request's generated span is contiguous in ring ticks, so
``cap <= ring_cols`` guarantees it never overwrites its own live history.

Where the JAX package compiles three dispatches (prefill+insert, decode
chunk, both fused), this package runs the same three functions eagerly. The
serving state is split the same way, and the split matters here for another
reason: HOT buffers (KV pool or page pools, ``valid``, ``presence``) are
updated IN PLACE; COLD rows (the [slots]-sized flags, counters, sampler rows
and output buffers) are always replaced by new tensors, never written in
place, because the scheduler harvests from a cold snapshot that is one
chunk old (``prev_cold`` in ``step``) and must not see later updates
through an alias. Where JAX's ``while_loop`` tests the chunk's exit
condition on the device, the eager loop fetches one packed value per step.
Random draws come from one explicit ``torch.Generator`` on the engine's
device, so sampled output matches the JAX engine in distribution only;
greedy output is token-exact.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..models import fusion, qwen3
from ..models.configs import FusionConfig, GenerationConfig
from ..utils import profiling
from .engine import EMBED_KEYS
from .sampling import sample_tokens_rowwise


# the arrays of a Request's single-sample batch (encode_test's layout)
REQUEST_KEYS = ("input_ids", "attention_mask", "dna_rna_tokens",
                "dna_rna_pos", "protein_tokens", "protein_pos")


@dataclass
class Request:
    uid: Any
    batch: Dict[str, np.ndarray]  # single-sample arrays: input_ids [1, S],
    #                               attention_mask [1, S], optional
    #                               {dna_rna,protein}_{tokens,pos}
    max_new_tokens: Optional[int] = None  # per-request cap (<= engine cap)
    # per-request sampling overrides (any of "greedy", "temperature",
    # "top_k", "top_p", "repetition_penalty"); unset keys inherit the
    # engine's GenerationConfig. top_k is bounded by the engine's candidate
    # width (gen.top_k); temperature <= 0 means greedy.
    sampling: Optional[Dict[str, Any]] = None
    # multi-LoRA serving: index into the engine's stacked adapter bank
    # (lora.stack_adapters; 0 = base model, i+1 = adapter i)
    adapter: int = 0


def _pad_to_bucket(batch: Dict[str, np.ndarray], bucket: int,
                   pad_id: int, side: str = "left"
                   ) -> Dict[str, np.ndarray]:
    """Pad a single-sample batch to the bucket length. side="left" mirrors
    the dataset's test-mode left pad and shifts omics segment start
    positions; side="right" keeps content at position 0 (the paged engine
    packs tokens from the start of each page chain, inference/paged.py)."""
    ids = np.asarray(batch["input_ids"])
    S = ids.shape[1]
    d = bucket - S
    assert d >= 0, (S, bucket)
    pad = (d, 0) if side == "left" else (0, d)
    out = dict(batch)
    out["input_ids"] = np.pad(ids, ((0, 0), pad), constant_values=pad_id)
    mask = np.asarray(batch.get("attention_mask",
                                np.ones_like(ids, np.int32)))
    out["attention_mask"] = np.pad(mask, ((0, 0), pad))
    if side == "left":
        for key in ("dna_rna_pos", "protein_pos"):
            if key in batch:
                pos = np.asarray(batch[key])
                out[key] = np.where(pos >= 0, pos + d, pos)
    return out


# ---------------------------------------------------------------------------
# the three dispatches (params passed explicitly; cfg/gen bound by partial)
# ---------------------------------------------------------------------------


# HOT buffers are updated in place; everything else is COLD and replaced.
# "kv_scale" exists only with kv_quant="int8" (per-column KV scales);
# "k_pages"/"v_pages" only in the paged engine (inference/paged.py).
_HOT_KEYS = ("cache", "kv_scale", "valid", "presence",
             "k_pages", "v_pages", "k_scales", "v_scales")


def _split_state(s):
    return ({k: s[k] for k in _HOT_KEYS if k in s},
            {k: v for k, v in s.items() if k not in _HOT_KEYS})


def _at_set(t: torch.Tensor, idx, value) -> torch.Tensor:
    """A copy of the cold row ``t`` with ``t[idx] = value`` (JAX's
    ``t.at[idx].set(value)``): snapshots of the old row stay as they were."""
    out = t.clone()
    out[idx] = value
    return out


def _samp_from_state(s) -> dict:
    return {"greedy": s["samp_greedy"], "temperature": s["samp_temp"],
            "top_k": s["samp_top_k"], "top_p": s["samp_top_p"],
            "repetition_penalty": s["samp_pen"]}


def _mark(clock: Optional[Callable[[str], None]], name: str) -> None:
    if clock is not None:
        clock(name)


def _prefill_forward(params, batch, samp, generator, kv_pre, *,
                     cfg: FusionConfig, gen: GenerationConfig, s_pre: int,
                     last_index=None):
    """Embed (with omics injection), prefill a fresh [k, s_pre + Sb] cache
    and sample each row's first token — the part of an admission that the
    dense-ring and paged engines share. With ``s_pre`` the cache starts with
    the shared prefix KV and the batch holds only the suffix, so the
    attention call has ``q_offset = s_pre`` and Sq < Skv. ``last_index``
    [k] names each row's last real suffix column (right-padded batches);
    None means the last column (left-padded). Returns (cache kv, full mask,
    logits, tok0, presence)."""
    tcfg = cfg.text
    dev = params["text"]["embed"].device
    embeds = fusion.build_inputs_embeds(
        params, cfg, {k: batch[k] for k in EMBED_KEYS if k in batch})
    mask = batch["attention_mask"].to(torch.int32)
    k, Sb = mask.shape
    cache = qwen3.init_cache(tcfg, k, s_pre + Sb, device=dev)
    positions = s_pre + torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    if s_pre:
        cache["kv"][:, :, :, :s_pre] = kv_pre.to(cache["kv"].dtype)
        full_mask = torch.cat(
            [torch.ones((k, s_pre), dtype=torch.int32, device=dev), mask],
            dim=1)
    else:
        full_mask = mask
    bank = params.get("lora_bank")
    hidden, cache = qwen3.forward_hidden(
        params["text"], tcfg, inputs_embeds=embeds,
        attention_mask=full_mask, positions=positions, cache=cache,
        cache_index=s_pre, lora=bank,
        lora_slots=samp.get("adapter") if bank is not None else None)
    rows = torch.arange(k, device=dev)
    last = hidden[:, -1] if last_index is None else hidden[rows, last_index]
    logits = qwen3.logits_from_hidden(params["text"], tcfg, last)
    presence = torch.zeros((k, tcfg.vocab_size), dtype=torch.bool, device=dev)
    tok0 = sample_tokens_rowwise(logits, generator, samp, presence,
                                 max_top_k=gen.top_k)
    presence[rows, tok0] = True
    return cache["kv"], full_mask, logits, tok0, presence


@torch.no_grad()
def _prefill_insert_impl(params, hot, cold, batch, slots, caps, samp,
                         generator, kv_pre, *, cfg: FusionConfig,
                         gen: GenerationConfig, s_pre: int = 0, clock=None):
    """Embed + prefill + sample first tokens + insert for a GROUP of k
    same-bucket requests in one call (a B=1 prefill reads all the weights
    for one row; batching admissions amortizes that).

    batch tensors are [k, Sb]; slots/caps are [k]. With prefix caching
    (s_pre > 0), ``kv_pre`` [L, 1, Nkv, s_pre, 2Dh] is the precomputed KV
    of the shared prompt prefix (the fixed system prompt) and the batch
    holds only the SUFFIX — prefill cost drops accordingly."""
    s = {**hot, **cold}
    kv, full_mask, logits, tok0, presence = _prefill_forward(
        params, batch, samp, generator, kv_pre, cfg=cfg, gen=gen,
        s_pre=s_pre)
    n = full_mask.shape[1]
    # each request's (prefix ‖) prompt KV fills columns [0, s_pre + Sb);
    # prefill itself runs in the model dtype (keeps flash attention),
    # quantizing only at insertion when the slot pool stores int8 KV
    if "kv_scale" in s:
        q8, sc = qwen3.quantize_kv(kv)
        s["cache"][:, slots, :, :n] = q8
        s["kv_scale"][:, slots, :, :n] = sc
    else:
        s["cache"][:, slots, :, :n] = kv.to(s["cache"].dtype)
    rows = torch.zeros((len(slots), s["valid"].shape[1]), dtype=torch.int32,
                       device=full_mask.device)
    rows[:, :n] = full_mask
    s["valid"][slots] = rows
    s["n_real"] = _at_set(s["n_real"], slots, full_mask.sum(dim=1))
    s = _insert_request_rows(s, slots, caps, samp, tok0, presence, logits,
                             gen=gen)
    _mark(clock, "prefill_s")
    return _split_state(s)


def _insert_request_rows(s, slots, caps, samp, tok0, presence, logits, *,
                         gen: GenerationConfig):
    """Admission bookkeeping shared by the dense-ring and paged engines:
    per-slot sampler state, output buffers, caps, and active/finished
    flags — everything EXCEPT the KV storage itself (which is layout-
    specific: slot-pool insert above, page scatter in inference/paged.py).
    ``presence`` is hot (stored in place); the rest are new cold rows."""
    k = tok0.shape[0]
    dev = tok0.device
    s["last_tok"] = _at_set(s["last_tok"], slots, tok0)
    s["presence"][slots] = presence
    out_rows = torch.full((k, s["out_buf"].shape[1]), gen.pad_token_id,
                          dtype=torch.int32, device=dev)
    out_rows[:, 0] = tok0
    s["out_buf"] = _at_set(s["out_buf"], slots, out_rows)
    if "logp_buf" in s:
        lp0 = torch.log_softmax(logits.float(), dim=-1)[
            torch.arange(k, device=dev), tok0]
        lrows = torch.zeros((k, s["logp_buf"].shape[1]), dtype=torch.float32,
                            device=dev)
        lrows[:, 0] = lp0
        s["logp_buf"] = _at_set(s["logp_buf"], slots, lrows)
    s["out_len"] = _at_set(s["out_len"], slots, 1)
    s["cap"] = _at_set(s["cap"], slots, caps)
    s["samp_greedy"] = _at_set(s["samp_greedy"], slots, samp["greedy"])
    s["samp_temp"] = _at_set(s["samp_temp"], slots, samp["temperature"])
    s["samp_top_k"] = _at_set(s["samp_top_k"], slots, samp["top_k"])
    s["samp_top_p"] = _at_set(s["samp_top_p"], slots, samp["top_p"])
    s["samp_pen"] = _at_set(s["samp_pen"], slots,
                            samp["repetition_penalty"])
    if "adapter_id" in s:
        s["adapter_id"] = _at_set(s["adapter_id"], slots, samp["adapter"])
    done0 = (tok0 == gen.eos_token_id) | (caps <= 1)
    s["active"] = _at_set(s["active"], slots, ~done0)
    s["finished"] = _at_set(s["finished"], slots, done0)
    return s


def _decode_impl(params, state, generator, *, cfg: FusionConfig,
                 gen: GenerationConfig, prompt_cols: int, ring_cols: int):
    tcfg = cfg.text
    s = dict(state)
    emb = qwen3.embed_tokens(params["text"], s["last_tok"][:, None])
    # every slot writes the SAME ring column this tick (one slice store);
    # the column becomes attendable only for active slots, and any stale
    # bit there is cleared for the rest. ``head`` is a host integer.
    col = prompt_cols + s["head"] % ring_cols
    s["valid"][:, col] = s["active"].to(torch.int32)
    cache_in = {"kv": s["cache"]}
    if "kv_scale" in s:
        cache_in["kv_scale"] = s["kv_scale"]
    bank = params.get("lora_bank")
    hidden, _ = qwen3.forward_hidden(
        params["text"], tcfg, inputs_embeds=emb, attention_mask=s["valid"],
        positions=s["n_real"][:, None], cache=cache_in,
        cache_index=col, causal=False, lora=bank,
        lora_slots=s.get("adapter_id") if bank is not None else None)
    s["head"] = s["head"] + 1
    return _advance_slots(params, s, hidden, generator, cfg=cfg, gen=gen)


def _advance_slots(params, s, hidden, generator, *, cfg: FusionConfig,
                   gen: GenerationConfig):
    """Post-attention half of a decode step, shared by the dense-ring and
    paged engines: sample next tokens for active slots, advance output
    buffers / presence sets / lengths, flip EOS- or cap-terminated slots
    to finished."""
    active = s["active"]
    rows = torch.arange(active.shape[0], device=active.device)
    logits = qwen3.logits_from_hidden(params["text"], cfg.text,
                                      hidden[:, 0])
    nxt = sample_tokens_rowwise(logits, generator, _samp_from_state(s),
                                s["presence"], max_top_k=gen.top_k)
    nxt = torch.where(active, nxt, gen.pad_token_id)
    safe = torch.clamp(s["out_len"], max=s["out_buf"].shape[1] - 1)
    s["out_buf"] = _at_set(
        s["out_buf"], (rows, safe),
        torch.where(active, nxt.to(torch.int32), s["out_buf"][rows, safe]))
    if "logp_buf" in s:
        # chosen-token logprob under the RAW model distribution (before
        # penalty/temperature: the model's own confidence, not the
        # sampler's)
        lp = torch.log_softmax(logits.float(), dim=-1)[rows, nxt]
        s["logp_buf"] = _at_set(
            s["logp_buf"], (rows, safe),
            torch.where(active, lp, s["logp_buf"][rows, safe]))
    s["presence"][rows, nxt] = s["presence"][rows, nxt] | active
    s["out_len"] = s["out_len"] + active
    s["n_real"] = s["n_real"] + active
    s["last_tok"] = torch.where(active, nxt, s["last_tok"])
    newly_done = active & (
        (nxt == gen.eos_token_id) | (s["out_len"] >= s["cap"]))
    s["active"] = active & ~newly_done
    s["finished"] = s["finished"] | newly_done
    return s


@torch.no_grad()
def _prefill_decode_impl(params, hot, cold, batch, slots, caps, samp,
                         generator, kv_pre, stop_free, *, prefill, step,
                         n_steps, clock=None):
    """Admission group prefill + decode chunk as one dispatch: the
    scheduler's steady state is admit-then-decode every round.

    ``prefill``/``step`` are the engine's bound impls (dense-ring here,
    page-pool variants in inference/paged.py — the scheduler, chunk loop
    and dispatch fusion are layout-agnostic)."""
    hot, cold = prefill(params, hot, cold, batch, slots, caps, samp,
                        generator, kv_pre)
    return _decode_chunk_impl(params, hot, cold, generator, stop_free,
                              step=step, n_steps=n_steps, clock=clock)


@torch.no_grad()
def _decode_chunk_impl(params, hot, cold, generator, stop_free, *, step,
                       n_steps, clock=None):
    """Up to n_steps decode steps in one dispatch, with an early exit when
    every slot finishes.

    ``stop_free`` arms a second early exit: the chunk also ends once
    >= stop_free slots sit finished-but-unharvested, so freed slots stop
    burning idle ticks the moment a backfill-worthy group has accumulated —
    the scheduler admits next round instead of the slots waiting out the
    chunk. 0 disables it (drain mode: no queue to admit). A slot hitting its
    cap or EOS sets ``finished``, so chunks adapt to the min remaining cap
    in the pool without the host predicting it.

    The condition is the JAX ``while_loop``'s; it is read on the host, one
    fetch of one packed value per step, so rounds and dispatch counts equal
    the JAX engine's."""
    state = {**hot, **cold}
    i = 0
    while i < n_steps:
        any_active, n_finished = torch.stack(
            [state["active"].any().long(),
             state["finished"].sum()]).tolist()
        if not any_active or (stop_free > 0 and n_finished >= stop_free):
            break
        state = step(params, state, generator)
        i += 1
    _mark(clock, "decode_s")
    return _split_state(state)


@torch.no_grad()
def _prefix_kv(params, cfg: FusionConfig, prefix_ids: torch.Tensor):
    """KV [L, 1, Nkv, S, 2Dh] of the shared prompt prefix [1, S]."""
    tcfg = cfg.text
    S = prefix_ids.shape[1]
    dev = prefix_ids.device
    cache = qwen3.init_cache(tcfg, 1, S, device=dev)
    emb = qwen3.embed_tokens(params["text"], prefix_ids)
    _, cache = qwen3.forward_hidden(
        params["text"], tcfg, inputs_embeds=emb,
        attention_mask=torch.ones((1, S), dtype=torch.int32, device=dev),
        positions=torch.arange(S, device=dev)[None, :], cache=cache,
        cache_index=0)
    return cache["kv"]


class ServingEngine:
    """In-flight batching over a fixed slot pool.

    Usage::

        eng = ServingEngine(params, cfg, gen, n_slots=8, max_len=512)
        results = eng.run([Request(uid=i, batch=b) for i, b in ...])
        # results: {uid: np.ndarray of generated tokens (EOS included)}

    The engine runs on the device of ``params["text"]["embed"]``.
    """

    def __init__(self, params: Dict[str, Any], cfg: FusionConfig,
                 gen: GenerationConfig, *, n_slots: int = 8,
                 max_len: int = 1024,
                 prefill_buckets=(64, 128, 256, 512, 1024),
                 decode_chunk: int = 1,
                 admit_batch: int = 8,
                 kv_quant: Optional[str] = None,
                 prefix_ids=None,
                 stream_cb=None,
                 logprobs: bool = False,
                 lora_bank: Optional[Dict[str, Any]] = None,
                 generator: Optional[torch.Generator] = None,
                 time_phases: bool = False):
        """prefix_ids: token ids of a prompt prefix shared by EVERY request
        (the fixed system prompt, which the dataset pre-encodes). Its KV is
        computed once and copied into each slot at admission; requests then
        prefill only their suffix. Buckets bound SUFFIX lengths.

        stream_cb(uid, tokens_so_far): incremental delivery — called once
        per scheduler round for every request whose generation advanced,
        with the full prefix of tokens generated so far (np.int32). Tokens
        lag by up to one decode chunk (the scheduler runs on a one-chunk-
        stale snapshot); delivery costs one extra host fetch per round.

        lora_bank: stacked multi-LoRA adapters (lora.stack_adapters) —
        each request picks its adapter via Request.adapter (0 = base).
        Works on both the unfused and the fused/int8 decode weights
        (per-target deltas land on column slices of the fused projections,
        models.lora.apply_lora_fused). Mutually exclusive with
        shared-prefix caching (the prefix KV would differ per adapter).

        generator: the stream of every categorical draw, on the engine's
        device (default: a fresh one seeded 0).

        time_phases: accumulate ``prefill_s``, ``decode_s`` and ``host_s``
        (the scheduler's own time between dispatches) in ``stats``; this
        synchronizes the device at every mark."""
        assert params.get("lora") is None, "merge LoRA adapters first"
        if lora_bank is not None:
            assert prefix_ids is None, (
                "shared-prefix caching is per-adapter under multi-LoRA "
                "— not supported; pass prefix_ids=None")
            params = {**params, "lora_bank": lora_bank}
        self._n_adapters = (
            0 if lora_bank is None else
            next(iter(lora_bank["layers"].values()))["a"].shape[1])
        self.params = params
        self.cfg = cfg
        self.gen = gen
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = params["text"]["embed"].device
        # early-exit threshold: a decode chunk ends once this many slots
        # sit finished while requests are queued (backfill group size)
        self.admit_batch = max(1, min(admit_batch, n_slots))
        tcfg = cfg.text
        if prefix_ids is not None:
            self.prefix_ids = np.asarray(prefix_ids,
                                         np.int32).reshape(-1)
            self.s_pre = int(self.prefix_ids.size)
            self._kv_pre = _prefix_kv(
                params, cfg, torch.as_tensor(
                    self.prefix_ids, dtype=torch.long,
                    device=self.device)[None])
        else:
            self.prefix_ids = None
            self.s_pre = 0
            self._kv_pre = torch.zeros(
                (tcfg.num_hidden_layers, 1, tcfg.num_key_value_heads, 0,
                 2 * tcfg.head_dim), dtype=qwen3.torch_dtype(tcfg.dtype),
                device=self.device)
        self.buckets = tuple(sorted(b for b in prefill_buckets
                                    if b + self.s_pre < max_len))
        assert self.buckets, (prefill_buckets, max_len)
        self.prompt_cols = self.s_pre + self.buckets[-1]
        self.ring_cols = max_len - self.prompt_cols
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self._pad_side = "left"
        # scheduler-overhead accounting
        self.stats = {"rounds": 0, "decode_dispatches": 0,
                      "fused_dispatches": 0,
                      "prefill_dispatches": 0, "prefill_rows": 0,
                      "fetch_wait_s": 0.0}
        self._clock = (profiling.phase_marks(self.stats, self.device)
                       if time_phases else None)
        self._build_dispatch_fns(decode_chunk)
        # plain values, not a bound method: the engine must not refer to
        # itself, or its pools would wait for a garbage collection
        self._state_kw = dict(kv_quant=kv_quant, logprobs=logprobs,
                              multi_lora=lora_bank is not None)
        self.hot, self.cold = _split_state(
            self._make_state(**self._state_kw))
        self._slot_uid: List[Any] = [None] * n_slots
        self._pending: List[Request] = []
        self._cancel: set = set()
        self._results: Dict[Any, np.ndarray] = {}
        self._logps: Dict[Any, Any] = {}
        self._stale = None        # last host-known (active, finished,
        self._stale_cold = None   # out_len) + the cold dict they came from
        self._stale_skip = frozenset()  # slots newer than the snapshot
        self._round_admitted: List[int] = []
        self._stream_cb = stream_cb
        self._streamed = [0] * n_slots  # tokens delivered per slot

    def _build_dispatch_fns(self, decode_chunk: int) -> None:
        """Bind the engine's three dispatches. The paged engine overrides
        this with page-pool variants."""
        cfg, gen = self.cfg, self.gen
        self._prefill_insert = partial(_prefill_insert_impl, cfg=cfg,
                                       gen=gen, s_pre=self.s_pre,
                                       clock=self._clock)
        step = partial(_decode_impl, cfg=cfg, gen=gen,
                       prompt_cols=self.prompt_cols,
                       ring_cols=self.ring_cols)
        self._decode = partial(_decode_chunk_impl, step=step,
                               n_steps=decode_chunk, clock=self._clock)
        self._prefill_decode = partial(
            _prefill_decode_impl, prefill=self._prefill_insert, step=step,
            n_steps=decode_chunk, clock=self._clock)

    def _common_state(self, logprobs: bool, multi_lora: bool):
        """Layout-independent slot state (sampler rows, output buffers,
        flags) — the KV storage itself comes from _make_state."""
        B, T = self.n_slots, self.gen.max_new_tokens
        gen, tcfg, dev = self.gen, self.cfg.text, self.device

        def full(value, dtype):
            return torch.full((B,), value, dtype=dtype, device=dev)

        return {
            "n_real": full(0, torch.long),  # non-pad tokens held
            "last_tok": full(0, torch.long),
            "presence": torch.zeros((B, tcfg.vocab_size), dtype=torch.bool,
                                    device=dev),
            "out_buf": torch.full((B, T), gen.pad_token_id,
                                  dtype=torch.int32, device=dev),
            **({"logp_buf": torch.zeros((B, T), dtype=torch.float32,
                                        device=dev)} if logprobs else {}),
            "out_len": full(0, torch.long),
            "cap": full(T, torch.long),
            "active": full(False, torch.bool),
            "finished": full(False, torch.bool),
            # per-slot sampling params (cold [B] rows, written at
            # admission) — one decode step serves any mix
            "samp_greedy": full(not gen.do_sample, torch.bool),
            "samp_temp": full(gen.temperature, torch.float32),
            "samp_top_k": full(max(gen.top_k, 1), torch.long),
            "samp_top_p": full(gen.top_p, torch.float32),
            "samp_pen": full(gen.repetition_penalty, torch.float32),
            **({"adapter_id": full(0, torch.long)} if multi_lora else {}),
        }

    def _make_state(self, *, kv_quant, logprobs, multi_lora):
        B = self.n_slots
        c = qwen3.init_cache(self.cfg.text, B, self.max_len,
                             device=self.device, quant=kv_quant)
        return {
            "cache": c["kv"],
            **({"kv_scale": c["kv_scale"]} if "kv_scale" in c else {}),
            "valid": torch.zeros((B, self.max_len), dtype=torch.int32,
                                 device=self.device),
            "head": 0,                             # global ring tick (host)
            **self._common_state(logprobs, multi_lora),
        }

    def _group_sizes(self, group_sizes):
        return group_sizes or [1 << i
                               for i in range(self.n_slots.bit_length())
                               if (1 << i) <= self.n_slots]

    def _reset_after_warmup(self) -> None:
        self.hot, self.cold = _split_state(
            self._make_state(**self._state_kw))
        self._slot_uid = [None] * self.n_slots
        self._cancel = set()
        self._streamed = [0] * self.n_slots
        self._stale = None
        self._stale_cold = None
        self._stale_skip = frozenset()
        self._round_admitted = []

    def _dummy_batch(self, k: int, b: int):
        dev = self.device
        return {"input_ids": torch.ones((k, b), dtype=torch.long, device=dev),
                "attention_mask": torch.ones((k, b), dtype=torch.int32,
                                             device=dev)}

    def precompile(self, group_sizes=None, with_decode: bool = True):
        """Warm-up: run every (bucket, group-size) fused prefill+decode
        variant this engine's steady state dispatches (admission groups are
        rounded to powers of two) plus the decode-only dispatch on dummy
        text-only work, so that a timed run meets no first-use cost (kernel
        builds, Triton compiles, allocator growth), then reset the state —
        call BEFORE submitting real requests. Nothing is compiled ahead of
        time here; the name is the JAX engine's."""
        dev = self.device
        for b in self.buckets:
            for k in self._group_sizes(group_sizes):
                slots = torch.arange(k, device=dev) % self.n_slots
                caps = torch.full((k,), 2, dtype=torch.long, device=dev)
                samp = self._samp_arrays([Request(uid=None, batch={})
                                          for _ in range(k)])
                self.hot, self.cold = self._prefill_decode(
                    self.params, self.hot, self.cold,
                    self._dummy_batch(k, b), slots, caps, samp,
                    self.generator, self._kv_pre, 1)
        if with_decode:
            for stop in (0, 1):
                self.hot, self.cold = self._decode(
                    self.params, self.hot, self.cold, self.generator, stop)
        self._reset_after_warmup()

    # ---- scheduler ----------------------------------------------------

    def _bucket_group_cap(self, bucket: int) -> int:
        """Max admission-group size for ``bucket`` (layout hook; the paged
        engine returns 1 for its continuation bucket)."""
        return self.n_slots

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket "
                         f"{self.buckets[-1]}")

    def _strip_prefix(self, batch):
        """Remove left padding + the shared prefix from a single-sample
        batch; shift omics segment positions to suffix coordinates."""
        ids = np.asarray(batch["input_ids"])[0]
        mask = np.asarray(batch.get("attention_mask",
                                    np.ones_like(ids)))[0]
        start = int(np.argmax(mask)) if mask.any() else len(ids)
        content = ids[start:]
        if not np.array_equal(content[:self.s_pre], self.prefix_ids):
            raise ValueError(
                "request prompt does not start with the configured "
                "prefix_ids — disable prefix caching for this request mix")
        shift = start + self.s_pre
        out = dict(batch)
        out["input_ids"] = content[None, self.s_pre:]
        out["attention_mask"] = np.ones((1, content.size - self.s_pre),
                                        np.int32)
        for key in ("dna_rna_pos", "protein_pos"):
            if key in batch:
                pos = np.asarray(batch[key])
                shifted = np.where(pos >= 0, pos - shift, pos)
                if (shifted[pos >= 0] < 0).any():
                    raise ValueError("omics segment inside the shared "
                                     "prefix is not supported")
                out[key] = shifted
        return out

    def _eff_batch(self, req: Request):
        return (self._strip_prefix(req.batch) if self.s_pre
                else req.batch)

    def _eff_len(self, req: Request) -> int:
        if self.s_pre:
            mask = np.asarray(req.batch.get(
                "attention_mask",
                np.ones_like(np.asarray(req.batch["input_ids"]))))
            return int(mask.sum()) - self.s_pre
        return np.asarray(req.batch["input_ids"]).shape[1]

    def _fetch_status(self, cold):
        """(active, finished, out_len) of ``cold`` as numpy rows, in ONE
        transfer."""
        packed = torch.stack([cold["active"].long(), cold["finished"].long(),
                              cold["out_len"]]).cpu().numpy()
        return packed[0].astype(bool), packed[1].astype(bool), packed[2]

    def _refresh_status(self, cold) -> None:
        """ONE host sync for everything the scheduler needs. ``cold`` rows
        are never written in place, so a PRE-dispatch snapshot stays what
        it was while later chunks run.

        Slots admitted THIS round (after ``cold`` was produced) are
        recorded as skip-slots for the snapshot: their stale rows still
        describe the slot's previous occupant, so streaming or harvesting
        them would hand the new request the old request's tokens."""
        t0 = time.perf_counter()
        self._stale = self._fetch_status(cold)
        self.stats["fetch_wait_s"] += time.perf_counter() - t0
        self._stale_cold = cold
        self._stale_skip = frozenset(self._round_admitted)

    def _assemble(self, reqs: List[Request], slots: List[int]):
        """Pad + stack k same-bucket requests into device tensors."""
        dev = self.device
        batches = [self._eff_batch(r) for r in reqs]
        bucket = self._bucket_for(
            np.asarray(batches[0]["input_ids"]).shape[1])
        padded = [_pad_to_bucket(b, bucket, self.gen.pad_token_id,
                                 self._pad_side)
                  for b in batches]
        keys = set().union(*(p.keys() for p in padded))
        jb = {}
        for key in keys:
            fill = {"dna_rna_pos": -1, "protein_pos": -1}.get(key, 1)
            rows = []
            for p in padded:
                if key in p:
                    rows.append(np.asarray(p[key]))
                else:  # mixed omics layouts in one group: neutral segment
                    ref = next(np.asarray(q[key]) for q in padded
                               if key in q)
                    rows.append(np.full_like(ref, fill))
            jb[key] = torch.as_tensor(np.concatenate(rows, axis=0),
                                      device=dev)
        # a request's generated span is contiguous in ring ticks, so
        # cap <= ring_cols guarantees it never wraps onto its own history
        caps = [max(1, min(r.max_new_tokens or self.gen.max_new_tokens,
                           self.gen.max_new_tokens, self.ring_cols))
                for r in reqs]
        return (jb, torch.as_tensor(slots, dtype=torch.long, device=dev),
                torch.as_tensor(caps, dtype=torch.long, device=dev),
                self._samp_arrays(reqs))

    def _samp_arrays(self, reqs: List[Request]) -> Dict[str, torch.Tensor]:
        """Per-request sampling params -> [k] device tensors (unset keys
        inherit the engine GenerationConfig; temperature <= 0 = greedy;
        top_k clamps to the candidate width)."""
        g = self.gen
        rows = {"greedy": [], "temperature": [], "top_k": [], "top_p": [],
                "repetition_penalty": [], "adapter": []}
        for r in reqs:
            s = r.sampling or {}
            temp = float(s.get("temperature", g.temperature))
            greedy = bool(s.get("greedy", not g.do_sample)) or temp <= 0.0
            top_k = int(s.get("top_k", g.top_k))
            if g.top_k:
                top_k = min(max(top_k, 1), g.top_k)
            if self._n_adapters:
                assert 0 <= r.adapter < self._n_adapters, (
                    r.adapter, self._n_adapters)
            rows["greedy"].append(greedy)
            rows["temperature"].append(max(temp, 1e-6))
            rows["top_k"].append(top_k)
            rows["top_p"].append(float(s.get("top_p", g.top_p)))
            rows["repetition_penalty"].append(
                float(s.get("repetition_penalty", g.repetition_penalty)))
            rows["adapter"].append(int(r.adapter))
        dtypes = {"greedy": torch.bool, "top_k": torch.long,
                  "adapter": torch.long}
        return {k: torch.as_tensor(v, dtype=dtypes.get(k, torch.float32),
                                   device=self.device)
                for k, v in rows.items()}

    def _bind_slots(self, reqs: List[Request], slots: List[int]) -> None:
        for r, slot in zip(reqs, slots):
            self._slot_uid[slot] = r.uid
            self._streamed[slot] = 0
        self._round_admitted.extend(slots)

    def _prefill_extra(self, slots: List[int]):
        """The last argument of a prefill dispatch: the shared prefix KV
        here, the group's page-table rows in the paged engine."""
        return self._kv_pre

    def _start_group(self, reqs: List[Request], slots: List[int]) -> None:
        """Admit k same-bucket requests in one prefill-only dispatch
        (used for all but the last group of a multi-group round; the last
        group rides the decode dispatch via _start_group_fused)."""
        jb, slots_arr, caps, samp = self._assemble(reqs, slots)
        _mark(self._clock, "host_s")
        self.hot, self.cold = self._prefill_insert(
            self.params, self.hot, self.cold, jb, slots_arr, caps, samp,
            self.generator, self._prefill_extra(slots))
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_rows"] += len(reqs)
        self._bind_slots(reqs, slots)

    def _start_group_fused(self, reqs: List[Request], slots: List[int],
                           stop_free: int) -> None:
        """Admit a group AND run the round's decode chunk in ONE dispatch
        — the steady-state round is admit-then-decode."""
        jb, slots_arr, caps, samp = self._assemble(reqs, slots)
        _mark(self._clock, "host_s")
        self.hot, self.cold = self._prefill_decode(
            self.params, self.hot, self.cold, jb, slots_arr, caps, samp,
            self.generator, self._prefill_extra(slots), stop_free)
        self.stats["fused_dispatches"] += 1
        self.stats["prefill_rows"] += len(reqs)
        self._bind_slots(reqs, slots)

    def _stream(self, olen, cold_src) -> None:
        """Incremental delivery: hand each advanced request its generated
        prefix (one batched row fetch for all advanced slots)."""
        if self._stream_cb is None:
            return
        idxs = [i for i in range(self.n_slots)
                if self._slot_uid[i] is not None
                and i not in self._stale_skip
                and int(olen[i]) > self._streamed[i]]
        if not idxs:
            return
        rows = cold_src["out_buf"][idxs].cpu().numpy()
        for j, i in enumerate(idxs):
            n = int(olen[i])
            self._stream_cb(self._slot_uid[i], rows[j, :n])
            self._streamed[i] = n

    def _collect(self, fin, olen, cold_src) -> List[int]:
        """Harvest finished slots from a (possibly stale) cold snapshot —
        a finished slot's out_buf row is final, so stale is safe. Rows are
        sliced on the device and fetched lazily (materialized at run()
        end), not with a blocking host fetch per completion round."""
        idxs = [i for i in range(self.n_slots)
                if fin[i] and self._slot_uid[i] is not None
                and i not in self._stale_skip]
        if not idxs:
            return []
        rows = cold_src["out_buf"][idxs]
        lrows = (cold_src["logp_buf"][idxs]
                 if "logp_buf" in cold_src else None)
        if self._stream_cb is not None:
            rows = rows.cpu().numpy()  # deliver final prefixes eagerly
            for j, i in enumerate(idxs):
                n = int(olen[i])
                if n > self._streamed[i]:
                    self._stream_cb(self._slot_uid[i], rows[j, :n])
                    self._streamed[i] = n
        for j, i in enumerate(idxs):
            self._results[self._slot_uid[i]] = (rows, j, int(olen[i]))
            if lrows is not None:
                self._logps[self._slot_uid[i]] = (lrows, j, int(olen[i]))
            self._slot_uid[i] = None
        self.cold["finished"] = _at_set(self.cold["finished"], idxs, False)
        return idxs

    def _materialize(self) -> Dict[Any, np.ndarray]:
        out = {}
        for uid, v in self._results.items():
            if isinstance(v, tuple):
                rows, j, n = v
                if isinstance(rows, torch.Tensor):
                    rows = rows.cpu().numpy()
                v = rows[j, :n]
                self._results[uid] = v
            out[uid] = v
        return out

    def _before_decode_dispatch(self, groups):
        """Hook called once per scheduling round, after admission groups
        are formed but before anything dispatches. May mutate engine state
        (e.g. page allocation) and return a filtered group list."""
        return groups

    def submit(self, req: Request) -> None:
        self._pending.append(req)

    def pop_logprobs(self, uid: Any) -> Optional[np.ndarray]:
        """Chosen-token logprobs for a harvested request (engine built
        with logprobs=True), aligned with its result tokens."""
        v = self._logps.pop(uid, None)
        if v is None:
            return None
        lrows, j, n = v
        return lrows.cpu().numpy()[j, :n]

    def cancel(self, uid: Any) -> None:
        """Best-effort cancellation (client disconnect, stop-sequence hit):
        a queued request is dropped with an empty result; an in-flight one
        is force-finished at the next scheduling round and its PARTIAL
        output is harvested as the result. A chunk already running may
        decode a few more tokens first — callers truncate."""
        for i, r in enumerate(self._pending):
            if r.uid == uid:
                del self._pending[i]
                self._results[uid] = np.zeros((0,), np.int32)
                return
        self._cancel.add(uid)

    def _apply_cancels(self) -> None:
        slots = [i for i in range(self.n_slots)
                 if self._slot_uid[i] in self._cancel]
        if not slots:
            return
        self.cold["active"] = _at_set(self.cold["active"], slots, False)
        self.cold["finished"] = _at_set(self.cold["finished"], slots, True)
        self._cancel -= {self._slot_uid[i] for i in slots}

    def step(self) -> bool:
        """One scheduling round: harvest completions and admit using the
        last host-known status (one chunk stale), dispatch the next decode
        chunk, then fetch the pre-dispatch status. Returns False when idle
        (nothing pending or active)."""
        self.stats["rounds"] += 1
        self._round_admitted = []
        self._apply_cancels()
        if self._stale is None:
            self._refresh_status(self.cold)
        act, fin, olen = self._stale
        self._stream(olen, self._stale_cold)
        self._collect(fin, olen, self._stale_cold)
        free = [i for i in range(self.n_slots)
                if self._slot_uid[i] is None]
        groups = []
        while self._pending and free:
            # group same-bucket pending requests; group size rounded down
            # to a power of two, as the JAX engine bounds its variants
            bucket = self._bucket_for(self._eff_len(self._pending[0]))
            idxs = [i for i, r in enumerate(self._pending)
                    if self._bucket_for(self._eff_len(r)) == bucket
                    ][:len(free)]
            k = 1 << (len(idxs).bit_length() - 1)
            # layout hook: the paged engine caps its continuation-bucket
            # groups at 1
            k = min(k, self._bucket_group_cap(bucket))
            # a trailing group smaller than the backfill quantum isn't
            # worth a dispatch — leave those slots free for next round's
            # single group
            if groups and k < self.admit_batch:
                break
            group = [self._pending[i] for i in idxs[:k]]
            for i in reversed(idxs[:k]):
                del self._pending[i]
            groups.append((group, [free.pop(0) for _ in group]))
        if groups or bool(np.any(act)):
            # the snapshot the NEXT round schedules from. Cold rows are
            # replaced, never written in place, so this stays a true
            # snapshot; item assignments to this same dict below (page
            # table, stall flags) are part of it, as in the JAX engine.
            prev_cold = self.cold
            # layout hook: the paged engine grows page chains for active
            # slots (and preempts on pool exhaustion) BEFORE the round's
            # decode chunk dispatches; no-op for the dense ring
            groups = self._before_decode_dispatch(groups)
            # arm the early exit while a backfill group's worth of work is
            # queued; drain at full chunk length otherwise
            stop_free = (min(len(self._pending), self.admit_batch)
                         if self._pending else 0)
            for g, s in groups[:-1]:
                self._start_group(g, s)
            if groups:
                # the round's decode chunk rides the admission dispatch
                self._start_group_fused(*groups[-1], stop_free)
            else:
                _mark(self._clock, "host_s")
                self.hot, self.cold = self._decode(
                    self.params, self.hot, self.cold, self.generator,
                    stop_free)
                self.stats["decode_dispatches"] += 1
            # NOTE the snapshot predates this round's admissions, so newly
            # admitted slots read inactive next round — the idle-confirm
            # fallback below re-fetches true state before declaring done.
            self._refresh_status(prev_cold)
            return True
        # stale status says idle — confirm against the true current state
        self._refresh_status(self.cold)
        act2, fin2, _ = self._stale
        if bool(np.any(act2)) or any(
                fin2[i] and self._slot_uid[i] is not None
                for i in range(self.n_slots)):
            return True
        return bool(self._pending)

    def run(self, requests: List[Request]) -> Dict[Any, np.ndarray]:
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        self._refresh_status(self.cold)
        act, fin, olen = self._stale
        self._collect(fin, olen, self.cold)
        _mark(self._clock, "host_s")
        return self._materialize()
