"""Paged-KV serving engine: vLLM-style block allocation, the counterpart of
``molly_tpu/inference/paged.py``.

The dense ring engine (inference/server.py) reserves a [prompt_cols + cap]
rectangle per slot, so a 3072-token cap costs every slot ~3072 columns of
device memory whether or not its request generates that much. This engine
stores each sequence as a chain of fixed-size KV pages allocated on demand:

  - memory scales with tokens ACTUALLY HELD, not slots x worst-case cap;
  - pages recycle the moment a request finishes (or is cancelled);
  - the pool can be OVERSUBSCRIBED (slots x cap > pool): when it runs
    dry, the youngest request is preempted — its partial generation is
    stashed host-side and the request requeues as a continuation
    (prompt + generated-so-far re-prefills later), vLLM's "recompute"
    preemption policy.

Decode attention runs through ops/paged_attention.py (the CUDA flash-decode
kernel over page tables; its plain gather version for CPU tensors).
Page layout: ONE pool [Nkv, L * n_pages + 1, page, Dh] shared by all
layers — page p of layer li lives at pool row ``li * n_pages + p`` — plus a
final scratch row that absorbs writes from inactive slots. The page table
[slots, pages_per_seq] holds LAYER-RELATIVE ids and is host-managed: the
allocator is plain Python (a free list) replacing a small int32 device
tensor between dispatches. The pools are hot state, written in place.

Scheduling, admission batching, fused prefill+decode dispatches,
streaming, cancellation, and multi-LoRA all come from ServingEngine
unchanged — this class only swaps the KV layout underneath.

Differences from the dense ring (documented semantics):
  - prompts are packed (right-padded), so per-slot positions are true
    lengths and attention masks collapse to one length scalar per slot;
  - repetition-penalty presence sets rebuild from scratch when a
    preempted request resumes (its stashed tokens count as prompt);
  - per-token logprobs of a preempted request cover only the
    continuation;
  - int8 KV pages (kv_quant="int8"): pages store int8 with one fp32
    scale per (head, page, offset) Dh row, stored once per row as
    [Nkv, rows, P] (the JAX package replicates each over 8 sublanes for
    its TPU compiler; this one does not);
  - shared-prefix caching (prefix_ids=...) shares PAGES: the prefix KV
    is computed once, scattered into floor(s_pre / page) dedicated pages,
    and every slot's page table points at those same rows — the dense
    ring copies the prefix KV into every slot, the paged engine stores
    it ONCE. The sub-page remainder of the prefix rides each request's
    suffix (page-aligned sharing only); decode never writes shared pages
    (writes start at s_pre + suffix).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import qwen3
from ..models.configs import FusionConfig, GenerationConfig
from .server import (Request, ServingEngine, _advance_slots, _at_set,
                     _decode_chunk_impl, _insert_request_rows, _mark,
                     _prefill_decode_impl, _prefill_forward, _split_state)

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def pages_for_budget(cfg: FusionConfig, budget_bytes: int,
                     page_size: int, kv_quant: Optional[str] = None) -> int:
    """Per-layer page count such that the K+V pools fit budget_bytes."""
    tcfg = cfg.text
    if kv_quant == "int8":  # 1 byte/elem + one fp32 scale a row
        per_row = tcfg.head_dim + 4
    else:
        per_row = tcfg.head_dim * _ITEMSIZE[tcfg.dtype]
    per_page = tcfg.num_key_value_heads * page_size * 2 * per_row
    return max(1, budget_bytes // (per_page * tcfg.num_hidden_layers))


# ---------------------------------------------------------------------------
# the dispatches' page-pool halves
# ---------------------------------------------------------------------------


def _scatter_pages(s, kv, dest, kv_quant: Optional[str]) -> None:
    """Store page-shaped KV [Nkv, L, ..., P, 2*Dh] into pool rows ``dest``
    [L, ...] (global row ids), in place, quantizing for an int8 pool one
    layer at a time (the quantizer works in fp32: a whole admission group's
    KV at once would cost several times the pool's own size in scratch)."""
    Dh = kv.shape[-1] // 2
    if kv_quant != "int8":
        s["k_pages"][:, dest] = kv[..., :Dh].to(s["k_pages"].dtype)
        s["v_pages"][:, dest] = kv[..., Dh:].to(s["v_pages"].dtype)
        return
    for li in range(kv.shape[1]):
        for half, pages, scales in ((kv[:, li, ..., :Dh], "k_pages",
                                     "k_scales"),
                                    (kv[:, li, ..., Dh:], "v_pages",
                                     "v_scales")):
            w, sc = qwen3.quantize_page_rows(half)
            s[pages][:, dest[li]] = w
            s[scales][:, dest[li]] = sc[..., 0]


@torch.no_grad()
def _paged_prefill_impl(params, hot, cold, batch, slots, caps, samp,
                        generator, table_rows, *, cfg: FusionConfig,
                        gen: GenerationConfig, page_size: int,
                        n_pages: int, kv_quant: Optional[str] = None,
                        s_pre: int = 0, clock=None):
    """Embed (with omics injection) + prefill + first-token sample + page
    scatter for a group of k same-bucket requests, one dispatch.

    batch is RIGHT-padded to the bucket (tokens packed at positions
    [0, n_real)); ``table_rows`` [k, pages_per_seq] int32 holds each
    request's layer-relative page chain, -1 beyond the allocated length
    (prompt-pad chunks there spill to the scratch row; reads never reach
    them — the kernel masks by length).

    s_pre > 0 (shared-prefix caching, page-aligned): batch["kv_pre"]
    [L, 1, Nkv, s_pre, 2Dh] seeds the prefill attention context (same as
    the dense ring's _prefill_insert_impl), the batch holds only the
    SUFFIX, and the first s_pre // page_size entries of each table row
    are the SHARED prefix pages — the suffix KV scatters only into the
    rows after them (shared pages are read-only here)."""
    s = {**hot, **cold}
    tcfg = cfg.text
    mask = batch["attention_mask"]
    k, Sb = mask.shape
    P, L = page_size, tcfg.num_hidden_layers
    assert Sb % P == 0 and s_pre % P == 0, (Sb, s_pre, P)
    n_suf = mask.sum(dim=1)
    # right-pad: the last REAL token's hidden state drives tok0 (hidden
    # covers only the suffix rows)
    kv, _, logits, tok0, presence = _prefill_forward(
        params, batch, samp, generator, batch.get("kv_pre"), cfg=cfg,
        gen=gen, s_pre=s_pre, last_index=n_suf - 1)
    # scatter the SUFFIX KV into the pool: bucket column t of request b
    # lands in global page row li*n_pages + table[b, n_shared + t // P],
    # offset t % P (shared prefix pages were written once at engine init)
    n_shared = s_pre // P
    kv = kv[:, :, :, s_pre:]                          # [L, k, Nkv, Sb, 2Dh]
    kvc = kv.reshape(L, k, tcfg.num_key_value_heads, Sb // P, P, -1)
    kvc = kvc.movedim(2, 0)                           # [Nkv, L, k, C, P, :]
    ct = table_rows[:, n_shared:n_shared + Sb // P].long()   # [k, C]
    layer0 = torch.arange(L, device=ct.device)[:, None, None] * n_pages
    dest = torch.where(ct >= 0, layer0 + ct[None], L * n_pages)  # [L, k, C]
    _scatter_pages(s, kvc, dest, kv_quant)
    # clamp -1: entries past a chain name row 0 but are never read; the
    # host tracks the real chains
    s["page_table"] = _at_set(s["page_table"], slots,
                              table_rows.clamp(min=0))
    s["n_real"] = _at_set(s["n_real"], slots, s_pre + n_suf)
    s = _insert_request_rows(s, slots, caps, samp, tok0, presence, logits,
                             gen=gen)
    _mark(clock, "prefill_s")
    return _split_state(s)


def _paged_decode_impl(params, state, generator, *, cfg: FusionConfig,
                       gen: GenerationConfig):
    """One decode step over the page pool: write each active slot's
    last-token KV at its true length (inactive slots -> scratch row),
    attend via the paged kernel, then the shared sample/advance tail."""
    tcfg = cfg.text
    s = dict(state)
    emb = qwen3.embed_tokens(params["text"], s["last_tok"][:, None])
    idx = torch.where(s["active"], s["n_real"], -1)
    lengths = torch.where(s["active"], s["n_real"] + 1, 1).clamp(min=1)
    cache_in = {"k_pages": s["k_pages"], "v_pages": s["v_pages"],
                "page_table": s["page_table"],
                "lengths": lengths.to(torch.int32)}
    if "k_scales" in s:
        cache_in["k_scales"] = s["k_scales"]
        cache_in["v_scales"] = s["v_scales"]
    bank = params.get("lora_bank")
    hidden, _ = qwen3.forward_hidden(
        params["text"], tcfg, inputs_embeds=emb,
        positions=s["n_real"][:, None], cache=cache_in, cache_index=idx,
        causal=False, lora=bank,
        lora_slots=s.get("adapter_id") if bank is not None else None)
    return _advance_slots(params, s, hidden, generator, cfg=cfg, gen=gen)


# ---------------------------------------------------------------------------
# host-side batch packing
# ---------------------------------------------------------------------------


def _pack_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip surrounding padding from a single-sample batch so tokens are
    packed at positions [0, n_real) — the paged layout's contract (the
    kernel attends positions [0, len), so interior pads would leak)."""
    ids = np.asarray(batch["input_ids"])
    mask = np.asarray(batch.get("attention_mask",
                                np.ones_like(ids, np.int32)))
    m = mask[0].astype(bool)
    if m.all():
        out = dict(batch)
        out["attention_mask"] = mask.astype(np.int32)
        return out
    nz = np.nonzero(m)[0]
    if nz.size == 0:
        raise ValueError("empty prompt")
    start, end = int(nz[0]), int(nz[-1]) + 1
    if not m[start:end].all():
        raise ValueError("interior padding is not supported by the "
                         "paged engine — pack the prompt")
    out = dict(batch)
    out["input_ids"] = ids[:, start:end]
    out["attention_mask"] = np.ones((1, end - start), np.int32)
    for key in ("dna_rna_pos", "protein_pos"):
        if key in batch:
            pos = np.asarray(batch[key])
            shifted = np.where(pos >= 0, pos - start, pos)
            if (shifted[pos >= 0] < 0).any():
                raise ValueError("omics segment outside the packed prompt")
            out[key] = shifted
    return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class PagedServingEngine(ServingEngine):
    """ServingEngine over a paged KV pool (module docstring).

    Usage::

        eng = PagedServingEngine(params, cfg, gen, n_slots=16,
                                 page_size=64, n_pages=2048)
        results = eng.run([Request(uid=i, batch=b) for i, b in ...])

    ``n_pages`` is PER LAYER; total pool memory = n_pages * page_size tokens
    * (L * Nkv * 2*Dh * dtype) bytes. ``pages_for_budget`` converts a byte
    budget. Oversubscription (n_pages * page_size <
    n_slots * (prompt + cap)) is legal — preemption kicks in.
    """

    def __init__(self, params: Dict[str, Any], cfg: FusionConfig,
                 gen: GenerationConfig, *, n_slots: int = 8,
                 page_size: int = 64,
                 n_pages: Optional[int] = None,
                 pages_per_seq: Optional[int] = None,
                 prefill_buckets=(64, 128, 256, 512, 1024),
                 decode_chunk: int = 1,
                 admit_batch: int = 8,
                 kv_quant: Optional[str] = None,
                 prefix_ids=None,
                 stream_cb=None,
                 logprobs: bool = False,
                 lora_bank: Optional[Dict[str, Any]] = None,
                 continuation_bucket: bool = True,
                 generator: Optional[torch.Generator] = None,
                 time_phases: bool = False):
        assert all(b % page_size == 0 for b in prefill_buckets), (
            "prefill buckets must be multiples of the page size",
            prefill_buckets, page_size)
        assert kv_quant in (None, "int8"), kv_quant
        self.kv_quant = kv_quant
        self.page_size = page_size
        # shared-prefix caching is PAGE-ALIGNED here: share the full
        # pages, let the sub-page remainder ride each request's suffix
        # (the dense ring strips the whole prefix instead — same outputs,
        # the remainder tokens are simply recomputed per request)
        n_shared = 0
        if prefix_ids is not None:
            prefix_ids = np.asarray(prefix_ids, np.int32).reshape(-1)
            n_shared = int(prefix_ids.size) // page_size
            prefix_ids = (prefix_ids[:n_shared * page_size]
                          if n_shared else None)
        self._n_shared = n_shared
        if pages_per_seq is None:
            pages_per_seq = n_shared + math.ceil(
                (max(prefill_buckets) + gen.max_new_tokens) / page_size)
        if n_pages is None:  # fully provisioned: no preemption possible
            # sized from the UNROUNDED per-request need — the rounding
            # below only pads the page TABLE, never real page demand
            n_pages = n_shared + n_slots * (pages_per_seq - n_shared)
        # The table width is rounded up to a multiple of 512 tokens' worth
        # of pages, as the JAX engine rounds it for its kernel's compute
        # blocks. The CUDA kernel has no such blocks, but the width is
        # kept: max_len, and with it the continuation bucket below, are
        # sized from it. Padded entries stay -1 (clamped to row 0 on the
        # device); reads never reach them.
        mult = max(1, 512 // page_size)
        pages_per_seq = -(-pages_per_seq // mult) * mult
        self.pages_per_seq = pages_per_seq
        self.n_pages = n_pages
        self._partial: Dict[Any, np.ndarray] = {}
        if stream_cb is not None:
            # the closure holds the dict, not the engine: an engine that
            # refers to itself keeps its pools until a garbage collection
            user_cb, partial_out = stream_cb, self._partial

            def stream_cb(uid, toks):  # continuation-aware delivery
                pre = partial_out.get(uid)
                user_cb(uid, toks if pre is None
                        else np.concatenate([pre, toks]))

        super().__init__(
            params, cfg, gen, n_slots=n_slots,
            max_len=pages_per_seq * page_size + 1,
            prefill_buckets=prefill_buckets, decode_chunk=decode_chunk,
            admit_batch=admit_batch, kv_quant=kv_quant,
            prefix_ids=prefix_ids,
            stream_cb=stream_cb, logprobs=logprobs, lora_bank=lora_bank,
            generator=generator, time_phases=time_phases)
        self._pad_side = "right"
        # Preempted requests re-admit as prompt+stash continuations,
        # which can outgrow every workload bucket (then nothing is
        # preemptible and an oversubscribed pool can only stall or
        # wedge). Add one page-aligned bucket big enough for ANY
        # continuation — k=1 only (_bucket_group_cap), and added AFTER
        # super().__init__ so prompt_cols/ring_cols/cap bounds keep their
        # workload-bucket values (the paged layout uses ring_cols only as
        # the per-request cap bound). It is sized from the ROUNDED
        # pages_per_seq, as in the JAX engine.
        self._cont_bucket = 0
        if continuation_bucket:
            cont = (math.ceil((pages_per_seq * page_size - self.s_pre)
                              / page_size) * page_size)
            if cont > self.buckets[-1]:
                self._cont_bucket = cont
                self.buckets = tuple(sorted(self.buckets + (cont,)))
        # host-side page allocator (layer-relative page ids)
        self._free_pages: List[int] = list(range(n_pages))
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._slot_ub = [0] * n_slots    # tokens-held bound (incl prefix)
        self._slot_max = [0] * n_slots   # prefix+prompt+cap (growth cap)
        self._slot_req: List[Optional[Request]] = [None] * n_slots
        self._slot_seq = [0] * n_slots   # admission order (preemption age)
        self._admit_seq = 0
        self._admit_tables: Dict[int, np.ndarray] = {}
        self._stalled: set = set()
        self.stats["preemptions"] = 0
        self.stats["pages_peak"] = 0
        self.stats["stalls"] = 0
        # pin the shared prefix pages (never released) + write their KV
        self._shared_pages: List[int] = []
        self._shared_pages = self._alloc(n_shared)
        self._write_prefix_pages()

    # ---- engine-layout overrides ---------------------------------------

    def _build_dispatch_fns(self, decode_chunk: int) -> None:
        self.decode_chunk = decode_chunk
        cfg, gen = self.cfg, self.gen
        self._prefill_insert = partial(
            _paged_prefill_impl, cfg=cfg, gen=gen, page_size=self.page_size,
            n_pages=self.n_pages, kv_quant=self.kv_quant, s_pre=self.s_pre,
            clock=self._clock)
        step = partial(_paged_decode_impl, cfg=cfg, gen=gen)
        self._decode = partial(_decode_chunk_impl, step=step,
                               n_steps=decode_chunk, clock=self._clock)
        self._prefill_decode = partial(
            _prefill_decode_impl, prefill=self._prefill_insert, step=step,
            n_steps=decode_chunk, clock=self._clock)

    @torch.no_grad()
    def _write_prefix_pages(self) -> None:
        """Scatter the precomputed prefix KV (base _kv_pre) into the
        pinned shared pages — once at init and again after precompile()
        resets the pools."""
        if not self.s_pre:
            return
        tcfg = self.cfg.text
        P, C = self.page_size, self._n_shared
        L = tcfg.num_hidden_layers
        kv = self._kv_pre  # [L, 1, Nkv, s_pre, 2Dh]
        kvc = kv[:, 0].reshape(L, tcfg.num_key_value_heads, C, P, -1)
        kvc = kvc.movedim(1, 0)                       # [Nkv, L, C, P, :]
        shared = torch.as_tensor(self._shared_pages, dtype=torch.long,
                                 device=self.device)
        dest = (torch.arange(L, device=self.device)[:, None] * self.n_pages
                + shared[None])
        _scatter_pages(self.hot, kvc, dest, self.kv_quant)

    def _make_state(self, *, kv_quant, logprobs, multi_lora):
        tcfg = self.cfg.text
        B, dev = self.n_slots, self.device
        pool_rows = tcfg.num_hidden_layers * self.n_pages + 1  # + scratch
        shape = (tcfg.num_key_value_heads, pool_rows, self.page_size,
                 tcfg.head_dim)
        dt = (torch.int8 if kv_quant == "int8"
              else qwen3.torch_dtype(tcfg.dtype))
        state = {
            "k_pages": torch.zeros(shape, dtype=dt, device=dev),
            "v_pages": torch.zeros(shape, dtype=dt, device=dev),
            "page_table": torch.zeros((B, self.pages_per_seq),
                                      dtype=torch.int32, device=dev),
            **self._common_state(logprobs, multi_lora),
        }
        if kv_quant == "int8":
            # per-(head, page, offset) row scales, one fp32 each
            state["k_scales"] = torch.zeros(shape[:3], dtype=torch.float32,
                                            device=dev)
            state["v_scales"] = torch.zeros(shape[:3], dtype=torch.float32,
                                            device=dev)
        return state

    def precompile(self, group_sizes=None, with_decode: bool = True):
        """Warm-up of the (bucket, group-size) fused variants + decode.
        Dummy admissions use all -1 page chains: every write lands on the
        scratch row, so no allocator interaction and no pool pollution."""
        dev = self.device
        dummy = torch.full((1, self.pages_per_seq), -1, dtype=torch.int32,
                           device=dev)
        for b in self.buckets:
            if b == self._cont_bucket:
                continue  # continuation prefill: rare, k=1, met on demand
            for k in self._group_sizes(group_sizes):
                batch = self._dummy_batch(k, b)
                if self.s_pre:
                    batch["kv_pre"] = self._kv_pre
                slots = torch.arange(k, device=dev) % self.n_slots
                caps = torch.full((k,), 2, dtype=torch.long, device=dev)
                samp = self._samp_arrays([Request(uid=None, batch={})
                                          for _ in range(k)])
                self.hot, self.cold = self._prefill_decode(
                    self.params, self.hot, self.cold, batch, slots, caps,
                    samp, self.generator, dummy.repeat(k, 1), 1)
        if with_decode:
            for stop in (0, 1):
                self.hot, self.cold = self._decode(
                    self.params, self.hot, self.cold, self.generator, stop)
        self._reset_after_warmup()
        self._write_prefix_pages()

    def _bucket_group_cap(self, bucket: int) -> int:
        return 1 if bucket == self._cont_bucket else self.n_slots

    def _eff_batch(self, req: Request):
        b = _pack_batch(req.batch)
        if not self.s_pre:
            return b
        ids = np.asarray(b["input_ids"])[0]
        if not np.array_equal(ids[:self.s_pre], self.prefix_ids):
            raise ValueError(
                "request prompt does not start with the configured "
                "prefix_ids — disable prefix caching for this request mix")
        if ids.size <= self.s_pre:
            raise ValueError("prompt must extend beyond the shared prefix")
        out = dict(b)
        out["input_ids"] = ids[None, self.s_pre:]
        out["attention_mask"] = np.ones((1, ids.size - self.s_pre),
                                        np.int32)
        for key in ("dna_rna_pos", "protein_pos"):
            if key in b:
                pos = np.asarray(b[key])
                shifted = np.where(pos >= 0, pos - self.s_pre, pos)
                if (shifted[pos >= 0] < 0).any():
                    raise ValueError("omics segment inside the shared "
                                     "prefix is not supported")
                out[key] = shifted
        return out

    def _eff_len(self, req: Request) -> int:
        ids = np.asarray(req.batch["input_ids"])
        mask = req.batch.get("attention_mask")
        n = (int(np.asarray(mask).sum()) if mask is not None
             else ids.shape[1])
        return n - self.s_pre  # suffix length (buckets bound suffixes)

    def _assemble(self, reqs: List[Request], slots: List[int]):
        jb, slots_arr, caps, samp = super()._assemble(reqs, slots)
        if self.s_pre:
            jb["kv_pre"] = self._kv_pre
        return jb, slots_arr, caps, samp

    def _prefill_extra(self, slots: List[int]) -> torch.Tensor:
        """The group's page-table rows [k, pages_per_seq]."""
        return torch.as_tensor(
            np.stack([self._admit_tables.pop(s) for s in slots]),
            device=self.device)

    # ---- page accounting ------------------------------------------------

    def _cap_for(self, req: Request) -> int:
        return max(1, min(req.max_new_tokens or self.gen.max_new_tokens,
                          self.gen.max_new_tokens, self.ring_cols))

    def _alloc(self, n: int) -> Optional[List[int]]:
        if n == 0:
            return []  # NB: lst[-0:] is the WHOLE list — never slice by -0
        if len(self._free_pages) < n:
            return None
        out = self._free_pages[-n:]
        del self._free_pages[-n:]
        # the page writer relies on no two slots sharing a writable page:
        # a page leaves the free list for exactly one chain
        held = set(self._shared_pages).union(*self._slot_pages)
        assert held.isdisjoint(out) and len(set(out)) == n, (out, held)
        used = self.n_pages - len(self._free_pages)
        self.stats["pages_peak"] = max(self.stats["pages_peak"], used)
        return out

    def _release(self, slot: int) -> None:
        self._free_pages.extend(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._slot_req[slot] = None
        self._slot_ub[slot] = 0
        self._slot_max[slot] = 0
        self._stalled.discard(slot)

    def _pages_needed(self, tokens: int) -> int:
        """OWN pages needed to hold ``tokens`` total tokens (incl. the
        shared prefix — its pages are pinned, not per-slot)."""
        return max(0, math.ceil(tokens / self.page_size) - self._n_shared)

    def _reclaim_finished(self) -> bool:
        """Pool pressure relief valve #1: harvest slots that finished
        since the last stale snapshot (frees their pages NOW instead of
        next round). One small sync fetch; only called on alloc failure."""
        act, fin, olen = self._fetch_status(self.cold)
        saved, self._stale_skip = self._stale_skip, frozenset()
        try:  # current-truth snapshot: nothing is stale for it
            freed = self._collect(fin, olen, self.cold)
        finally:
            self._stale_skip = saved
        return bool(freed)

    def _preempt_one(self, exclude: frozenset) -> bool:
        """Pool pressure relief valve #2: force the YOUNGEST preemptible
        request out of its slot — stash its partial generation, free its
        pages, requeue it as a continuation (prompt + generated tokens
        re-prefill when pages free up). Returns False if no candidate."""
        _, fin, olen = self._fetch_status(self.cold)
        cands = [i for i in range(self.n_slots)
                 if self._slot_uid[i] is not None and i not in exclude
                 and not fin[i] and self._slot_req[i] is not None]
        if not cands:
            return False
        slot = None
        for j in sorted(cands, key=lambda i: -self._slot_seq[i]):
            uid = self._slot_uid[j]
            req = self._slot_req[j]
            n = int(olen[j])
            toks = self.cold["out_buf"][j].cpu().numpy()[:n].astype(np.int32)
            stash = np.concatenate(
                [self._partial.get(uid, np.zeros((0,), np.int32)), toks])
            packed = _pack_batch(req.batch)
            ids = np.concatenate(
                [np.asarray(packed["input_ids"])[0], stash])
            cap0 = self._cap_for(req)
            # buckets bound SUFFIX lengths (ids still carries the shared
            # prefix — the continuation re-strips it at re-admission)
            if (ids.size - self.s_pre <= self.buckets[-1]
                    and cap0 - int(stash.size) >= 1):
                slot = j
                break
        if slot is None:
            return False  # no continuation would fit — unpreemptible
        self._partial[uid] = stash
        nb = dict(packed)
        nb["input_ids"] = ids[None]
        nb["attention_mask"] = np.ones((1, ids.size), np.int32)
        cont = Request(uid=uid, batch=nb,
                       max_new_tokens=cap0 - int(stash.size),
                       sampling=req.sampling, adapter=req.adapter)
        # deactivate on device (do NOT set finished — the harvest path
        # must not treat the partial row as a final result)
        self.cold["active"] = _at_set(self.cold["active"], slot, False)
        self._slot_uid[slot] = None
        self._release(slot)
        self._pending.insert(0, cont)
        self.stats["preemptions"] += 1
        return True

    def _grow_row(self, slot: int, need: int, updates: list,
                  exclude: frozenset) -> bool:
        """Extend ``slot``'s page chain by ``need`` pages, shaking the
        pool (reclaim, then preemption) on failure. Returns False when
        the pool is dry and nothing is preemptible — e.g. every
        mid-flight continuation has outgrown the largest prefill bucket
        so no slot can be requeued; the caller STALLS the grower for the
        round instead of crashing (pages recycle as others finish)."""
        pages = self._alloc(need)
        while pages is None:
            if not (self._reclaim_finished()
                    or self._preempt_one(exclude)):
                return False
            pages = self._alloc(need)
        base = self._n_shared + len(self._slot_pages[slot])
        for j, p in enumerate(pages):
            updates.append((slot, base + j, p))
        self._slot_pages[slot].extend(pages)
        return True

    def _before_decode_dispatch(self, groups):
        """Per-round page management, host-side, pre-dispatch:
        1. grow mid-flight slots' chains to cover this round's decode
           chunk (they NEVER yield to new admissions);
        2. allocate chains for the round's admission groups — requests
           that don't fit requeue to the front of the queue;
        3. push all table updates to the device in one write."""
        chunk = self.decode_chunk
        updates: list = []
        stale_fin = self._stale[1] if self._stale is not None else None
        for i in range(self.n_slots):
            if self._slot_uid[i] is None:
                continue
            if (stale_fin is not None and i not in self._stale_skip
                    and stale_fin[i]):
                continue  # finished by last snapshot: no growth needed
            prev_ub = self._slot_ub[i]
            self._slot_ub[i] = min(prev_ub + chunk, self._slot_max[i])
            need = (self._pages_needed(self._slot_ub[i])
                    - len(self._slot_pages[i]))
            if need > 0 and not self._grow_row(i, need, updates,
                                               frozenset({i})):
                # STALL: pool dry, nothing preemptible. Freeze the slot
                # for the round — keep its pages, revert the bound,
                # deactivate on device so the decode chunk neither
                # advances it nor writes past its chain (table entries
                # beyond it would alias page 0). It resumes the round
                # pages free up; a preemption meanwhile requeues it
                # (_release clears the stall mark).
                self._slot_ub[i] = prev_ub
                if i not in self._stalled:
                    self._stalled.add(i)
                    self.cold["active"] = _at_set(self.cold["active"], i,
                                                  False)
                    self.stats["stalls"] += 1
                continue
            if i in self._stalled:  # pages granted again: resume
                self._stalled.discard(i)
                self.cold["active"] = _at_set(self.cold["active"], i, True)
        kept = []
        for reqs, slots in groups:
            k_reqs, k_slots = [], []
            for r, slot in zip(reqs, slots):
                # admission only assigns free slots; preemption frees others
                assert self._slot_uid[slot] is None, slot
                tot = self.s_pre + self._eff_len(r)  # prefix + suffix
                cap = self._cap_for(r)
                maxtok = tot + cap  # KV ceiling (last token never writes)
                ub = min(tot + chunk, maxtok)
                pages = self._alloc(self._pages_needed(ub))
                if pages is None:
                    self._reclaim_finished()
                    pages = self._alloc(self._pages_needed(ub))
                if pages is None:  # pool tight: delay admission, do NOT
                    #                preempt mid-flight work for new work
                    self._pending.insert(0, r)
                    continue
                self._slot_pages[slot] = pages
                self._slot_ub[slot] = ub
                self._slot_max[slot] = maxtok
                row = np.full((self.pages_per_seq,), -1, np.int32)
                row[:self._n_shared] = self._shared_pages
                row[self._n_shared:self._n_shared + len(pages)] = pages
                self._admit_tables[slot] = row
                k_reqs.append(r)
                k_slots.append(slot)
            if k_reqs:
                kept.append((k_reqs, k_slots))
        if updates:
            sl, co, pg = (torch.as_tensor(x, device=self.device)
                          for x in zip(*updates))
            self.cold["page_table"] = _at_set(
                self.cold["page_table"], (sl, co), pg.to(torch.int32))
        inflight = [i for i in range(self.n_slots)
                    if self._slot_uid[i] is not None]
        if inflight and not kept and all(i in self._stalled
                                         for i in inflight):
            # every in-flight request is stalled, none finished (reclaim
            # found nothing), none preemptible, nothing admitted: no
            # round can ever make progress
            raise RuntimeError(
                f"page pool wedged: {self.n_pages} pages of "
                f"{self.page_size} cannot hold any in-flight request's "
                "next chunk, none is preemptible (continuations exceed "
                "the largest prefill bucket), and none can finish — "
                "raise n_pages, lower n_slots, or add a larger prefill "
                "bucket")
        return kept

    def _bind_slots(self, reqs, slots) -> None:
        super()._bind_slots(reqs, slots)
        for r, s in zip(reqs, slots):
            self._slot_req[s] = r
            self._admit_seq += 1
            self._slot_seq[s] = self._admit_seq

    def _collect(self, fin, olen, cold_src) -> List[int]:
        idxs = super()._collect(fin, olen, cold_src)
        for i in idxs:
            self._release(i)
        return idxs

    def _materialize(self) -> Dict[Any, np.ndarray]:
        out = super()._materialize()
        for uid in list(self._partial):
            if uid in out:  # re-prefix preempted requests' stashed tokens
                merged = np.concatenate(
                    [self._partial.pop(uid),
                     np.asarray(out[uid], np.int32)])
                self._results[uid] = merged
                out[uid] = merged
        return out
