"""Offline (whole-workload) continuous batching: the admission ring, the
counterpart of ``molly_tpu/inference/offline.py``.

For an offline workload (a fixed file of prompts decoded to JSONL) the
whole queue is known up front. The ring uploads every prompt once and then
alternates two moves on the device:

  - ADMIT: harvest ``admit_group`` finished or never-used slots into the
    per-request results, prefill the next ``admit_group`` queued prompts
    (one [k, bucket] prefill into a temporary cache, the frozen encoders
    run on the group's omics segments first), sample their first tokens and
    insert their KV into the recycled slots;
  - DECODE: advance every active slot one token (the online engine's
    prompt-columns + generation-ring cache layout and sampling semantics),
    or, with ``spec_lookup``, one prompt-lookup speculative round;

and the results come back in one transfer at the end. Greedy output is
token-identical to ``ServingEngine``'s; sampled output matches it in
distribution.

Where JAX runs the ring as one jitted ``while_loop``, this is a host loop
over ticks that launches each tick's work eagerly. Its decisions — admit or
decode, stop, speculate or not — need two numbers of device state: how many
slots are active, and the acceptance EMA. They are read back together once
after each admission and each tick, which is where the JAX loop evaluates
the same conditions on the device; nothing else is read until the final
harvest. Every slot-indexed update is a scatter over distinct (row,
column) pairs: entries the JAX code drops (``mode="drop"``) go to one
scratch column or row that nothing reads, all with the same value, so two
runs write the same bits. Random draws come from one explicit
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models import fusion, qwen3
from ..models.configs import FusionConfig, GenerationConfig
from .sampling import sample_tokens

_QKEY = {"dna_rna_tokens": "queue_dna_tokens",
         "dna_rna_pos": "queue_dna_pos",
         "protein_tokens": "queue_prot_tokens",
         "protein_pos": "queue_prot_pos"}


def _admit(params, st, generator, qh: int, *, cfg: FusionConfig,
           gen: GenerationConfig, admit_group: int, bucket: int,
           ring_cols: int, n_req: int):
    """Recycle ``admit_group`` slots and prefill queue rows [qh, qh + k)
    into them. The caller admits only when k slots are free; the queue is
    padded to a multiple of k with cap-1 dummy rows. Fusion prompts: the
    queue carries the omics segment arrays, and the group's segments run
    through the frozen encoders and the projector injection here."""
    tcfg = cfg.text
    k = admit_group
    B = st["active"].shape[0]
    T = gen.max_new_tokens
    L = st["valid"].shape[1] - 1
    dev = st["active"].device
    ar = torch.arange(B, device=dev)
    # the k lowest free slot indices (their ranks are distinct)
    slot_rank = torch.where(~st["active"], ar, B + ar)
    slots = torch.sort(slot_rank).values[:k] % B

    # harvest whatever sits in the recycled slots into the results; a
    # never-used slot (request -1) and a dummy row go to the scratch row
    req_ids = st["req_of_slot"][slots]
    real = (req_ids >= 0) & (req_ids < n_req)
    dst = torch.where(real, req_ids, n_req)
    st["results"][dst] = torch.where(real[:, None], st["out_buf"][slots, :T],
                                     gen.pad_token_id)
    st["res_len"][dst] = torch.where(real, st["out_len"][slots], 0)

    ids = st["queue_ids"][qh:qh + k]
    mask = st["queue_mask"][qh:qh + k]
    caps = st["queue_caps"][qh:qh + k].clamp(1, ring_cols)
    new_req = qh + torch.arange(k, device=dev)
    if "queue_dna_tokens" in st or "queue_prot_tokens" in st:
        eb = {"input_ids": ids}
        if "queue_dna_tokens" in st:
            eb["dna_rna_tokens"] = st["queue_dna_tokens"][qh:qh + k]
            eb["dna_rna_pos"] = st["queue_dna_pos"][qh:qh + k]
        if "queue_prot_tokens" in st:
            eb["protein_tokens"] = st["queue_prot_tokens"][qh:qh + k]
            eb["protein_pos"] = st["queue_prot_pos"][qh:qh + k]
        emb = fusion.build_inputs_embeds(params, cfg, eb)
    else:
        emb = qwen3.embed_tokens(params["text"], ids)
    cache = qwen3.init_cache(tcfg, k, bucket, device=dev)
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    hidden, cache = qwen3.forward_hidden(
        params["text"], tcfg, inputs_embeds=emb, attention_mask=mask,
        positions=positions, cache=cache, cache_index=0)
    logits = qwen3.logits_from_hidden(params["text"], tcfg, hidden[:, -1])
    V = tcfg.vocab_size
    presence = torch.zeros((k, V + 1), dtype=torch.bool, device=dev)
    tok0 = sample_tokens(
        logits, generator, do_sample=gen.do_sample,
        temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
        repetition_penalty=gen.repetition_penalty, presence=presence[:, :V])
    rows_k = torch.arange(k, device=dev)
    presence[rows_k, tok0] = True

    # insert into the recycled slots (server._prefill_insert's layout)
    if "kv_scale" in st:
        q8, sc = qwen3.quantize_kv(cache["kv"])
        st["cache"][:, slots, :, :bucket] = q8
        st["kv_scale"][:, slots, :, :bucket] = sc
    else:
        st["cache"][:, slots, :, :bucket] = cache["kv"].to(st["cache"].dtype)
    vrows = torch.zeros((k, L + 1), dtype=torch.int32, device=dev)
    vrows[:, :bucket] = mask
    st["valid"][slots] = vrows
    st["n_real"][slots] = mask.sum(dim=1)
    st["last_tok"][slots] = tok0
    st["presence"][slots] = presence
    out_rows = torch.full((k, T + 1), gen.pad_token_id, dtype=torch.int32,
                          device=dev)
    out_rows[:, 0] = tok0
    st["out_buf"][slots] = out_rows
    st["out_len"][slots] = 1
    st["cap"][slots] = caps
    done0 = (tok0 == gen.eos_token_id) | (caps <= 1)
    st["active"][slots] = ~done0
    st["req_of_slot"][slots] = new_req
    if "tok_hist" in st:  # speculative mode: position-ordered history
        hist_rows = torch.full((k, L + 1), -1, dtype=torch.long, device=dev)
        real_tok = mask != 0
        hist_rows[rows_k[:, None], torch.where(real_tok, positions, L)] = \
            torch.where(real_tok, ids.long(), -1)
        hist_rows[rows_k, mask.sum(dim=1)] = tok0
        st["tok_hist"][slots] = hist_rows
        st["gen_cols"][slots] = 0


def _lookup_draft(hist, nr, *, ngram_n: int, spec_k: int):
    """Prompt-lookup draft for every row: the ``spec_k`` tokens after the
    most recent earlier occurrence (window end i < nr) of the trailing
    ``ngram_n``-gram ending at hist[nr] ([B, spec_k]; unwritten -1
    positions clamp to id 0, which a verify rejects). Shared by the
    speculative round and the adaptive ring's shadow estimator."""
    B, Hh = hist.shape
    dev = hist.device
    patt_idx = (nr[:, None] - (ngram_n - 1)
                + torch.arange(ngram_n, device=dev)[None])
    pattern = hist.gather(1, patt_idx.clamp(min=0))
    idx = torch.arange(Hh, device=dev)
    ok = torch.ones((B, Hh), dtype=torch.bool, device=dev)
    for j in range(ngram_n):  # window ending at i matches pattern[n-1-j]
        shifted = (torch.cat([torch.full((B, j), -1, dtype=hist.dtype,
                                         device=dev), hist[:, :Hh - j]],
                             dim=1) if j else hist)
        ok = ok & (shifted == pattern[:, ngram_n - 1 - j][:, None])
    cand = torch.where(ok & (idx[None] >= ngram_n - 1)
                       & (idx[None] <= nr[:, None] - 1), idx[None], -1)
    p = cand.max(dim=1).values
    p = torch.where(p < 0, nr, p)   # no match -> the unwritten region
    d_idx = p[:, None] + 1 + torch.arange(spec_k, device=dev)[None]
    drafts = hist.gather(1, d_idx.clamp(max=Hh - 1))
    return drafts.clamp(min=0)


def _decode_tick(params, st, generator, head: int, *, tcfg,
                 gen: GenerationConfig, prompt_cols: int, ring_cols: int,
                 spec_k: int = 0, ngram_n: int = 3):
    """One decode step for every slot (``server._decode_impl``: the ring
    column shared by all slots at tick ``head``).

    In the acceptance-adaptive ring (``gen_cols`` in the state) speculative
    rounds consume ring columns DENSELY per row, so a plain tick writes
    each row's own next column (``gen_cols``), not the shared head's —
    which would land inside another row's live span — and keeps the token
    history and presence current for the next speculative round. There
    (``spec_k``) each tick also runs the SHADOW draft: would the lookup
    draft's first token have matched the token the model emitted? Greedy,
    a match is exactly an accepted draft 1; sampled, P(match) = p(d_1). The
    match fraction, extrapolated to a k-chain as sum_i frac^i / k, feeds the
    same acceptance EMA the speculative rounds update."""
    L = st["valid"].shape[1] - 1
    V = tcfg.vocab_size
    active = st["active"]
    B = active.shape[0]
    rows = torch.arange(B, device=active.device)
    adaptive = "gen_cols" in st
    emb = qwen3.embed_tokens(params["text"], st["last_tok"][:, None])
    if adaptive:  # per-row dense ring columns
        col = prompt_cols + st["gen_cols"] % ring_cols            # [B]
        st["valid"][rows, col] = active.to(torch.int32)
        cache_idx = col[:, None]
    else:
        col = prompt_cols + head % ring_cols
        st["valid"][:, col] = active.to(torch.int32)
        cache_idx = col
    cache_in = {"kv": st["cache"]}
    if "kv_scale" in st:
        cache_in["kv_scale"] = st["kv_scale"]
    hidden, _ = qwen3.forward_hidden(
        params["text"], tcfg, inputs_embeds=emb,
        attention_mask=st["valid"][:, :L], positions=st["n_real"][:, None],
        cache=cache_in, cache_index=cache_idx, causal=False)
    logits = qwen3.logits_from_hidden(params["text"], tcfg, hidden[:, 0])
    pres = st["presence"]
    nxt = sample_tokens(
        logits, generator, do_sample=gen.do_sample,
        temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
        repetition_penalty=gen.repetition_penalty, presence=pres[:, :V])
    nxt = torch.where(active, nxt, gen.pad_token_id)
    T = gen.max_new_tokens
    safe = torch.clamp(st["out_len"], max=T - 1)
    st["out_buf"][rows, safe] = torch.where(
        active, nxt.to(torch.int32), st["out_buf"][rows, safe])
    pres[rows, nxt] = pres[rows, nxt] | active
    st["out_len"] += active
    if adaptive:  # keep the speculative bookkeeping current
        st["gen_cols"] += active
        if "spec_ema" in st and spec_k:
            # the shadow draft reads the history BEFORE this tick's token
            # lands: its no-match fallback reads hist[nr + 1], which the real
            # round sees unwritten (a certain reject)
            d1 = _lookup_draft(st["tok_hist"][:, :L], st["n_real"],
                               ngram_n=ngram_n, spec_k=1)[:, 0]
            n_act = torch.clamp(active.sum(), min=1)
            frac = (active & (d1 == nxt)).sum().float() / n_act
            rate_est = sum(frac ** i for i in range(1, spec_k + 1)) / spec_k
            st["spec_ema"] = 0.8 * st["spec_ema"] + 0.2 * rate_est
        dst = torch.where(active, st["n_real"] + 1, L)
        st["tok_hist"][rows, dst] = torch.where(active, nxt, -1)
    st["n_real"] += active
    st["last_tok"] = torch.where(active, nxt, st["last_tok"])
    newly_done = active & ((nxt == gen.eos_token_id)
                           | (st["out_len"] >= st["cap"]))
    st["active"] = active & ~newly_done


def _spec_tick(params, st, generator, *, tcfg, gen: GenerationConfig,
               prompt_cols: int, ring_cols: int, spec_k: int, ngram_n: int):
    """One prompt-lookup speculative round for every active slot: the
    batched ``speculative.generate_lookup``. Each row drafts ``spec_k``
    tokens from its own history, ONE (spec_k+1)-wide verify forward scores
    the chain, and the longest accepted prefix plus one correction or
    extension token is emitted (greedy: token-identical to the plain tick;
    sampled: the point-mass rejection rule over the engine's processed
    distributions).

    The tentative KV of the W = spec_k+1 fed tokens goes DENSELY to each
    row's own next ring columns (a per-row [B, W] ``cache_index``); only the
    first m+1 are validated and ``gen_cols`` advances by m+1, so rejected
    columns are overwritten next round (caps leave spec_k columns of
    headroom, the caller's rule)."""
    from .speculative import _processed_probs

    L = st["valid"].shape[1] - 1
    V = tcfg.vocab_size
    W = spec_k + 1
    active = st["active"]
    B = active.shape[0]
    dev = active.device
    rows = torch.arange(B, device=dev)
    hist = st["tok_hist"][:, :L]
    nr = st["n_real"]          # position of the pending token (= fed[0])
    drafts = _lookup_draft(hist, nr, ngram_n=ngram_n, spec_k=spec_k)

    # ---- verify forward: [pending, d_1..d_k] at per-row dense columns
    fed = torch.cat([st["last_tok"][:, None], drafts], dim=1)
    j_w = torch.arange(W, device=dev)[None]
    cols = prompt_cols + (st["gen_cols"][:, None] + j_w) % ring_cols  # [B, W]
    onehot = cols[:, :, None] == torch.arange(L, device=dev)[None, None]
    tent = torch.cumsum(onehot.to(torch.int32), dim=1) > 0   # j sees <= j
    m4 = ((st["valid"][:, None, :L] != 0) | tent)[:, None]   # [B, 1, W, L]
    positions = nr[:, None] + j_w
    emb = qwen3.embed_tokens(params["text"], fed)
    cache_in = {"kv": st["cache"]}
    if "kv_scale" in st:
        cache_in["kv_scale"] = st["kv_scale"]
    hidden, _ = qwen3.forward_hidden(
        params["text"], tcfg, inputs_embeds=emb, attention_mask=m4,
        positions=positions, cache=cache_in, cache_index=cols, causal=False)
    logits = qwen3.logits_from_hidden(params["text"], tcfg, hidden)

    # presence at verify position j includes the drafts d_1..d_j
    presence = st["presence"][:, :V]
    if not gen.do_sample:
        targets, pres = [], presence
        for j in range(W):
            targets.append(sample_tokens(
                logits[:, j], None, do_sample=False,
                repetition_penalty=gen.repetition_penalty, presence=pres))
            if j < W - 1:
                pres = pres.clone()
                pres[rows, drafts[:, j]] = True
        targets = torch.stack(targets, dim=1)                 # [B, W]
        m = torch.cumprod((drafts == targets[:, :spec_k]).long(),
                          dim=1).sum(dim=1)                   # [B] accepted
        ext = targets.gather(1, m[:, None])[:, 0]
    else:
        pres, oks = presence, []
        for j in range(spec_k):
            pj = _processed_probs(logits[:, j].float(), pres, gen)  # [B, V]
            u = torch.rand((B,), generator=generator, device=dev)
            oks.append((u < pj[rows, drafts[:, j]]).long())
            pres = pres.clone()
            pres[rows, drafts[:, j]] = True
        m = torch.cumprod(torch.stack(oks, dim=1), dim=1).sum(dim=1)
        # extension: the residual at the rejected position, the bonus
        # distribution at m = k; presence at position m holds d_1..d_m
        pres_m = presence
        for j in range(spec_k):
            upd = pres_m.clone()
            upd[rows, drafts[:, j]] = True
            pres_m = torch.where((j < m)[:, None], upd, pres_m)
        lg_m = logits.gather(1, m[:, None, None].expand(B, 1, V))[:, 0]
        pm = _processed_probs(lg_m.float(), pres_m, gen)      # [B, V]
        dm = drafts.gather(1, m.clamp(max=spec_k - 1)[:, None])[:, 0]
        resid = pm.clone()
        resid[rows, dm] = 0.0
        dist = torch.where((m < spec_k)[:, None], resid, pm)
        # numeric guard: a vanished residual falls back to p_m
        dist = torch.where(dist.sum(dim=1, keepdim=True) > 1e-20, dist, pm)
        ext = torch.multinomial(dist, 1, generator=generator)[:, 0]

    emit = torch.where(j_w < m[:, None],
                       torch.cat([drafts, drafts[:, -1:]], dim=1),
                       torch.where(j_w == m[:, None], ext[:, None],
                                   gen.pad_token_id))         # [B, W]

    # ---- truncate by cap room and the first EOS; inactive rows emit none
    room = torch.clamp(st["cap"] - st["out_len"], min=0)
    base_e = torch.minimum(m + 1, room)
    eos_pos = torch.where((emit == gen.eos_token_id) & (j_w < base_e[:, None]),
                          j_w, W).min(dim=1).values
    e_eff = torch.where(active, torch.minimum(base_e, eos_pos + 1), 0)
    emit_on = j_w < e_eff[:, None]

    # ---- state updates; masked entries go to the scratch column
    T = gen.max_new_tokens
    st["out_buf"][rows[:, None],
                  torch.where(emit_on, st["out_len"][:, None] + j_w, T)] = \
        torch.where(emit_on, emit, gen.pad_token_id).to(torch.int32)
    st["tok_hist"][rows[:, None], torch.where(emit_on, nr[:, None] + 1 + j_w,
                                              L)] = \
        torch.where(emit_on, emit, -1)
    st["presence"][rows[:, None], torch.where(emit_on, emit, V)] = True
    # keep the KV columns of the e_eff fed tokens actually consumed
    st["valid"][rows[:, None], torch.where(emit_on, cols, L)] = 1
    st["gen_cols"] += e_eff
    st["n_real"] = nr + e_eff
    st["out_len"] += e_eff
    last = emit.gather(1, (e_eff - 1).clamp(min=0)[:, None])[:, 0]
    st["last_tok"] = torch.where(e_eff > 0, last, st["last_tok"])
    n_act_in = torch.clamp(active.sum(), min=1)
    newly_done = active & ((eos_pos < base_e) | (st["out_len"] >= st["cap"]))
    st["active"] = active & ~newly_done
    # accepted drafts actually emitted (e_eff - 1 a live row)
    acc_round = torch.clamp(e_eff - 1, min=0).sum()
    st["accepted"] += acc_round
    if "spec_ema" in st:  # adaptive ring: the acceptance-rate EMA
        rate = acc_round.float() / (spec_k * n_act_in)
        st["spec_ema"] = 0.8 * st["spec_ema"] + 0.2 * rate


@torch.inference_mode()
def _run_ring(params, queue, generator, *, cfg: FusionConfig,
              gen: GenerationConfig, n_slots: int, max_len: int,
              admit_group: int, kv_quant: Optional[str], n_req: int,
              spec_k: int = 0, ngram_n: int = 3,
              spec_threshold: Optional[float] = None, probe_every: int = 0,
              chunk: int = 32, spec_initial_ema: float = 1.0):
    tcfg = cfg.text
    dev = params["text"]["embed"].device
    N, bucket = queue["queue_ids"].shape
    prompt_cols = bucket
    ring_cols = max_len - prompt_cols
    if ring_cols < spec_k + 1:
        # a round's W = spec_k + 1 columns must be distinct in the ring
        raise ValueError(f"max_len {max_len} leaves {ring_cols} ring columns "
                         f"past the {bucket}-column bucket; a speculative "
                         f"round needs {spec_k + 1}")
    T = gen.max_new_tokens
    B, V, k = n_slots, tcfg.vocab_size, admit_group

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    c = qwen3.init_cache(tcfg, B, max_len, device=dev, quant=kv_quant)
    # one scratch column (valid, presence, out_buf, tok_hist) or row
    # (results) past the end absorbs the writes JAX drops
    st = {
        "cache": c["kv"],
        **({"kv_scale": c["kv_scale"]} if "kv_scale" in c else {}),
        "valid": full((B, max_len + 1), 0, torch.int32),
        "n_real": full((B,), 0, torch.long),
        "last_tok": full((B,), 0, torch.long),
        "presence": full((B, V + 1), False, torch.bool),
        "out_buf": full((B, T + 1), gen.pad_token_id, torch.int32),
        "out_len": full((B,), 0, torch.long),
        "cap": full((B,), T, torch.long),
        "active": full((B,), False, torch.bool),
        "req_of_slot": full((B,), -1, torch.long),
        "results": full((n_req + 1, T), gen.pad_token_id, torch.int32),
        "res_len": full((n_req + 1,), 0, torch.long),
        **queue,
    }
    adaptive = bool(spec_k) and spec_threshold is not None
    if spec_k:
        st["tok_hist"] = full((B, max_len + 1), -1, torch.long)
        st["gen_cols"] = full((B,), 0, torch.long)
        st["accepted"] = full((), 0, torch.long)
    if adaptive:
        # optimistic by default (spec on); a no-match workload decays the
        # EMA below the threshold within ~10 rounds. spec_initial_ema below
        # the threshold starts plain instead: the shadow raises the EMA if
        # the workload turns quotable
        st["spec_ema"] = full((), spec_initial_ema, torch.float32)
    tick_kw = dict(tcfg=tcfg, gen=gen, prompt_cols=prompt_cols,
                   ring_cols=ring_cols)
    syncs = 0

    def read():
        """The loop's one read back: (active slots, acceptance EMA)."""
        nonlocal syncs
        syncs += 1
        if not adaptive:
            return int(st["active"].sum()), 0.0
        n_act, e = torch.stack([st["active"].sum().float(),
                                st["spec_ema"]]).tolist()
        return int(n_act), e

    tick = head = qh = spec_ticks = cycle = 0
    n_act, ema = read()

    def want_admit():
        return qh < N and B - n_act >= k

    while n_act > 0 or qh < N:
        if want_admit():
            _admit(params, st, generator, qh, cfg=cfg, gen=gen,
                   admit_group=k, bucket=bucket, ring_cols=ring_cols,
                   n_req=n_req)
            qh += k
            n_act, ema = read()
        tick += 1
        if adaptive:
            # choose speculative or plain once per bounded chunk of ticks,
            # never per tick; probe_every > 0 forces one speculative chunk
            # every probe_every chunks
            use_spec = ema >= spec_threshold or (
                probe_every > 0 and cycle % probe_every == 0)
            cycle += 1
            chunk_start = tick
        else:
            use_spec = bool(spec_k)
        while n_act > 0 and not want_admit() and (
                not adaptive or tick - chunk_start < chunk):
            if use_spec:
                _spec_tick(params, st, generator, spec_k=spec_k,
                           ngram_n=ngram_n, **tick_kw)
                spec_ticks += 1
            else:
                _decode_tick(params, st, generator, head, spec_k=spec_k,
                             ngram_n=ngram_n, **tick_kw)
            head += 1
            tick += 1
            n_act, ema = read()

    # final harvest: every slot still bound to a request
    req_ids = st["req_of_slot"]
    real = (req_ids >= 0) & (req_ids < n_req)
    dst = torch.where(real, req_ids, n_req)
    st["results"][dst] = torch.where(real[:, None], st["out_buf"][:, :T],
                                     gen.pad_token_id)
    st["res_len"][dst] = torch.where(real, st["out_len"], 0)
    tokens = st["results"][:n_req].cpu().numpy()
    lengths = st["res_len"][:n_req].cpu().numpy().astype(np.int32)
    accepted = int(st["accepted"]) if spec_k else -1
    syncs += 1
    return {"tokens": tokens, "lengths": lengths, "ticks": tick,
            "decode_ticks": head, "accepted": accepted,
            "spec_ticks": spec_ticks if adaptive else -1,
            "spec_ema": float(ema) if adaptive else -1.0,
            "host_syncs": syncs}


def spec_break_even_threshold(t_plain_tick: float, t_spec_round: float,
                              spec_k: int) -> float:
    """Acceptance rate a* at which speculation breaks even: a plain tick
    emits 1 token a row in t_plain, a speculative round 1 + a*k in t_spec,
    so (1 + a*k) / t_spec = 1 / t_plain gives a* = (t_spec/t_plain - 1) / k.
    The ratio is a property of the operating point (about 1 where decode
    streams the weights for few rows, higher where the (k+1)-wide verify
    turns compute-bound), so a* comes from MEASURED tick costs
    (``calibrate_spec_threshold``)."""
    r = t_spec_round / max(t_plain_tick, 1e-12)
    return max(0.0, (r - 1.0) / spec_k)


def calibrate_spec_threshold(
    params, cfg: FusionConfig, gen: GenerationConfig, *,
    n_slots: int, max_len: int, bucket: int, spec_k: int,
    ngram_n: int = 3, kv_quant: Optional[str] = None,
    cal_tokens: int = 64, safety: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, float]:
    """Measure the plain-tick and speculative-round costs at THIS operating
    point and derive the adaptive ring's break-even threshold.

    Two short workloads of random prompts (acceptance ~ 0, so every round
    emits ~1 token a row and its cost reads straight off the clock), one
    plain and one always speculative, each run once to warm up and once
    timed: by CUDA events on the card, by ``time.perf_counter`` on the CPU.
    Returns {"threshold", "t_plain_tick", "t_spec_round", "ratio"}; pass the
    threshold to ``run_offline(spec_threshold=...)``. ``safety`` > 1 asks
    that margin of gain before speculating."""
    dev = params["text"]["embed"].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(7)
    r_np = np.random.default_rng(11)
    N = n_slots  # one admission, decode-dominated
    ids = r_np.integers(4, cfg.text.vocab_size - 4, (N, bucket)).astype(
        np.int32)
    mask = np.ones((N, bucket), np.int32)
    cal_gen = dataclasses.replace(gen, max_new_tokens=cal_tokens,
                                  eos_token_id=-1)

    def timed(spec):
        kw = dict(n_slots=n_slots, max_len=max_len, admit_group=n_slots,
                  kv_quant=kv_quant, generator=generator)
        if spec:
            kw.update(spec_lookup=spec_k, ngram_n=ngram_n)
        run_offline(params, cfg, cal_gen, ids, mask, **kw)  # warm-up
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run_offline(params, cfg, cal_gen, ids, mask, **kw)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = run_offline(params, cfg, cal_gen, ids, mask, **kw)
            dt = time.perf_counter() - t0
        return dt / max(out["decode_ticks"], 1)

    t_plain = timed(False)
    t_spec = timed(True)
    thr = spec_break_even_threshold(t_plain, t_spec * safety, spec_k)
    return {"threshold": thr, "t_plain_tick": t_plain,
            "t_spec_round": t_spec, "ratio": t_spec / t_plain}


def run_offline(params, cfg: FusionConfig, gen: GenerationConfig,
                queue_ids: np.ndarray, queue_mask: np.ndarray,
                queue_caps: Optional[np.ndarray] = None, *,
                n_slots: int = 64, max_len: int = 1024,
                admit_group: int = 8,
                kv_quant: Optional[str] = None,
                spec_lookup: int = 0, ngram_n: int = 3,
                spec_threshold: Optional[float] = None,
                spec_probe_every: int = 0, spec_chunk: int = 32,
                spec_initial_ema: float = 1.0,
                queue_omics: Optional[Dict[str, np.ndarray]] = None,
                generator: Optional[torch.Generator] = None,
                ) -> Dict[str, np.ndarray]:
    """Run a whole offline workload through the ring on the device of
    ``params``.

    queue_ids / queue_mask: [N, bucket] left-padded prompts (one bucket).
    queue_caps: [N] per-request max_new_tokens (default: the gen cap).
    queue_omics: fusion prompts — whole-queue segment arrays
    ({"dna_rna_tokens": [N, G, k], "dna_rna_pos": [N, G], "protein_tokens",
    "protein_pos"}, collator layout, start positions already shifted for the
    left pad); each admission group's segments run through the encoders.
    spec_lookup: draft tokens a prompt-lookup round (0: plain ticks).
    Greedy output stays token-identical, sampled output
    distribution-identical; rounds shrink with the acceptance rate.
    spec_threshold: with spec_lookup, the ACCEPTANCE-ADAPTIVE ring:
    speculate only while the acceptance EMA sits at or above the
    threshold; plain ticks keep the EMA live through the shadow draft.
    The mode is chosen once per ``spec_chunk`` ticks; ``spec_probe_every``
    > 0 forces one speculative chunk every that many chunks;
    ``spec_initial_ema`` is the starting EMA (1.0: the first chunk
    speculates). Both tick types are token-exact, so adaptivity changes
    which ticks produce the tokens, never the tokens.

    Returns {"tokens": [N, T] int32, "lengths": [N], "ticks",
    "decode_ticks", "accepted" (-1 without spec), "spec_ticks" (rounds that
    speculated in the adaptive ring; -1 otherwise), "spec_ema" (-1.0
    otherwise), "host_syncs" (device-state reads of the host loop)}; row i
    holds request i's tokens (EOS included), the first ``lengths[i]``
    valid."""
    N = queue_ids.shape[0]
    assert N >= 1
    dev = params["text"]["embed"].device
    caps = (np.full((N,), gen.max_new_tokens, np.int32)
            if queue_caps is None else np.asarray(queue_caps, np.int32))
    if spec_lookup:
        # tentative KV columns need spec_lookup headroom past the cap
        caps = np.minimum(caps, max_len - queue_ids.shape[1] - spec_lookup)
    # pad the queue to a multiple of the admission group with cap-1 dummy
    # rows, so every admission has the same shape
    k = max(1, min(admit_group, n_slots))
    pad = (-N) % k
    ids = np.asarray(queue_ids, np.int32)
    mask = np.asarray(queue_mask, np.int32)
    omics = {_QKEY[key]: np.asarray(v, np.int32)
             for key, v in (queue_omics or {}).items()}
    if pad:
        ids = np.concatenate(
            [ids, np.full((pad, ids.shape[1]), gen.pad_token_id, np.int32)])
        mask = np.concatenate([mask, np.ones((pad, mask.shape[1]),
                                             np.int32)])
        caps = np.concatenate([caps, np.ones((pad,), np.int32)])
        for key, v in omics.items():  # dummy rows: no segments (pos -1),
            fill = -1 if key.endswith("_pos") else 1  # pad tokens = 1
            omics[key] = np.concatenate(
                [v, np.full((pad,) + v.shape[1:], fill, np.int32)])
    # the whole queue goes to the device once
    queue = {"queue_ids": torch.as_tensor(ids, device=dev).long(),
             "queue_mask": torch.as_tensor(mask, device=dev),
             "queue_caps": torch.as_tensor(caps, device=dev).long(),
             **{key: torch.as_tensor(v, device=dev).long()
                for key, v in omics.items()}}
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _run_ring(params, queue, generator, cfg=cfg, gen=gen,
                     n_slots=n_slots, max_len=max_len, admit_group=k,
                     kv_quant=kv_quant, n_req=N, spec_k=spec_lookup,
                     ngram_n=ngram_n, spec_threshold=spec_threshold,
                     probe_every=spec_probe_every, chunk=spec_chunk,
                     spec_initial_ema=spec_initial_ema)
