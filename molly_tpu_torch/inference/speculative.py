"""Speculative decoding (draft-verify), greedy and sampled, single-stream —
the counterpart of ``molly_tpu/inference/speculative.py``.

A cheap DRAFT proposes ``k`` tokens one at a time; the TARGET scores all
k+1 positions in ONE forward (decode reads every weight for one row, so a
(k+1)-row verify costs about one decode step).

- Greedy (``do_sample=False``): the longest prefix of drafts that matches
  the target's (repetition-penalized) argmax is accepted, plus the target's
  own next token; the output is EXACTLY the target-only greedy output.
- Sampled: speculative rejection sampling (Leviathan et al.) over the
  PROCESSED distributions — the engine's repetition penalty, temperature,
  top-k and top-p — with the presence set threaded through draft and verify
  positions. Accept d_i with probability min(1, p(d_i)/q(d_i)); on a
  rejection sample the normalized residual max(p - q, 0); on full
  acceptance sample the bonus token from p_{k+1}. The output distribution
  is target-only sampling's.

The natural draft is the int8 copy of the target (``quantize_for_decode``):
no second checkpoint, high agreement. PROMPT LOOKUP (``generate_lookup``)
drafts without a model: the k tokens that followed the most recent earlier
occurrence of the stream's last ``n`` tokens.

Cache discipline: each model keeps one append-only KV cache with a length
pointer. A rejected draft leaves rows past the pointer; they are masked off
(columns >= length are invisible) and overwritten by the next round, so
nothing is ever rewound. Where JAX runs a ``lax.while_loop`` over rounds,
this is a host loop that reads two numbers back per round (the accepted
count and whether EOS was emitted). Random draws come from one explicit
``torch.Generator``; sampled output matches JAX in distribution only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models import qwen3
from ..models.configs import GenerationConfig
from .sampling import NEG_INF, apply_repetition_penalty, top_p_filter


def _feed(params, cfg, tokens, length: int, cache, total: int,
          last_only: bool = False, emb=None, skip_logits: bool = False):
    """Feed S tokens at cache column ``length``; returns (logits [S, V] in
    fp32 — or [1, V] with ``last_only`` — and the cache). Columns >=
    length + S are masked. ``emb`` overrides the token embedding (fusion
    prompts); ``skip_logits`` returns (None, cache), a KV-only feed."""
    if emb is not None:
        S = emb.shape[1]
    else:
        S = tokens.shape[1]
        emb = qwen3.embed_tokens(params, tokens)
    dev = emb.device
    mask = (torch.arange(total, device=dev)[None, :] < length + S).to(
        torch.int32)
    positions = length + torch.arange(S, device=dev)[None, :]
    hidden, cache = qwen3.forward_hidden(
        params, cfg, inputs_embeds=emb, attention_mask=mask,
        positions=positions, cache=cache, cache_index=length)
    if skip_logits:
        return None, cache
    if last_only:
        hidden = hidden[:, -1:]
    logits = qwen3.logits_from_hidden(params, cfg, hidden)
    return logits[0].float(), cache


def _processed_probs(logits, presence, gen: GenerationConfig):
    """The engine's logit pipeline (repetition penalty -> temperature ->
    top-k -> top-p) as a full-vocabulary probability vector, which the
    rejection residual needs. logits / presence: [S, V]."""
    logits = apply_repetition_penalty(logits, presence,
                                      gen.repetition_penalty)
    if gen.temperature != 1.0:
        logits = logits / gen.temperature
    S, V = logits.shape
    if gen.top_k:
        vals, idx = torch.topk(logits, gen.top_k, dim=-1)  # [S, k] desc
        if gen.top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = (cum - probs) < gen.top_p
            vals = torch.where(keep, vals, NEG_INF)
        pk = torch.softmax(vals, dim=-1)
        pk = torch.where(vals <= NEG_INF * 0.5, 0.0, pk)
        out = torch.zeros((S, V), dtype=torch.float32, device=logits.device)
        return out.scatter_(1, idx, pk)
    if gen.top_p < 1.0:
        logits = top_p_filter(logits, gen.top_p)
    p = torch.softmax(logits, dim=-1)
    return torch.where(logits <= NEG_INF * 0.5, 0.0, p)


def _draw(weights, generator):
    """One categorical draw from non-negative ``weights`` [V] (any scale),
    as ``jax.random.categorical(log(w))`` draws."""
    return torch.multinomial(weights, 1, generator=generator)[0]


def _first_token(logits_last, presence_row, gen, generator):
    if not gen.do_sample:
        # greedy matches the engine: repetition penalty BEFORE argmax
        pl = apply_repetition_penalty(logits_last[None], presence_row[None],
                                      gen.repetition_penalty)
        return torch.argmax(pl[0])
    p = _processed_probs(logits_last[None], presence_row[None], gen)[0]
    return _draw(p, generator)


def _lookup_drafts(hist, L: int, total: int, *, n: int, k: int):
    """Prompt-lookup draft: the k tokens after the most recent earlier
    occurrence of the n-gram ending at hist[L-1]. No match: the slice at L
    (pad tokens), which the verify rejects."""
    query = hist[max(L - n, 0):max(L - n, 0) + n]
    idx = torch.arange(total, device=hist.device)
    ok = torch.ones((total,), dtype=torch.bool, device=hist.device)
    for j in range(n):  # window ending at i matches query[n-1-j] at i-j
        shifted = (torch.cat([torch.full((j,), -1, dtype=hist.dtype,
                                         device=hist.device),
                              hist[:total - j]]) if j else hist)
        ok = ok & (shifted == query[n - 1 - j])
    cand = torch.where(ok & (idx >= n - 1) & (idx <= L - 2), idx, -1)
    p = cand.max()
    p = torch.where(p < 0, L - 1, p)
    # JAX's dynamic_slice start, clamped so the k tokens fit
    start = torch.clamp(p + 1, max=total - k)
    return hist[start + torch.arange(k, device=hist.device)]


@torch.inference_mode()
def _spec_impl(t_params, d_params, input_ids, prompt_embeds, generator, *,
               t_cfg, d_cfg, gen: GenerationConfig, k: int,
               lookup_n: Optional[int] = None):
    P = (prompt_embeds.shape[1] if prompt_embeds is not None
         else input_ids.shape[1])
    T = gen.max_new_tokens
    V = t_cfg.vocab_size
    total = P + T + k + 2
    dev = t_params["embed"].device
    pad, eos = gen.pad_token_id, gen.eos_token_id

    t_cache = qwen3.init_cache(t_cfg, 1, total, device=dev)
    logits, t_cache = _feed(t_params, t_cfg, input_ids, 0, t_cache, total,
                            last_only=True, emb=prompt_embeds)
    presence = torch.zeros((V,), dtype=torch.bool, device=dev)
    pending = _first_token(logits[-1], presence, gen, generator)
    presence[pending] = True
    if lookup_n is None:
        d_cache = qwen3.init_cache(d_cfg, 1, total, device=dev)
        d_emb = (prompt_embeds.to(qwen3.torch_dtype(d_cfg.dtype))
                 if prompt_embeds is not None else None)
        _, d_cache = _feed(d_params, d_cfg, input_ids, 0, d_cache, total,
                           last_only=True, emb=d_emb)
    else:
        # the "draft state" is the token history (prompt + generated)
        hist = torch.full((total,), pad, dtype=torch.long, device=dev)
        hist[:P] = input_ids[0]
        hist[P] = pending

    tokens = torch.full((T + k + 1,), pad, dtype=torch.long, device=dev)
    tokens[0] = pending
    j_k = torch.arange(k, device=dev)
    j_w = torch.arange(k + 1, device=dev)
    n_gen, length, n_rounds, n_accepted = 1, P, 0, 0
    done = bool(pending == eos)
    while n_gen < T and not done:
        # ---- draft: k tokens and their (processed) distributions ----
        if lookup_n is not None:
            drafts = _lookup_drafts(hist, P + n_gen, total, n=lookup_n, k=k)
            # a deterministic draft is a point mass q at the drafted token
            qd = (F.one_hot(drafts, V).float() if gen.do_sample
                  else torch.zeros((k, V), device=dev))
        else:
            tok, pres, drafts, qs = pending, presence.clone(), [], []
            for j in range(k):
                logit, d_cache = _feed(d_params, d_cfg, tok.view(1, 1),
                                       length + j, d_cache, total)
                if gen.do_sample:
                    q = _processed_probs(logit, pres[None], gen)[0]
                    nxt = _draw(q, generator)
                else:
                    q = torch.zeros((V,), device=dev)
                    pl = apply_repetition_penalty(logit, pres[None],
                                                  gen.repetition_penalty)
                    nxt = torch.argmax(pl[-1])
                pres[nxt] = True
                drafts.append(nxt)
                qs.append(q)
                tok = nxt
            drafts, qd = torch.stack(drafts), torch.stack(qs)
            # KV-only feed of d_k, so a fully accepted round (m == k) leaves
            # no hole in the draft cache: the steps fed [pending, d1 ..
            # d_{k-1}], and d_k's row falls inside every later window
            _, d_cache = _feed(d_params, d_cfg, drafts[-1].view(1, 1),
                               length + k, d_cache, total, skip_logits=True)

        # ---- verify: ONE target forward over [pending, d1..dk] ----
        seq = torch.cat([pending.view(1), drafts])[None]      # [1, k+1]
        t_logits, t_cache = _feed(t_params, t_cfg, seq, length, t_cache,
                                  total)
        # presence at verify position i includes d_1..d_i
        cum = torch.cumsum(F.one_hot(drafts, V), dim=0)
        pres_rows = presence[None] | torch.cat(
            [torch.zeros((1, V), dtype=cum.dtype, device=dev), cum]).bool()
        if gen.do_sample:
            pt = _processed_probs(t_logits, pres_rows, gen)   # [k+1, V]
            u = torch.rand((k,), generator=generator, device=dev)
            ratio = pt[j_k, drafts] / torch.clamp(qd[j_k, drafts], min=1e-30)
            m = torch.cumprod((u < ratio).long(), dim=0).sum()
            # extension: the residual on a rejection, p_{k+1} on full accept
            pm = pt.index_select(0, torch.clamp(m, max=k).view(1))[0]
            qm = qd.index_select(0, torch.clamp(m, max=k - 1).view(1))[0]
            dist = torch.where(m < k, torch.clamp(pm - qm, min=0.0), pt[k])
            # numeric guard: a vanished residual falls back to p_m
            dist = torch.where(dist.sum() > 1e-20, dist, pm)
            ext = _draw(dist, generator)
        else:
            pl = apply_repetition_penalty(t_logits, pres_rows,
                                          gen.repetition_penalty)
            g = torch.argmax(pl, dim=-1)                      # [k+1]
            m = torch.cumprod((drafts == g[:k]).long(), dim=0).sum()
            ext = g.index_select(0, m.view(1))[0]

        # emit the accepted drafts and the extension / correction token
        emit = torch.where(j_w < m, torch.cat([drafts, drafts[-1:]]),
                           torch.where(j_w == m, ext, pad))
        on = j_w <= m
        presence |= (F.one_hot(emit, V).bool() & on[:, None]).any(dim=0)
        eos_hit = (on & (emit == eos)).any()
        window = tokens[n_gen:n_gen + k + 1]
        window.copy_(torch.where(on, emit, window))
        if lookup_n is not None:  # extend the lookup history
            hwin = hist[P + n_gen:P + n_gen + k + 1]
            hwin.copy_(torch.where(on, emit, hwin))
        # the round's one read back: accepted drafts and EOS
        m_host, eos_host = torch.stack([m, eos_hit.long()]).tolist()
        n_gen += m_host + 1
        length += 1 + m_host
        n_rounds += 1
        n_accepted += m_host
        done = bool(eos_host)
        pending = ext

    out = tokens[:T]
    # pad everything after the first EOS (HF generate semantics)
    is_eos = (out == eos).long()
    after = torch.cumsum(torch.cumsum(is_eos, 0), 0) > 1
    return torch.where(after, pad, out)[None], n_rounds, n_accepted


def _default_generator(params, generator):
    return (generator if generator is not None else
            torch.Generator(device=params["embed"].device).manual_seed(0))


def generate_speculative(
    target_params, target_cfg,
    draft_params, draft_cfg,
    input_ids=None,           # [1, P] unpadded prompt ids
    gen: GenerationConfig = None,
    k: int = 4,
    generator: Optional[torch.Generator] = None,
    return_stats: bool = False,
    inputs_embeds=None,       # [1, P, H] fusion prompt; the draft must share
    #                           the target's embedding space (the int8
    #                           self-draft does)
):
    """Speculative decode on the device of ``target_params``; returns [1,
    max_new_tokens] token ids (greedy: token-exact against target-only
    greedy; sampled: distribution-exact). With ``return_stats`` also
    (n_rounds, n_accepted_drafts)."""
    ref = inputs_embeds if inputs_embeds is not None else input_ids
    assert ref is not None and ref.shape[0] == 1, \
        "single-stream (B=1) speculation"
    out, n_rounds, n_acc = _spec_impl(
        target_params, draft_params, input_ids, inputs_embeds,
        _default_generator(target_params, generator), t_cfg=target_cfg,
        d_cfg=draft_cfg, gen=gen, k=k)
    if return_stats:
        return out, n_rounds, n_acc
    return out


def generate_lookup(
    target_params, target_cfg,
    input_ids,                # [1, P] unpadded prompt ids (REQUIRED: the
    #                           lookup history matches on token ids)
    gen: GenerationConfig = None,
    k: int = 8,
    n: int = 3,
    generator: Optional[torch.Generator] = None,
    return_stats: bool = False,
    inputs_embeds=None,       # [1, P, H] fusion prompt; ids still required
):
    """Prompt-lookup (n-gram) speculative decode, no draft model: the last
    ``n`` tokens are matched against the history and the ``k`` tokens after
    their most recent earlier occurrence are verified in one target forward.
    Greedy: token-exact against target-only greedy. Sampled:
    distribution-exact (point-mass q rejection sampling). A missed draft
    costs about one decode step; spans the model copies from its history
    decode up to (k+1)x faster."""
    assert input_ids is not None and input_ids.shape[0] == 1, \
        "single-stream (B=1) lookup speculation with prompt ids"
    assert input_ids.shape[1] >= n, "prompt shorter than the lookup n-gram"
    out, n_rounds, n_acc = _spec_impl(
        target_params, None, input_ids, inputs_embeds,
        _default_generator(target_params, generator), t_cfg=target_cfg,
        d_cfg=None, gen=gen, k=k, lookup_n=n)
    if return_stats:
        return out, n_rounds, n_acc
    return out
