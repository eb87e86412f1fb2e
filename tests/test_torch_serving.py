"""The port's continuous-batching slice held against molly_tpu on the CPU, in
fp32, from the same numpy weights and requests: the row-wise sampler, the
int8 dense KV cache (quantizer, attention read, one decode step), the
multi-LoRA bank lookup, ``ServingEngine`` (greedy results token-exact, the
scheduler's ``stats`` equal but for ``fetch_wait_s``) and the ``--serve`` /
``--kv-int8`` CLI record for record. Tolerances: quantizer scales 1e-7, ops
and one decode step 1e-5, sampler logits 1e-6. Sampled rows cannot match
token for token (``torch.Generator`` and ``jax.random`` draw different
streams); they are compared through their filtered candidates.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.inference import sampling as jsampling
from molly_tpu.inference.engine import GenerationConfig
from molly_tpu.inference.server import Request as JRequest
from molly_tpu.inference.server import ServingEngine as JServingEngine
from molly_tpu.models import fusion as jfusion
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.models import tiny_esm, tiny_qwen3
from molly_tpu.models.fusion import FusionConfig
from molly_tpu.ops import attention as jattention
from molly_tpu_torch.inference import cli, sampling, server
from molly_tpu_torch.inference.server import Request, ServingEngine
from molly_tpu_torch.models import lora, qwen3
from molly_tpu_torch.models.convert import params_from_jax
from molly_tpu_torch.ops import attention
from test_torch_models import _np_tree, _tcfg_of

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def serving_setup():
    """The JAX serving tests' tiny config (2 layers, hidden 32, head_dim 8)
    with numpy-seeded weights wide enough that greedy tokens vary: (JAX
    config, JAX params, port config, port params)."""
    cfg = FusionConfig(
        text=tiny_qwen3(vocab_size=64, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=8),
        dna_rna=tiny_esm(vocab_size=16),
        protein=tiny_esm(vocab_size=20),
        dna_rna_k_tokens=4, protein_k_tokens=4)
    tree = _np_tree(jfusion.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    text = tree["text"]
    text["embed"] = rng.normal(size=text["embed"].shape).astype(np.float32)
    for name, w in text["layers"].items():
        if w.ndim == 3:  # the stacked linears, not the norms
            text["layers"][name] = (rng.normal(size=w.shape) *
                                    w.shape[1] ** -0.5).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return cfg, jparams, _tcfg_of(cfg), params_from_jax(tree)


@pytest.fixture(scope="module")
def setup():
    return serving_setup()


def text_batch(S, seed, vocab=64):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, vocab, (1, S)).astype(np.int32),
            "attention_mask": np.ones((1, S), np.int32)}


def fusion_batch(S=14, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(1, 64, (1, S)).astype(np.int32),
        "attention_mask": np.ones((1, S), np.int32),
        "dna_rna_tokens": rng.integers(2, 16, (1, 1, 4)).astype(np.int32),
        "dna_rna_pos": np.asarray([[2]], np.int32),
        "protein_tokens": np.full((1, 1, 4), 1, np.int32),
        "protein_pos": np.asarray([[-1]], np.int32),
    }


def both(specs):
    """The same requests for both engines from (uid, batch, kwargs)."""
    return ([JRequest(uid=u, batch=dict(b), **kw) for u, b, kw in specs],
            [Request(uid=u, batch=dict(b), **kw) for u, b, kw in specs])


def assert_same_run(jeng, teng, specs, *, int8_flips=None):
    """Run both engines on the same requests: the same uids, token-exact
    results and equal scheduler stats (all but the host's fetch time)."""
    jreqs, treqs = both(specs)
    ref = jeng.run(jreqs)
    got = teng.run(treqs)
    assert set(got) == set(ref)
    flips = 0
    for uid in ref:
        assert len(got[uid]) == len(ref[uid]), uid
        flips += int(np.sum(np.asarray(got[uid]) != np.asarray(ref[uid])))
    if int8_flips is None:
        assert flips == 0, {u: (got[u], ref[u]) for u in ref}
    else:
        print(f"int8 greedy flips against the JAX engine: {flips}")
        assert flips <= int8_flips, flips
    jstats = {k: v for k, v in jeng.stats.items() if k != "fetch_wait_s"}
    tstats = {k: v for k, v in teng.stats.items() if k != "fetch_wait_s"}
    assert tstats == jstats
    return ref, got


def greedy_gen(T, penalty=1.1, eos=-1):
    return GenerationConfig(max_new_tokens=T, do_sample=False,
                            repetition_penalty=penalty, eos_token_id=eos,
                            pad_token_id=0)


# ---------------------------------------------------------------- sampler


def _rowwise_inputs(seed=0, B=5, V=64):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    presence = rng.random((B, V)) < 0.2
    samp = {"greedy": np.array([True, False, False, True, False]),
            "temperature": np.array([1.0, 0.8, 1.3, 1e-6, 0.5], np.float32),
            "top_k": np.array([1, 8, 3, 8, 5], np.int32),
            "top_p": np.array([1.0, 0.95, 0.5, 0.9, 0.7], np.float32),
            "repetition_penalty": np.array([1.0, 1.1, 1.3, 1.2, 1.0],
                                           np.float32)}
    return logits, presence, samp


@pytest.mark.parametrize("max_top_k", [8, 0])
def test_rowwise_sampler_filters_like_jax(max_top_k):
    """Greedy rows equal the JAX sampler's tokens; for sampled rows the
    candidates that survive penalty -> temperature -> top-k -> top-p and
    their logits equal the JAX processors' (recomputed here row by row with
    the JAX package's own filters), and draws stay inside them."""
    logits, presence, samp = _rowwise_inputs()
    jsamp = {k: jnp.asarray(v) for k, v in samp.items()}
    tsamp = {k: _t(v).long() if v.dtype == np.int32 else _t(v)
             for k, v in samp.items()}
    ref_tok = np.asarray(jsampling.sample_tokens_rowwise(
        jnp.asarray(logits), jax.random.key(0), jsamp, jnp.asarray(presence),
        max_top_k=max_top_k))
    g = torch.Generator().manual_seed(0)
    tok = sampling.sample_tokens_rowwise(_t(logits), g, tsamp, _t(presence),
                                         max_top_k=max_top_k).numpy()
    greedy = samp["greedy"]
    np.testing.assert_array_equal(tok[greedy], ref_tok[greedy])
    _, vals, idx = sampling.filter_logits_rowwise(
        _t(logits), tsamp, _t(presence), max_top_k=max_top_k)
    got = np.full_like(logits, float(sampling.NEG_INF))
    if idx is None:
        got = vals.numpy()
    else:
        np.put_along_axis(got, idx.numpy(), vals.numpy(), axis=1)
    for b in np.nonzero(~greedy)[0]:
        row = jsampling.apply_repetition_penalty(
            jnp.asarray(logits[b:b + 1]), jnp.asarray(presence[b:b + 1]),
            float(samp["repetition_penalty"][b])) / float(
                samp["temperature"][b])
        if max_top_k:
            row = jsampling.top_k_filter(row, int(samp["top_k"][b]))
        ref = np.asarray(jsampling.top_p_filter(
            row, float(samp["top_p"][b])))[0]
        kept = ref > sampling.NEG_INF
        np.testing.assert_array_equal(got[b] > sampling.NEG_INF, kept)
        np.testing.assert_allclose(got[b][kept], ref[kept], atol=1e-6)
        for _ in range(10):
            t = sampling.sample_tokens_rowwise(
                _t(logits), g, tsamp, _t(presence), max_top_k=max_top_k)
            assert kept[int(t[b])]


# ---------------------------------------------------------------- int8 dense


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(1)
    kv = (rng.normal(size=(2, 3, 2, 5, 16)) * 3).astype(np.float32)
    kv[0, 0, 0, 0] = 0.0  # an all-zero row: the 1e-6 floor
    rq, rs = jqwen3.quantize_kv(jnp.asarray(kv))
    q8, sc = qwen3.quantize_kv(_t(kv))
    assert q8.dtype == torch.int8 and sc.shape == (2, 3, 2, 5, 2)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(rq))
    np.testing.assert_allclose(sc.numpy(), np.asarray(rs), atol=1e-7, rtol=0)


@pytest.mark.parametrize("sq,causal", [(1, False), (5, True)])
def test_plain_attention_kv_scales_matches_jax(sq, causal):
    """Reads of the int8 dense cache: the k scale on the logit column, the
    v scale folded into the softmax weights."""
    rng = np.random.default_rng(2)
    B, Nq, Nkv, Dh, Skv = 2, 4, 2, 8, 12
    q = rng.normal(size=(B, sq, Nq, Dh)).astype(np.float32)
    kv = (rng.normal(size=(B, Nkv, Skv, 2 * Dh)) * 2).astype(np.float32)
    q8, sc = jqwen3.quantize_kv(jnp.asarray(kv))
    q8, sc = np.asarray(q8), np.asarray(sc)
    mask = np.ones((B, Skv), np.int32)
    mask[1, :3] = 0
    off = Skv - sq
    ref = jattention._xla_attention(
        jnp.asarray(q), jnp.asarray(q8[..., :Dh]), jnp.asarray(q8[..., Dh:]),
        mask=jnp.asarray(mask), causal=causal, scale=None, q_offset=off,
        kv_layout="bnsd", kv_scales=jnp.asarray(sc))
    got = attention.dot_product_attention(
        _t(q), _t(q8[..., :Dh]), _t(q8[..., Dh:]), mask=_t(mask),
        causal=causal, q_offset=off, kv_layout="bnsd", kv_scales=_t(sc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_dense_int8_decode_step_matches_jax(setup):
    """One prefill and one decode step of ``forward_hidden`` over the int8
    dense cache: hidden states to 1e-5, the cache and its scales compared
    after the writes."""
    cfg, jp, tcfg, tp = setup
    rng = np.random.default_rng(4)
    B, S, T = 3, 6, 10
    ids = rng.integers(1, 64, (B, S + 1)).astype(np.int32)
    jc = jqwen3.init_cache(cfg.text, B, T, quant="int8")
    tc = qwen3.init_cache(tcfg.text, B, T, quant="int8")
    assert tc["kv"].dtype == torch.int8
    assert tuple(tc["kv_scale"].shape) == jc["kv_scale"].shape
    mask = np.zeros((B, T), np.int32)
    mask[:, :S] = 1
    jh, jc = jqwen3.forward_hidden(
        jp["text"], cfg.text, input_ids=jnp.asarray(ids[:, :S]),
        attention_mask=jnp.asarray(mask), cache=jc, cache_index=0)
    th, tc = qwen3.forward_hidden(
        tp["text"], tcfg.text, input_ids=_t(ids[:, :S]).long(),
        attention_mask=_t(mask), cache=tc, cache_index=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    mask[:, S] = 1
    pos = np.full((B, 1), S, np.int32)
    jh, jc = jqwen3.forward_hidden(
        jp["text"], cfg.text, input_ids=jnp.asarray(ids[:, S:]),
        attention_mask=jnp.asarray(mask), positions=jnp.asarray(pos),
        cache=jc, cache_index=S, causal=False)
    th, tc = qwen3.forward_hidden(
        tp["text"], tcfg.text, input_ids=_t(ids[:, S:]).long(),
        attention_mask=_t(mask), positions=_t(pos), cache=tc, cache_index=S,
        causal=False)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    diff = np.abs(tc["kv"].numpy().astype(np.int32)
                  - np.asarray(jc["kv"]).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3  # rounding ties
    np.testing.assert_allclose(tc["kv_scale"].numpy(),
                               np.asarray(jc["kv_scale"]), atol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        qwen3.forward_hidden(
            tp["text"], tcfg.text, input_ids=_t(ids[:, S:]).long(),
            attention_mask=_t(mask), positions=_t(pos), cache=tc,
            cache_index=torch.full((B,), S), causal=False)


# ---------------------------------------------------------------- lora bank


def test_lora_slots_bank_matches_jax():
    """apply_lora / apply_lora_fused with a stacked bank and per-row adapter
    ids against the JAX functions."""
    from molly_tpu.models import lora as jlora
    rng = np.random.default_rng(5)
    B, S, d, r, o, N = 3, 2, 8, 2, 6, 3
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    base = rng.normal(size=(B, S, o)).astype(np.float32)
    bank = {"a": rng.normal(size=(N, d, r)).astype(np.float32),
            "b": rng.normal(size=(N, r, o)).astype(np.float32)}
    slots = np.array([2, 0, 1], np.int32)
    ref = jlora.apply_lora(jnp.asarray(x), jnp.asarray(base),
                           {k: jnp.asarray(v) for k, v in bank.items()}, 1.0,
                           lora_slots=jnp.asarray(slots))
    got = lora.apply_lora(_t(x), _t(base), {k: _t(v) for k, v in bank.items()},
                          1.0, lora_slots=_t(slots))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    fused = rng.normal(size=(B, S, 2 * o)).astype(np.float32)
    parts = (("q_proj", o), ("k_proj", o))
    ref = jlora.apply_lora_fused(
        jnp.asarray(x), jnp.asarray(fused),
        {"k_proj": {k: jnp.asarray(v) for k, v in bank.items()}}, parts, 1.0,
        lora_slots=jnp.asarray(slots))
    got = lora.apply_lora_fused(
        _t(x), _t(fused), {"k_proj": {k: _t(v) for k, v in bank.items()}},
        parts, 1.0, lora_slots=_t(slots))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


# ---------------------------------------------------------------- the engine


def test_pad_to_bucket_matches_jax():
    from molly_tpu.inference.server import _pad_to_bucket as jpad
    b = fusion_batch()
    for side in ("left", "right"):
        ref, got = jpad(b, 16, 7, side), server._pad_to_bucket(b, 16, 7, side)
        assert set(ref) == set(got)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_serving_mixed_lengths_fusion_and_slot_reuse(setup):
    """Mixed prompt lengths over three buckets, a fusion (omics-injected)
    prompt, per-request caps and more requests than slots, so that slots
    backfill; chunked decode."""
    cfg, jp, tcfg, tp = setup
    gen = greedy_gen(8)
    specs = [(i, text_batch(s, seed=i), {}) for i, s in
             enumerate([5, 12, 20, 7])]
    specs.append(("omics", fusion_batch(), {}))
    specs += [(f"r{i}", text_batch(6 + i, seed=10 + i),
               {"max_new_tokens": 3 + (i % 4)}) for i in range(5)]
    kw = dict(n_slots=3, max_len=64, prefill_buckets=(8, 16, 32),
              decode_chunk=3, admit_batch=2)
    ref, got = assert_same_run(JServingEngine(jp, cfg, gen, **kw),
                               ServingEngine(tp, tcfg, _tcfg_of(gen), **kw),
                               specs)
    assert len({int(t) for v in got.values() for t in v}) > 8  # tokens vary
    assert all(len(got[f"r{i}"]) == 3 + (i % 4) for i in range(5))


def test_serving_prefix_cache_and_eos(setup):
    """A shared prompt prefix (its KV computed once, every request prefills
    its suffix only: the flash call has q_offset = s_pre) and EOS
    termination that frees a slot."""
    cfg, jp, tcfg, tp = setup
    rng = np.random.default_rng(6)
    prefix = rng.integers(1, 64, 9).astype(np.int32)
    specs = []
    for i, s in enumerate([3, 7, 5]):
        ids = np.concatenate(
            [prefix[None], rng.integers(1, 64, (1, s)).astype(np.int32)], 1)
        specs.append((i, {"input_ids": ids,
                          "attention_mask": np.ones_like(ids)}, {}))
    kw = dict(n_slots=2, max_len=48, prefill_buckets=(8,), prefix_ids=prefix)
    probe = ServingEngine(tp, tcfg, _tcfg_of(greedy_gen(6)), **kw).run(
        both(specs)[1])
    gen = greedy_gen(6, eos=int(probe[0][2]))
    teng = ServingEngine(tp, tcfg, _tcfg_of(gen), **kw)
    assert teng.s_pre == 9
    ref, got = assert_same_run(JServingEngine(jp, cfg, gen, **kw), teng,
                               specs)
    assert len(got[0]) <= 3
    with pytest.raises(ValueError, match="prefix"):
        ServingEngine(tp, tcfg, _tcfg_of(gen), **kw).run(
            [Request(uid=0, batch=text_batch(12, seed=3))])


def test_serving_int8_kv_ring(setup):
    cfg, jp, tcfg, tp = setup
    gen = greedy_gen(6, penalty=1.0)
    specs = [(i, text_batch(s, seed=20 + i), {}) for i, s in
             enumerate([5, 12, 7])]
    kw = dict(n_slots=3, max_len=48, prefill_buckets=(16,), kv_quant="int8")
    teng = ServingEngine(tp, tcfg, _tcfg_of(gen), **kw)
    assert teng.hot["cache"].dtype == torch.int8
    assert_same_run(JServingEngine(jp, cfg, gen, **kw), teng, specs,
                    int8_flips=3)


def test_serving_multi_lora_bank(setup):
    """One slot pool, three requests on three adapters (0 = base), on the
    unfused and on the fused (qkv_proj / gateup_proj) decode weights."""
    from molly_tpu.models import lora as jlora
    cfg, jp, tcfg, tp = setup
    gen = greedy_gen(6)
    rng = np.random.default_rng(7)
    dims = lora.target_dims(tcfg.text)
    adapters = [{"layers": {t: {
        "a": (rng.normal(size=(2, dims[t][0], 4)) / 4).astype(np.float32),
        "b": (rng.normal(size=(2, 4, dims[t][1])) * 0.5).astype(np.float32),
    } for t in lora.LORA_TARGETS}} for _ in range(2)]
    jbank = jlora.stack_adapters(
        [jax.tree.map(jnp.asarray, a) for a in adapters], scales=[2.0, 2.0])
    tbank = lora.stack_adapters(
        [params_from_jax(a) for a in adapters], scales=[2.0, 2.0])
    specs = [(i, text_batch(6 + i, seed=60 + i), {"adapter": i})
             for i in range(3)]
    kw = dict(n_slots=3, max_len=48, prefill_buckets=(16,))
    ref, got = assert_same_run(
        JServingEngine(jp, cfg, gen, lora_bank=jbank, **kw),
        ServingEngine(tp, tcfg, _tcfg_of(gen), lora_bank=tbank, **kw), specs)
    base = ServingEngine(tp, tcfg, _tcfg_of(gen), **kw).run(both(specs)[1])
    np.testing.assert_array_equal(got[0], base[0])  # adapter 0 = base model
    assert any(not np.array_equal(got[i], base[i]) for i in (1, 2))
    fused = {**tp, "text": qwen3.quantize_for_decode(tp["text"], tcfg.text)}
    jfused = {**jp, "text": jqwen3.quantize_for_decode(jp["text"], cfg.text)}
    assert_same_run(
        JServingEngine(jfused, cfg, gen, lora_bank=jbank, **kw),
        ServingEngine(fused, tcfg, _tcfg_of(gen), lora_bank=tbank, **kw),
        specs)


def test_serving_per_request_sampling_and_logprobs(setup):
    """Greedy overrides inside a sampling-default pool equal the JAX
    engine's greedy rows; a sampled row runs to its cap; chosen-token
    logprobs of the greedy rows agree to 1e-5."""
    cfg, jp, tcfg, tp = setup
    gen = GenerationConfig(max_new_tokens=6, do_sample=True, temperature=0.8,
                           top_k=8, top_p=0.95, repetition_penalty=1.1,
                           eos_token_id=-1, pad_token_id=0)
    specs = [(0, text_batch(6, seed=40), {"sampling": {"temperature": 0}}),
             (1, text_batch(7, seed=41), {"sampling": {"greedy": True}}),
             (2, text_batch(8, seed=42), {})]
    kw = dict(n_slots=3, max_len=48, prefill_buckets=(16,), logprobs=True)
    jeng = JServingEngine(jp, cfg, gen, **kw)
    teng = ServingEngine(tp, tcfg, _tcfg_of(gen), **kw)
    jreqs, treqs = both(specs)
    ref, got = jeng.run(jreqs), teng.run(treqs)
    for uid in (0, 1):
        np.testing.assert_array_equal(got[uid], ref[uid])
        np.testing.assert_allclose(teng.pop_logprobs(uid),
                                   jeng.pop_logprobs(uid), atol=ATOL)
    assert len(got[2]) == 6 and teng.pop_logprobs(2).shape == (6,)
    assert teng.pop_logprobs(2) is None  # popped


def test_serving_stream_cancel_and_precompile(setup):
    """stream_cb delivers monotone prefixes; cancel() force-finishes an
    in-flight request (its partial output is a prefix of the uncancelled
    decode) and drops a queued one; the freed slot backfills; precompile()
    is a warm-up that leaves no trace in the state."""
    cfg, jp, tcfg, tp = setup
    gen = _tcfg_of(greedy_gen(12, penalty=1.0))
    kw = dict(n_slots=1, max_len=48, prefill_buckets=(16,), decode_chunk=2)
    specs = [(i, text_batch(6 + i, seed=1 + i), {}) for i in range(3)]
    full = ServingEngine(tp, tcfg, gen, **kw).run(both(specs)[1])
    streamed, canceled = {}, []

    def cb(uid, toks):
        prev = streamed.setdefault(uid, [])
        if prev:
            np.testing.assert_array_equal(prev[-1], toks[:len(prev[-1])])
        prev.append(np.array(toks))
        if uid == 0 and len(toks) >= 2 and not canceled:
            canceled.append(uid)
            eng.cancel(0)

    eng = ServingEngine(tp, tcfg, gen, stream_cb=cb, **kw)
    eng.precompile()
    assert eng.stats["rounds"] == 0 and not any(eng._slot_uid)
    assert not bool(eng.cold["active"].any())
    for r in both(specs)[1]:
        eng.submit(r)
    eng.cancel(2)  # still queued -> dropped, empty result
    results = eng.run([])
    assert set(results) == {0, 1, 2}
    assert 2 <= len(results[0]) < 12
    np.testing.assert_array_equal(results[0], full[0][:len(results[0])])
    np.testing.assert_array_equal(results[1], full[1])
    assert len(results[2]) == 0
    for uid in (0, 1):
        np.testing.assert_array_equal(streamed[uid][-1], results[uid])


def test_cold_rows_are_never_written_in_place(setup):
    """The scheduler harvests from a cold snapshot that is one chunk old: a
    dispatch must hand back NEW cold tensors and leave the old ones as they
    were, while the hot buffers are the same storage, updated in place."""
    cfg, jp, tcfg, tp = setup
    eng = ServingEngine(tp, tcfg, _tcfg_of(greedy_gen(6)), n_slots=2,
                        max_len=48, prefill_buckets=(16,), decode_chunk=2)
    for r in both([(i, text_batch(6, seed=i), {}) for i in range(2)])[1]:
        eng.submit(r)
    eng.step()  # admits both and runs a chunk
    eng.step()  # the stale snapshot predates them: confirms, no dispatch
    before = {k: (v, v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in eng.cold.items()}
    hot_ptrs = {k: v.data_ptr() for k, v in eng.hot.items()}
    eng.step()
    for k, (old, copy) in before.items():
        if isinstance(old, torch.Tensor):
            assert torch.equal(old, copy), k
    assert not torch.equal(before["out_len"][0], eng.cold["out_len"])
    assert {k: v.data_ptr() for k, v in eng.hot.items()} == hot_ptrs


def assert_released_without_gc(make_engine, pool_key):
    """Build an engine, serve one request, drop the engine: the engine and
    its KV pool must die by reference counting alone (no cycle through the
    engine), so a card gets its memory back without a collection."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        eng = make_engine()
        out = eng.run([Request(uid=0, batch=text_batch(6, seed=1))])
        assert len(out[0]) > 0
        pool_ref = weakref.ref(eng.hot[pool_key])
        eng_ref = weakref.ref(eng)
        del eng
        assert eng_ref() is None, "the engine sits in a reference cycle"
        assert pool_ref() is None, "the KV pool outlives its engine"
    finally:
        gc.enable()


def test_dropped_engine_frees_its_pool_without_gc(setup):
    cfg, jp, tcfg, tp = setup
    assert_released_without_gc(
        lambda: ServingEngine(tp, tcfg, _tcfg_of(greedy_gen(4)), n_slots=2,
                              max_len=48, prefill_buckets=(16,),
                              decode_chunk=2, time_phases=True,
                              stream_cb=lambda uid, toks: None), "cache")


# ---------------------------------------------------------------- CLI


def _jax_weights(args, cfg, device):
    # the JAX CLI's tiny weights: fusion.init_params(cfg, key(0))
    from test_torch_generate import _jax_cfg
    jcfg = jfusion.FusionConfig(
        **{f: getattr(cfg, f) for f in ("dna_rna_k_tokens",
                                        "protein_k_tokens")},
        **{f: _jax_cfg(getattr(cfg, f))
           for f in ("text", "dna_rna", "protein")})
    return params_from_jax(
        _np_tree(jfusion.init_params(jcfg, jax.random.key(0))), device)


@pytest.mark.parametrize("flags", [
    ["--serve", "--serve-chunk", "2"],
    ["--serve", "--serve-paged", "--page-size", "32", "--serve-chunk", "2"],
    ["--kv-int8"],
], ids=["serve", "serve-paged", "kv-int8"])
def test_cli_serving_jsonl_matches_jax_cli(tmp_path, monkeypatch, flags):
    """Both CLIs on the same toy parquet (--tiny, greedy) with the same
    weights write the same JSONL records, for the dense ring, the paged
    engine and the batch engine over an int8 KV cache."""
    from test_train_cli import _toy_parquet

    from molly_tpu.inference.cli import main as jax_main

    data = str(tmp_path / "d.parquet")
    _toy_parquet(data, 5)
    common = ["--input-file", data, "--tiny", "--greedy",
              "--max-length", "256", "--max-new-tokens", "5",
              "--dna-rna-k-tokens", "4", "--protein-k-tokens", "4",
              "--batch-size", "3"] + flags
    jax_out, torch_out = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jax_main(common + ["--output-file", jax_out])
    monkeypatch.setattr(cli, "_load_params", _jax_weights)
    cli.main(common + ["--output-file", torch_out, "--device", "cpu"])
    ref = [json.loads(line) for line in open(jax_out)]
    got = [json.loads(line) for line in open(torch_out)]
    assert len(got) == len(ref) == 5
    assert got == ref


@pytest.mark.parametrize("flags,entry", [
    (["--offline-ring"], "offline.py"),
    (["--offline-ring", "--ring-spec", "4"], "offline.py"),
    (["--decoding", "lookup"], "speculative.py"),
    (["--api-serve"], "api_server.py"),
    (["--serve-adapter", "a=b"], "api_server.py"),
])
def test_cli_refuses_unported_flags(flags, entry):
    """The JAX CLI's flags whose paths are not ported parse, and stop with
    the ROADMAP.md entry that tracks them."""
    with pytest.raises(SystemExit, match="ROADMAP.md") as exc:
        cli.main(["--input-file", "none.parquet", "--output-file",
                  "none.jsonl", "--tiny", "--device", "cpu"] + flags)
    assert entry in str(exc.value)


def test_cli_parses_the_jax_cli_flags_and_loads_peft_adapter(tmp_path):
    """The port's batch CLI parses exactly the JAX CLI's flags (plus
    ``--device``), the five that only parse with the JAX CLI's defaults,
    and loads a ``--peft-adapter`` directory (merged once at load, alpha
    from its adapter_config.json)."""
    from molly_tpu.inference.cli import build_argparser as jparser
    from molly_tpu_torch.data import (default_modality_tokenizers,
                                      load_text_tokenizer)
    from molly_tpu_torch.models import fusion
    from molly_tpu_torch.models.hf_export import (peft_lora_to_hf_state,
                                                  write_safetensors)
    from molly_tpu_torch.models.lora import (LoraConfig, init_lora,
                                             merge_lora)

    def flags(p):
        return {a.dest: a.default for a in p._actions if a.dest != "help"}

    jf, tf = flags(jparser()), flags(cli.build_argparser())
    assert set(tf) - set(jf) == {"device"}
    assert set(jf) <= set(tf)
    for dest in ("peft_adapter", "lookup_k", "lookup_n", "host", "port"):
        assert tf[dest] == jf[dest]
    args = cli.build_argparser().parse_args(
        ["--input-file", "x", "--output-file", "y", "--tiny",
         "--peft-adapter", str(tmp_path)])
    cli.refuse_unported(args)  # no longer refused
    cfg = cli.build_config(args, load_text_tokenizer(None),
                           *default_modality_tokenizers())
    g = torch.Generator().manual_seed(0)
    adapter = init_lora(cfg.text, LoraConfig(r=4), g)
    adapter["layers"] = {t: {"a": ab["a"], "b": ab["b"] + 0.01}
                         for t, ab in adapter["layers"].items()}
    write_safetensors(str(tmp_path / "adapter_model.safetensors"),
                      peft_lora_to_hf_state(adapter, cfg.text))
    with open(tmp_path / "adapter_config.json", "w") as f:
        f.write('{"r": 4, "lora_alpha": 8}')
    params = cli._load_params(args, cfg, "cpu")
    base = fusion.init_params(
        cfg, torch.Generator().manual_seed(args.seed))
    want = merge_lora(base["text"], adapter, LoraConfig(r=4, alpha=8.0))
    for name, w in want["layers"].items():
        assert torch.equal(params["text"]["layers"][name], w), name
    assert not torch.equal(params["text"]["layers"]["q_proj"],
                           base["text"]["layers"]["q_proj"])
    args = cli.build_argparser().parse_args(
        ["--input-file", "a", "--output-file", "b", "--lookup-k", "4",
         "--lookup-n", "2", "--host", "0.0.0.0", "--port", "9000"])
    cli.refuse_unported(args)  # parsed only
    assert (args.lookup_k, args.lookup_n, args.host, args.port) == (
        4, 2, "0.0.0.0", 9000)
