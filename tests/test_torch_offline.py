"""The port's admission ring (``inference.offline``) held against molly_tpu's
``run_offline`` and the port's own ``ServingEngine`` on the CPU, in fp32,
from the same numpy-seeded weights and queues. The JAX ring is compiled
four times (fp32 KV, int8 KV, prompt-lookup speculation, an MoE decoder
over int8 experts), each run covering fusion prompts, per-request caps, an
EOS and a queue that is not a multiple of the admission group; the other
cases hold the port's ring against its own engine or plain ring. Greedy
tokens are exact; int8 KV allows 3 flipped tokens in all (rounding ties of
the quantizer, as ``test_torch_serving``); sampled rings are compared in
distribution with the JAX test's statistic (total variation within the
noise between two plain runs + 0.08).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.inference import offline as joffline
from molly_tpu.inference.engine import GenerationConfig as JGen
from molly_tpu.models import fusion as jfusion
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.models import tiny_esm, tiny_moe
from molly_tpu.models.fusion import FusionConfig
from molly_tpu_torch.inference import cli, offline
from molly_tpu_torch.inference.server import (Request, ServingEngine,
                                              _pad_to_bucket)
from molly_tpu_torch.models import qwen3
from molly_tpu_torch.models.configs import GenerationConfig
from molly_tpu_torch.models.convert import params_from_jax
from test_torch_models import _np_tree, _tcfg_of
from test_torch_serving import serving_setup

BUCKET, N_SLOTS, GROUP, T = 16, 4, 2, 8
INT8_FLIPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread, as the suite runs
    several workers side by side (a pool of threads a worker made each
    small op wait on the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gens(T, penalty=1.1, eos=-1, **kw):
    kw = dict(dict(max_new_tokens=T, do_sample=False,
                   repetition_penalty=penalty, eos_token_id=eos,
                   pad_token_id=0), **kw)
    return JGen(**kw), GenerationConfig(**kw)


def fusion_queue(n, seed):
    """n left-padded prompts in one bucket, each with a DNA segment, every
    other one a protein segment (padded no-segment rows otherwise):
    (ids, mask, omics, per-request batches)."""
    rng = np.random.default_rng(seed)
    rows, batches = [], []
    for i in range(n):
        s = int(rng.integers(8, BUCKET + 1))
        b = {"input_ids": rng.integers(1, 64, (1, s)).astype(np.int32),
             "attention_mask": np.ones((1, s), np.int32),
             "dna_rna_tokens": rng.integers(2, 16, (1, 1, 4)).astype(
                 np.int32),
             "dna_rna_pos": np.asarray([[int(rng.integers(0, s - 5))]],
                                       np.int32)}
        if i % 2:
            b["protein_tokens"] = np.full((1, 1, 4), 3, np.int32)
            b["protein_pos"] = np.asarray([[int(rng.integers(0, s - 5))]],
                                          np.int32)
        else:
            b["protein_tokens"] = np.full((1, 1, 4), 1, np.int32)
            b["protein_pos"] = np.asarray([[-1]], np.int32)
        batches.append(b)
        rows.append(_pad_to_bucket(b, BUCKET, 0))
    ids = np.concatenate([r["input_ids"] for r in rows])
    mask = np.concatenate([r["attention_mask"] for r in rows])
    omics = {k: np.concatenate([r[k] for r in rows])
             for k in ("dna_rna_tokens", "dna_rna_pos", "protein_tokens",
                       "protein_pos")}
    return ids, mask, omics, batches


def text_queue(n, seed):
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, BUCKET), np.int32)
    mask = np.zeros((n, BUCKET), np.int32)
    for i in range(n):
        s = int(rng.integers(4, BUCKET + 1))
        ids[i, BUCKET - s:] = rng.integers(1, 64, (s,))
        mask[i, BUCKET - s:] = 1
    return ids, mask


CAPS = np.asarray([1, 3, 8, 5, 2, 8, 8, 4, 8, 6, 8], np.int32)  # 11 rows


def engine_run(tp, tcfg, gen, batches, caps, max_len, kv_quant=None):
    eng = ServingEngine(tp, tcfg, gen, n_slots=N_SLOTS, max_len=max_len,
                        prefill_buckets=(BUCKET,), kv_quant=kv_quant)
    return eng.run([Request(uid=i, batch=dict(b),
                            max_new_tokens=int(caps[i]))
                    for i, b in enumerate(batches)])


def rows_of(out):
    return [out["tokens"][i, :out["lengths"][i]]
            for i in range(len(out["lengths"]))]


def flips(got, ref):
    """Differing tokens over all requests; lengths must agree."""
    assert [len(g) for g in got] == [len(r) for r in ref]
    return sum(int(np.sum(np.asarray(g) != np.asarray(r)))
               for g, r in zip(got, ref))


@pytest.fixture(scope="module")
def ring():
    """The JAX ring's three dense runs on one fusion queue of 11 requests
    (caps, one EOS id the model emits, a dummy row to fill the last
    admission group), and the port's engine references."""
    cfg, jp, tcfg, tp = serving_setup()
    ids, mask, omics, batches = fusion_queue(11, 5)
    # an EOS the model emits mid-generation (from a run without one)
    _, probe_gen = gens(T)
    probe = engine_run(tp, tcfg, probe_gen, batches, CAPS, 64)
    eos = int(probe[2][2])
    jg, tg = gens(T, eos=eos)
    kw = dict(n_slots=N_SLOTS, admit_group=GROUP, queue_omics=omics)
    jax_runs = {
        "plain": joffline.run_offline(jp, cfg, jg, ids, mask, CAPS,
                                      max_len=64, **kw),
        "int8": joffline.run_offline(jp, cfg, jg, ids, mask, CAPS,
                                     max_len=64, kv_quant="int8", **kw),
        "spec": joffline.run_offline(jp, cfg, jg, ids, mask, CAPS,
                                     max_len=96, spec_lookup=4, **kw),
    }
    ref = engine_run(tp, tcfg, tg, batches, CAPS, 64)
    ref8 = engine_run(tp, tcfg, tg, batches, CAPS, 64, kv_quant="int8")
    return dict(cfg=cfg, jp=jp, tcfg=tcfg, tp=tp, ids=ids, mask=mask,
                omics=omics, batches=batches, jg=jg, tg=tg, eos=eos, kw=kw,
                jax=jax_runs, engine=[ref[i] for i in range(11)],
                engine8=[ref8[i] for i in range(11)])


def test_ring_matches_jax_and_engine(ring):
    """fp32 KV: token-exact against JAX's ring and the port's engine, every
    cap honoured, the EOS emitted and included, the dummy row dropped."""
    out = offline.run_offline(ring["tp"], ring["tcfg"], ring["tg"],
                              ring["ids"], ring["mask"], CAPS, max_len=64,
                              **ring["kw"])
    jout = ring["jax"]["plain"]
    got = rows_of(out)
    assert flips(got, rows_of(jout)) == 0
    assert flips(got, ring["engine"]) == 0
    np.testing.assert_array_equal(out["tokens"], jout["tokens"])
    assert (out["ticks"], out["decode_ticks"]) == (jout["ticks"],
                                                   jout["decode_ticks"])
    assert (out["lengths"] <= CAPS).all() and (out["lengths"] < CAPS).any()
    assert any(r[-1] == ring["eos"] for r in got)
    assert len({int(t) for r in got for t in r}) > 8  # tokens vary
    # one read back after each admission and each tick, one at the end
    assert out["host_syncs"] == out["decode_ticks"] + 6 + 2


def test_ring_int8_kv_matches_jax_and_engine(ring):
    out = offline.run_offline(ring["tp"], ring["tcfg"], ring["tg"],
                              ring["ids"], ring["mask"], CAPS, max_len=64,
                              kv_quant="int8", **ring["kw"])
    got = rows_of(out)
    for ref in (rows_of(ring["jax"]["int8"]), ring["engine8"]):
        assert all(g[0] == r[0] for g, r in zip(got, ref))
        assert flips(got, ref) <= INT8_FLIPS


def test_ring_spec_lookup_matches_jax_and_plain(ring):
    """Prompt-lookup speculation in the ring: the tokens of JAX's
    speculative ring and of the plain ring, with JAX's accepted count."""
    out = offline.run_offline(ring["tp"], ring["tcfg"], ring["tg"],
                              ring["ids"], ring["mask"], CAPS, max_len=96,
                              spec_lookup=4, **ring["kw"])
    jout = ring["jax"]["spec"]
    np.testing.assert_array_equal(out["tokens"], jout["tokens"])
    np.testing.assert_array_equal(out["lengths"], jout["lengths"])
    assert (out["accepted"], out["decode_ticks"]) == (
        jout["accepted"], jout["decode_ticks"])
    assert flips(rows_of(out), ring["engine"]) == 0


@pytest.mark.parametrize("thr", [0.2, 0.95])
def test_ring_adaptive_token_exact(ring, thr):
    """The acceptance-adaptive ring (speculation-mostly and plain-mostly
    thresholds, short chunks so the mode flips mid-request): the plain
    ticks write each row's own columns, so the tokens stay those of JAX's
    speculative ring and of the engine."""
    out = offline.run_offline(ring["tp"], ring["tcfg"], ring["tg"],
                              ring["ids"], ring["mask"], CAPS, max_len=96,
                              spec_lookup=4, spec_threshold=thr,
                              spec_chunk=3, **ring["kw"])
    np.testing.assert_array_equal(out["tokens"], ring["jax"]["spec"]["tokens"])
    assert flips(rows_of(out), ring["engine"]) == 0
    assert 0 <= out["spec_ticks"] <= out["decode_ticks"]
    assert out["spec_ema"] >= 0.0


def test_ring_spec_int8_kv_matches_plain_int8(ring):
    """Speculation over int8 KV: the same quantized columns as the plain
    int8 ring, caps and EOS included."""
    kw = dict(ring["kw"], max_len=96, kv_quant="int8")
    spec = offline.run_offline(ring["tp"], ring["tcfg"], ring["tg"],
                               ring["ids"], ring["mask"], CAPS,
                               spec_lookup=4, **kw)
    plain = offline.run_offline(ring["tp"], ring["tcfg"], ring["tg"],
                                ring["ids"], ring["mask"], CAPS, **kw)
    assert flips(rows_of(spec), rows_of(plain)) <= INT8_FLIPS
    assert flips(rows_of(spec), ring["engine8"]) <= INT8_FLIPS


def test_ring_text_queue_recycling(ring):
    """A text-only queue larger than the slots, not a multiple of the
    group, left-padded: every request gets its own engine output."""
    tp, tcfg = ring["tp"], ring["tcfg"]
    _, tg = gens(4)
    ids, mask = text_queue(11, 11)
    out = offline.run_offline(tp, tcfg, tg, ids, mask, n_slots=4,
                              max_len=32, admit_group=4)
    batches = [{"input_ids": ids[i:i + 1], "attention_mask": mask[i:i + 1]}
               for i in range(11)]
    ref = engine_run(tp, tcfg, tg, batches, [4] * 11, 32)
    assert flips(rows_of(out), [ref[i] for i in range(11)]) == 0


# ---------------------------------------------------------------- MoE


@pytest.fixture(scope="module")
def moe():
    cfg = FusionConfig(
        text=tiny_moe(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=8),
        dna_rna=tiny_esm(vocab_size=16), protein=tiny_esm(vocab_size=20),
        dna_rna_k_tokens=4, protein_k_tokens=4)
    tree = _np_tree(jfusion.init_params(cfg, jax.random.key(5)))
    rng = np.random.default_rng(3)
    text = tree["text"]
    text["embed"] = rng.normal(size=text["embed"].shape).astype(np.float32)
    for name, w in text["layers"].items():
        if w.ndim >= 3:
            text["layers"][name] = (rng.normal(size=w.shape)
                                    * w.shape[-2] ** -0.5).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tcfg = _tcfg_of(cfg)
    tp = params_from_jax(tree)
    return cfg, jp, tcfg, tp


def test_moe_ring_int8_experts_matches_jax_and_engine(moe):
    cfg, jp, tcfg, tp = moe
    jq = {**jp, "text": jqwen3.quantize_for_decode(jp["text"], cfg.text,
                                                   moe_experts=True)}
    tq = {**tp, "text": qwen3.quantize_for_decode(tp["text"], tcfg.text,
                                                  moe_experts=True)}
    jg, tg = gens(6)
    ids, mask = text_queue(6, 7)
    ref = joffline.run_offline(jq, cfg, jg, ids, mask, n_slots=2,
                               max_len=48, admit_group=2)
    out = offline.run_offline(tq, tcfg, tg, ids, mask, n_slots=2,
                              max_len=48, admit_group=2)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    batches = [{"input_ids": ids[i:i + 1], "attention_mask": mask[i:i + 1]}
               for i in range(6)]
    eng = ServingEngine(tq, tcfg, tg, n_slots=2, max_len=48,
                        prefill_buckets=(BUCKET,))
    res = eng.run([Request(uid=i, batch=b) for i, b in enumerate(batches)])
    assert flips(rows_of(out), [res[i] for i in range(6)]) == 0


def test_moe_ring_spec_lookup_token_exact(moe):
    """The (k+1)-wide verify runs the sparse FFN at S > 1 with per-row
    cache columns: the plain ring's tokens."""
    cfg, jp, tcfg, tp = moe
    _, tg = gens(8)
    ids, mask = text_queue(6, 11)
    plain = offline.run_offline(tp, tcfg, tg, ids, mask, n_slots=2,
                                max_len=64, admit_group=2)
    spec = offline.run_offline(tp, tcfg, tg, ids, mask, n_slots=2,
                               max_len=64, admit_group=2, spec_lookup=3)
    np.testing.assert_array_equal(spec["tokens"], plain["tokens"])


# ---------------------------------------------------------------- sampled


def test_ring_sampled_spec_distribution(ring):
    """Sampled in-ring speculation leaves the output distribution of the
    plain sampled ring (point-mass rejection rule): many requests share one
    prompt, per-position token frequencies compared."""
    tp, tcfg = ring["tp"], ring["tcfg"]
    _, tg = gens(3, do_sample=True, temperature=0.9, top_k=8, top_p=0.95)
    n, bucket = 512, 8
    ids = np.tile(np.arange(1, bucket + 1, dtype=np.int32), (n, 1))
    mask = np.ones((n, bucket), np.int32)
    kw = dict(n_slots=64, max_len=32, admit_group=64)

    def go(seed, **extra):
        return offline.run_offline(
            tp, tcfg, tg, ids, mask,
            generator=torch.Generator().manual_seed(seed), **kw, **extra)

    plain, plain2, spec = go(11), go(77), go(23, spec_lookup=3)
    assert (plain["lengths"] == 3).all() and (spec["lengths"] == 3).all()
    V = tcfg.text.vocab_size

    def tv(a, b, pos):
        fa = np.bincount(a["tokens"][:, pos], minlength=V) / n
        fb = np.bincount(b["tokens"][:, pos], minlength=V) / n
        return 0.5 * np.abs(fa - fb).sum()

    for pos in range(3):
        noise = tv(plain, plain2, pos)
        got = tv(plain, spec, pos)
        assert got < noise + 0.08, (pos, got, noise)


def test_ring_adaptive_flips_off_on_no_match(ring):
    """A sampled no-match workload (the 0.02 init's near-uniform
    distributions, sampled at temperature 1): the acceptance EMA decays
    below the threshold and most rounds run plain."""
    tcfg = ring["tcfg"]
    tp = params_from_jax(_np_tree(jfusion.init_params(ring["cfg"],
                                                      jax.random.key(0))))
    _, tg = gens(24, penalty=1.0, do_sample=True, temperature=1.0, top_k=0,
                 top_p=1.0)
    ids, mask = text_queue(16, 9)
    out = offline.run_offline(tp, tcfg, tg, ids, mask, n_slots=4,
                              max_len=96, admit_group=4, spec_lookup=4,
                              spec_threshold=0.3)
    assert (out["lengths"] == 24).all()
    assert out["spec_ema"] < 0.3, out["spec_ema"]
    assert 0 < out["spec_ticks"] < 0.5 * out["decode_ticks"], out


def test_spec_break_even_threshold_matches_jax():
    for args in ((1.0, 1.1, 8), (1.0, 2.1, 8), (1.0, 0.9, 8), (2.0, 5.0, 3),
                 (0.0, 1.0, 4)):
        assert offline.spec_break_even_threshold(*args) == \
            joffline.spec_break_even_threshold(*args)


def test_calibrate_spec_threshold_runs(ring):
    tp, tcfg = ring["tp"], ring["tcfg"]
    _, tg = gens(8, penalty=1.0)
    cal = offline.calibrate_spec_threshold(tp, tcfg, tg, n_slots=4,
                                           max_len=64, bucket=16, spec_k=4,
                                           cal_tokens=8)
    assert np.isfinite(cal["threshold"]) and cal["threshold"] >= 0.0
    assert cal["t_plain_tick"] > 0 and cal["t_spec_round"] > 0
    ids, mask = text_queue(4, 3)
    out = offline.run_offline(tp, tcfg, tg, ids, mask, n_slots=4,
                              max_len=64, spec_lookup=4,
                              spec_threshold=cal["threshold"])
    assert (out["lengths"] == 8).all()


# ---------------------------------------------------------------- CLI


def test_cli_offline_ring_jsonl_matches_jax_cli(tmp_path, monkeypatch,
                                                capsys):
    """``--offline-ring --ring-spec 3`` through both CLIs (--tiny, greedy,
    omics-tagged toy parquet, the same weights): the same records, and the
    summary line's fields."""
    from test_torch_serving import _jax_weights
    from test_train_cli import _toy_parquet

    from molly_tpu.inference.cli import main as jax_main

    data = str(tmp_path / "d.parquet")
    _toy_parquet(data, 6)
    common = ["--input-file", data, "--tiny", "--greedy",
              "--max-length", "256", "--max-new-tokens", "6",
              "--dna-rna-k-tokens", "4", "--protein-k-tokens", "4",
              "--batch-size", "3", "--offline-ring", "--serve-admit", "2",
              "--ring-spec", "3"]
    jax_out, torch_out = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jax_main(common + ["--output-file", jax_out])
    monkeypatch.setattr(cli, "_load_params", _jax_weights)
    capsys.readouterr()
    cli.main(common + ["--output-file", torch_out, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "[inference --offline-ring] 6/6 done in " in printed
    assert "host syncs" in printed
    ref = [json.loads(line) for line in open(jax_out)]
    got = [json.loads(line) for line in open(torch_out)]
    assert len(got) == 6 and got == ref
