"""The port's spans and counters (``molly_tpu_torch.utils.profiling``) on
the CPU: nothing recorded and no profiler range opened when nobody asks,
nesting and self time under a recording, the eval path's counts against
the same quantities worked out with numpy from the collated batch, tokens
bit-equal with the recorder on and off, the ``stats`` keys the engine and
the train step wrote before, and the ranges under ``torch.profiler``."""

import io

import numpy as np
import pytest
import torch

from molly_tpu_torch.data import (DataConfig, OmicsSampleEncoder,
                                  collate_test, collate_train,
                                  default_modality_tokenizers,
                                  load_text_tokenizer)
from molly_tpu_torch.inference import cli, engine
from molly_tpu_torch.models import fusion
from molly_tpu_torch.models.configs import (FusionConfig, GenerationConfig,
                                            tiny_esm, tiny_qwen3)
from molly_tpu_torch.training import trainer
from molly_tpu_torch.utils import profiling

K = 16
ROWS = [
    {"input": "What does <dna>ACGTACGTACGTAAACGGTTAC</dna> encode?",
     "output": "a gene"},
    {"input": "Fold <protein>MKTAYIAKQRQISFVKSHF</protein> next to "
              "<dna>ACGTTTGA</dna>, please", "output": "a helix"},
    {"input": "A question with no sequence at all", "output": "none"},
    {"input": "<rna>ACGTACGT</rna> and <protein>MKV</protein>",
     "output": "both"},
]


@pytest.fixture(scope="module")
def tiny():
    text_tok = load_text_tokenizer(None)
    dna_tok, prot_tok = default_modality_tokenizers()
    cfg = FusionConfig(
        text=tiny_qwen3(vocab_size=512, hidden_size=64,
                        intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        head_dim=16, dtype="float32"),
        dna_rna=tiny_esm(vocab_size=4107, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, dtype="float32",
                         mask_token_id=2),
        protein=tiny_esm(vocab_size=33, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, dtype="float32"),
        dna_rna_k_tokens=K, protein_k_tokens=K)
    enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=192, dna_rna_k_tokens=K, protein_k_tokens=K,
        max_dna_rna_segments=2, max_protein_segments=2))
    params = fusion.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, enc, params, text_tok


def _gen(text_tok, do_sample=False, new=5):
    return GenerationConfig(max_new_tokens=new, do_sample=do_sample,
                            temperature=0.8, top_k=20, top_p=0.95,
                            repetition_penalty=1.1,
                            eos_token_id=text_tok.eos_token_id,
                            pad_token_id=text_tok.pad_token_id)


def _fake_clock(monkeypatch, step=10):
    ticks = iter(range(0, 10 ** 6, step))
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(ticks))


# ---------------------------------------------------------------- recorder


def test_without_a_recorder_a_span_records_nothing_and_opens_no_range(
        monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    assert not profiling.active()
    a = profiling.span("molly/a")
    assert a is profiling.span("molly/b", device=True)
    assert a is profiling.sync("eos")
    with a, profiling.sync("eos", 3):
        profiling.count("host_syncs", 3)
    assert opened == []


def test_recording_nests_spans_and_takes_self_time(monkeypatch):
    _fake_clock(monkeypatch)
    stats = {}
    with profiling.recording(stats):
        assert profiling.active()
        with profiling.span("outer"):          # 0 .. 70
            with profiling.span("inner"):      # 10 .. 20
                pass
            with profiling.span("inner"):      # 30 .. 60
                with profiling.sync("eos", 2):  # 40 .. 50
                    pass
        profiling.count("things", 4)
        profiling.count("things", torch.tensor(3))
    assert not profiling.active()
    sp = stats["spans"]
    assert sp["outer"] == {"n": 1, "host_s": 70e-9, "self_host_s": 30e-9,
                           "sync_s": 10e-9, "device_s": None}
    assert sp["inner"] == {"n": 2, "host_s": 40e-9, "self_host_s": 30e-9,
                           "sync_s": 10e-9, "device_s": None}
    assert sp["molly/sync/eos"]["n"] == 1
    assert sp["molly/sync/eos"]["sync_s"] == 10e-9
    assert stats["counts"] == {"host_syncs": 2, "things": 7}


def test_a_recording_adds_to_stats_and_a_nested_one_is_the_outer(
        monkeypatch):
    _fake_clock(monkeypatch)
    stats, inner = {}, {}
    for _ in range(2):
        with profiling.recording(stats):
            with profiling.recording(inner):
                with profiling.span("s"):
                    profiling.count("c")
    assert inner == {}
    assert stats["spans"]["s"]["n"] == 2
    assert stats["spans"]["s"]["host_s"] == 20e-9
    assert stats["counts"] == {"c": 2}
    with pytest.raises(ValueError):
        with profiling.recording(stats):
            with profiling.span("s"):
                raise ValueError
    assert stats["spans"]["s"]["n"] == 2 and not profiling.active()


# ------------------------------------------------------------ the eval path


def test_the_eval_paths_counts_equal_numpy_over_the_collated_batch(tiny):
    cfg, enc, params, text_tok = tiny
    stats = {}
    records = cli.run_batches((enc.encode_test(r) for r in ROWS), params,
                              cfg, _gen(text_tok), text_tok, io.StringIO(),
                              batch_size=len(ROWS), stats=stats)
    assert len(records) == len(ROWS)
    batch = collate_test([enc.encode_test(r) for r in ROWS])
    counts, spans = stats["counts"], stats["spans"]
    run = live = skipped = 0
    for m in ("dna_rna", "protein"):
        tok, pos = batch[f"{m}_tokens"], batch[f"{m}_pos"]
        m_live = int(((tok != 1) & (pos >= 0)[..., None]).sum())
        n_live = int((pos >= 0).sum())  # host arrays: live slots run alone
        assert 0 < n_live < pos.size
        assert counts[f"encoder_tokens_run/{m}"] == n_live * K
        assert counts[f"encoder_tokens_live/{m}"] == m_live
        assert counts[f"encoder_slots_skipped/{m}"] == pos.size - n_live
        run, live = run + n_live * K, live + m_live
        skipped += pos.size - n_live
    assert 0 < live < run
    assert counts["encoder_tokens_run"] == run
    assert counts["encoder_tokens_live"] == live
    assert counts["encoder_slots_skipped"] == skipped
    mask = batch["attention_mask"]
    assert counts["prefill_positions_run"] == mask.size
    assert counts["prefill_positions_live"] == int(mask.sum())
    # six uploads (ids, mask, and a modality's live tokens and rows), an
    # EOS check a step (one more when every row ended early), a presence
    # write a token, a decode layer's attention offset, the tokens' copy
    # back; the injection picks no rows on the device, so waits for none
    steps, eos = stats["decode_steps"], spans["molly/sync/eos"]["n"]
    L = cfg.text.num_hidden_layers
    assert eos in (steps, steps + 1)
    assert counts["host_syncs"] == 6 + eos + (1 + steps) + L * steps + 1
    assert spans["molly/sync/upload"]["n"] == 1
    assert "molly/sync/inject" not in spans
    assert spans["molly/sync/presence"]["n"] == 1 + steps
    assert spans["molly/sync/q_offset"]["n"] == L * steps
    assert spans["molly/sync/tokens"]["n"] == 1
    assert spans["molly/layer"]["n"] == spans["molly/attn"]["n"] \
        == L * (1 + steps)
    assert spans["molly/decode_step"]["n"] == eos
    assert spans["molly/sample"]["n"] == 1 + steps
    assert spans["molly/encode_test"]["n"] == len(ROWS)
    for name in ("molly/collate", "molly/write", "molly/generate",
                 "molly/encode", "molly/encode/dna_rna",
                 "molly/encode/protein", "molly/prefill"):
        assert spans[name]["n"] == 1, name
        assert spans[name]["device_s"] is None  # no card
    step, waits = spans["molly/decode_step"], ("eos", "presence",
                                                "q_offset")
    assert step["sync_s"] < sum(spans[f"molly/sync/{w}"]["host_s"]
                                for w in waits)  # the prefill's presence
    assert step["sync_s"] > sum(spans[f"molly/sync/{w}"]["host_s"]
                                for w in ("eos", "q_offset"))
    assert spans["molly/generate"]["sync_s"] == pytest.approx(sum(
        sp["host_s"] for name, sp in spans.items()
        if name.startswith("molly/sync/") and name != "molly/sync/tokens"))
    assert 0 < step["self_host_s"] < step["host_s"]


def test_tensors_keep_every_slot_and_the_injections_mask_syncs(tiny):
    """A batch handed in as tensors runs the encoders over every slot and
    picks the written rows by boolean masks (three syncs a modality), and
    gives the tokens the packed host arrays give."""
    cfg, enc, params, text_tok = tiny
    arrs = {k: v for k, v in collate_test(
        [enc.encode_test(r) for r in ROWS]).items()
        if isinstance(v, np.ndarray)}
    stats = {}
    on_card = engine.generate(params, cfg, {k: torch.as_tensor(v)
                                            for k, v in arrs.items()},
                              _gen(text_tok), None, stats)
    counts, spans = stats["counts"], stats["spans"]
    for m in ("dna_rna", "protein"):
        assert counts[f"encoder_tokens_run/{m}"] == arrs[f"{m}_tokens"].size
        assert counts[f"encoder_slots_skipped/{m}"] == 0
    assert spans["molly/sync/inject"]["n"] == 2
    steps, eos = stats["decode_steps"], spans["molly/sync/eos"]["n"]
    L = cfg.text.num_hidden_layers
    # nothing to upload (the tensors are on the text's device already)
    assert counts["host_syncs"] == 2 * 3 + eos + (1 + steps) + L * steps
    assert torch.equal(on_card, engine.generate(params, cfg, arrs,
                                                _gen(text_tok)))


@pytest.mark.parametrize("do_sample", [False, True])
def test_generate_is_bit_equal_with_the_recorder_on_and_off(tiny,
                                                            do_sample):
    cfg, enc, params, text_tok = tiny
    arrs = {k: v for k, v in collate_test(
        [enc.encode_test(r) for r in ROWS]).items()
        if isinstance(v, np.ndarray)}
    gen = _gen(text_tok, do_sample, new=6)

    def run(stats=None, outer=None):
        g = torch.Generator().manual_seed(11)
        with profiling.recording(outer):
            return engine.generate(params, cfg, arrs, gen, g, stats)

    off = run()
    for on in (run(stats={}), run(outer={}), run(stats={}, outer={})):
        assert torch.equal(on, off)


def test_stats_keep_every_key_the_clocks_wrote(tiny):
    cfg, enc, params, text_tok = tiny
    arrs = {k: v for k, v in collate_test(
        [enc.encode_test(r) for r in ROWS]).items()
        if isinstance(v, np.ndarray)}
    stats = {}
    engine.generate(params, cfg, arrs, _gen(text_tok), None, stats)
    for key in ("encode_s", "prefill_s", "decode_s"):
        assert stats[key] > 0, key
    assert stats["decode_steps"] >= 1 and stats["logits_finite"] is True
    assert stats["spans"]["molly/generate"]["n"] == 1

    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_ratio=0.0)
    tparams = fusion.init_params(cfg, torch.Generator().manual_seed(1))
    state = trainer.init_train_state(tparams, tc)
    batch = {k: torch.as_tensor(v) for k, v in collate_train(
        [enc.encode_train(r) for r in ROWS]).items()
        if isinstance(v, np.ndarray)}
    train_stats = {}
    step = trainer.make_train_step(cfg, tc, train_stats)
    for _ in range(2):
        state, m = step(state, batch, None)
        assert not m["skipped"]
    assert sorted(train_stats) == ["backward_s", "forward_s", "optimizer_s"]
    assert all(isinstance(v, float) and v > 0 for v in train_stats.values())


def test_the_profiler_holds_the_decode_step_and_sample_ranges(tiny):
    cfg, enc, params, text_tok = tiny
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cli.run_batches((enc.encode_test(r) for r in ROWS), params, cfg,
                        _gen(text_tok), text_tok, io.StringIO(),
                        batch_size=len(ROWS))
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    for name in ("molly/decode_step", "molly/sample", "molly/layer",
                 "molly/attn", "molly/prefill", "molly/encode",
                 "molly/encode_test", "molly/collate", "molly/write",
                 "molly/sync/eos", "molly/sync/tokens"):
        assert name in names, name
    assert names.count("molly/decode_step") >= 1
    assert not profiling.active()
