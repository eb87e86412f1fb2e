"""The per-layer metrics that read the program's own spans and counters
(``molly_tpu_torch.utils.profiling``): the tiny cell on the CPU reports
them traced, they find nothing in a record without them (an untraced run,
or a program that records none), and on the card (``-m cuda``) the
counter of host syncs equals the synchronizations CUDA reports, the
recorder adds none, and the ``molly/`` ranges never count as device
work."""

from __future__ import annotations

import copy
import io
import time
import warnings

import pytest
import torch

from .tiny import TINY_CONFIG, make_bench

NEW = ("decode_host_ms.eval", "decode_wait_ms.eval", "host_syncs.eval",
       "encoder_live_pct.eval", "prefill_live_pct.eval", "cli_host_ms.eval")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make_bench(tmp_path_factory.mktemp("bench"))


def test_a_traced_tiny_run_reports_the_recorders_metrics(bench):
    from h100_bench.harness.cell import load_cell
    from h100_bench.harness.main import metrics_of, run_cell
    cell = load_cell("tiny.eval", bench)
    cell.seed, cell.seconds, cell.device = 2 ** 31 + 77, 0.0, "cpu"
    cell.trace, cell.started = True, time.time()
    out = run_cell(cell)
    assert out.correct
    got = metrics_of(cell, out)
    for name in NEW:
        assert name in got, name
    st = [b["stats"] for b in out.record["stats_batches"]]
    steps = sum(s["decode_steps"] for s in st)
    step_s = sum(s["spans"]["molly/decode_step"]["host_s"] for s in st)
    assert 0 < got["decode_wait_ms.eval"]["value"] < 1e3 * step_s / steps
    assert got["decode_host_ms.eval"]["value"] \
        + got["decode_wait_ms.eval"]["value"] == \
        pytest.approx(1e3 * step_s / steps)
    # the sync sites of a batch of host arrays: the upload of the ids, the
    # mask and each live modality's packed tokens and rows
    # (``engine.generate``; the inject's mask counts are on the tensor path
    # only), an EOS check a step, a presence write a token, a decode
    # layer's attention offset, the tokens' copy
    syncs = [s["counts"]["host_syncs"] for s in st]
    assert got["host_syncs.eval"]["value"] == sum(syncs) / len(syncs)
    layers = cell.config["text"]["num_hidden_layers"]
    for b in out.record["stats_batches"]:
        s, n = b["stats"], b["stats"]["decode_steps"]
        live = {m for r in b["shape"]["rows"] for m, _ in r["segments"]}
        assert s["counts"]["host_syncs"] == 2 + 2 * len(live) + \
            s["spans"]["molly/sync/eos"]["n"] + (1 + n) + layers * n + 1
    assert 0 < got["encoder_live_pct.eval"]["value"] < 100
    assert 0 < got["prefill_live_pct.eval"]["value"] < 100
    assert got["cli_host_ms.eval"]["value"] > 0
    assert got["cli_host_ms.eval"]["unit"] == "ms"


def test_the_recorders_metrics_find_nothing_without_its_spans(bench):
    from h100_bench.harness.cell import metric_reader
    parent = {"encode_s": 1.0, "prefill_s": 1.0, "decode_s": 1.0,
              "decode_steps": 31, "logits_finite": True}
    for batches in ([], [{"stats": None}], [{"stats": parent}],
                    [{"stats": dict(parent, spans={}, counts={})},
                     {"stats": parent}]):
        record = {"stats_batches": batches, "batches": [], "trace": None}
        for name in NEW:
            assert metric_reader(bench, name)(record) is None, (name,
                                                               batches)


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def card_bench(tmp_path_factory):
    """The tiny cell at head widths the card's attention kernels take
    (64) and in bf16."""
    config = copy.deepcopy(TINY_CONFIG)
    config.update(name="tiny-card", dtype="bfloat16")
    config["text"].update(hidden_size=256, intermediate_size=512,
                          num_attention_heads=4, num_key_value_heads=2,
                          head_dim=64)
    for enc in ("dna_rna", "protein"):
        config[enc].update(hidden_size=128, intermediate_size=256,
                           num_attention_heads=2)
    return make_bench(tmp_path_factory.mktemp("card"), config=config)


def _tiny_program(bench):
    """The tiny cell's program on the card: a batch function running
    ``run_batches`` over one batch of the mix."""
    from h100_bench.harness import weights
    from h100_bench.harness.cell import load_cell
    from h100_bench.traffic.omics import batch_rows
    from molly_tpu_torch.data import (DataConfig, OmicsSampleEncoder,
                                      default_modality_tokenizers,
                                      load_text_tokenizer)
    from molly_tpu_torch.inference.cli import run_batches
    from molly_tpu_torch.models.configs import GenerationConfig
    from molly_tpu_torch.ops import _cuda_build
    _cuda_build.build()
    cell = load_cell("tiny.eval", bench)
    t, cfg = cell.traffic, cell.fusion_config()
    text_tok = load_text_tokenizer(None)
    enc = OmicsSampleEncoder(text_tok, *default_modality_tokenizers(),
                             DataConfig(
        max_len=t["max_length"], dna_rna_k_tokens=t["dna_rna_k_tokens"],
        protein_k_tokens=t["protein_k_tokens"],
        max_dna_rna_segments=t["max_dna_rna_segments"],
        max_protein_segments=t["max_protein_segments"]))
    params = weights.make(cell.config, 5, "cuda", cell.decoder())
    gen = GenerationConfig(max_new_tokens=t["max_new_tokens"],
                           do_sample=False,
                           eos_token_id=text_tok.eos_token_id,
                           pad_token_id=text_tok.pad_token_id)
    rows = batch_rows(t["mix"], t["batch_size"], 5, 0)

    def batch(stats=None):
        return run_batches((enc.encode_test(r) for r in rows), params, cfg,
                           gen, text_tok, io.StringIO(),
                           batch_size=t["batch_size"], stats=stats)

    batch()  # warm: the first call builds what it launches
    torch.cuda.synchronize()
    return batch


def _synchronizations(fn) -> int:
    """The synchronizing CUDA operations ``fn`` makes at the program's own
    lines, as ``set_sync_debug_mode("warn")`` reports them (PyTorch may
    add one of its own, once a process)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message)
               and "molly_tpu_torch" in w.filename for w in caught)


@pytest.mark.cuda
def test_host_syncs_counts_every_synchronization_and_adds_none(
        card, card_bench):
    from molly_tpu_torch.utils import profiling
    batch = _tiny_program(card_bench)
    plain = _synchronizations(batch)
    rec = {}

    def recorded():
        with profiling.recording(rec):
            batch()

    assert _synchronizations(recorded) == plain
    assert rec["counts"]["host_syncs"] == plain
    assert rec["spans"]["molly/generate"]["device_s"] > 0
    stats = {}
    with_stats = _synchronizations(lambda: batch(stats))
    assert stats["counts"]["host_syncs"] == plain
    # the stats mode's own: its phase marks and the finite-logits read
    assert plain < with_stats <= plain + 5


@pytest.mark.cuda
def test_no_molly_range_counts_as_device_work(card, card_bench):
    from h100_bench.harness.trace import ProfiledSlice
    batch = _tiny_program(card_bench)
    with ProfiledSlice() as sl:
        batch()
    s = sl.summary
    assert s is not None and s.busy_s > 0
    assert not [k for k in s.kernels if "molly/" in k]
    assert any(label.startswith("molly/") for label in s.gaps)
