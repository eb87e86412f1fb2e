"""The seam between the harness and a decoder architecture. A decoder
joins as a new ``reference/<decoder>.py`` that a new configuration names,
with no file of the benchmark edited; the harness draws, judges and counts
by the named file; a name with no file stops the run. And the move of the
Qwen3 code into ``reference/qwen3.py`` changed no count and no weight:
``neutrality_pin.json`` holds what the code drew and counted before it."""

from __future__ import annotations

import copy
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench.harness import weights
from h100_bench.harness.cell import load_cell, metric_reader
from h100_bench.harness.main import run_cell
from h100_bench.harness.peaks import PEAK_FLOPS
from h100_bench.reference import qwen3
from h100_bench.roofline import attn_fwd, model_flops

from .tiny import (BENCH, TINY_CONFIG, digest, make_bench, run_tiny,
                   tiny_moe_config)

QWEN3 = (BENCH / "reference" / "qwen3.py").read_text()
PIN = json.loads((Path(__file__).parent / "neutrality_pin.json").read_text())
SEED = 2 ** 31 + 101
CELL = "tq.eval"


def bench_with_decoder(tmp: Path, decoder: str, source=None) -> Path:
    """A copy of the folder with a tiny configuration that names
    ``decoder``, its mix and limit, and, where ``source`` is given,
    ``reference/<decoder>.py`` holding it: new files only, every file the
    benchmark had byte for byte the same."""
    before = digest(BENCH)
    config = copy.deepcopy(TINY_CONFIG)
    config.update(name=f"tiny-{decoder}", decoder=decoder)
    bench = make_bench(tmp, config=config, name=CELL)
    if source is not None:
        (bench / "reference" / f"{decoder}.py").write_text(source)
    copied = digest(bench)
    for rel, sha in copied.items():
        if rel in before:
            assert before[rel] == sha, rel
    added = {f"configs/tiny-{decoder}.json", f"traffic/tiny_{CELL}.json",
             f"limits/{CELL}.json"}
    if source is not None:
        added.add(f"reference/{decoder}.py")
    assert set(copied) - set(before) == added
    return bench


@pytest.fixture(scope="module")
def qwen3_run(tmp_path_factory):
    """The tiny qwen3 cell at SEED."""
    bench = make_bench(tmp_path_factory.mktemp("qwen3"))
    _, out = run_tiny(bench, seed=SEED)
    assert out.correct, out.checks
    return out


def test_a_copied_decoder_named_by_a_config_gives_the_same_run(
        tmp_path, qwen3_run):
    bench = bench_with_decoder(tmp_path, "qwen3_copy", QWEN3)
    cell, out = run_tiny(bench, name=CELL, seed=SEED)
    assert out.correct, out.checks
    dec = out.record["decoder"]
    assert Path(dec.__file__) == bench / "reference" / "qwen3_copy.py"
    assert out.record["check_numbers"] == qwen3_run.record["check_numbers"]
    np.testing.assert_array_equal(out.record["check_gaps"],
                                  qwen3_run.record["check_gaps"])
    for b, qb in zip(out.record["batches"], qwen3_run.record["batches"]):
        assert b["shape"] == qb["shape"]
        assert model_flops.generate(b["shape"], cell.config, dec) == \
            model_flops.generate(qb["shape"], TINY_CONFIG, qwen3)
        assert attn_fwd.calls(b["shape"], cell.config, dec) == \
            attn_fwd.calls(qb["shape"], TINY_CONFIG, qwen3)
    # the same weights, and the same reference logits bit for bit
    w = weights.make(cell.config, SEED, "cpu", dec)["text"]
    assert torch.equal(w["layers"]["q_proj"], weights.make(
        TINY_CONFIG, SEED, "cpu", qwen3)["text"]["layers"]["q_proj"])
    embeds = [torch.randn(n, 64, generator=torch.Generator().manual_seed(n))
              for n in (7, 12)]
    rows = [(3, 7), (0, 12)]
    for a, b in zip(dec.decoder_logits(w, TINY_CONFIG["text"], embeds, rows),
                    qwen3.decoder_logits(w, TINY_CONFIG["text"], embeds,
                                         rows)):
        assert torch.equal(a, b)


def test_the_check_judges_by_the_named_decoder(tmp_path):
    """The same copy with the reference's head negated: the program's
    tokens are then the reference's worst, and the check fails."""
    line = '    final = f32(params["final_norm"])\n'
    assert QWEN3.count(line) == 1
    negated = QWEN3.replace(line, "    head = -head\n" + line)
    bench = bench_with_decoder(tmp_path, "qwen3_negated", negated)
    _, out = run_tiny(bench, name=CELL, seed=SEED)
    (name, gap, limit), = out.checks
    assert name == "mean_sq_logit_gap" and gap > limit
    assert not out.correct


def test_mfu_counts_by_the_named_decoder(tmp_path):
    """The same copy with ``token_flops`` doubled: the decoder's
    matrix-product part of ``mfu``'s count doubles, and nothing else of it
    moves."""
    doubled = QWEN3 + ("\n\n_one_token = token_flops\n\n\n"
                       "def token_flops(text):\n"
                       "    return 2 * _one_token(text)\n")
    bench = bench_with_decoder(tmp_path, "qwen3_doubled", doubled)
    cell = load_cell(CELL, bench)
    cell.seed, cell.seconds, cell.device = SEED, 0.0, "cpu"
    cell.trace, cell.started = True, 0.0
    out = run_cell(cell)
    rec = out.record
    mfu = metric_reader(bench, "mfu.eval")
    doubled_mfu = mfu(rec)
    single_mfu = mfu(dict(rec, decoder=qwen3))
    tokens = sum(r["n"] + max(r["emitted"] - 1, 0)
                 for b in rec["batches"] for r in b["shape"]["rows"])
    added = (doubled_mfu - single_mfu) / 100 * rec["window_s"] \
        * PEAK_FLOPS["bf16"]
    assert added == pytest.approx(tokens * qwen3.token_flops(
        TINY_CONFIG["text"]), rel=1e-9)
    assert doubled_mfu > single_mfu > 0


def test_a_decoder_with_no_file_stops_the_run_naming_the_path(tmp_path):
    bench = bench_with_decoder(tmp_path, "no_such_decoder")
    cell = load_cell(CELL, bench)
    cell.seed, cell.seconds, cell.device = SEED, 0.0, "cpu"
    missing = bench / "reference" / "no_such_decoder.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(missing))):
        run_cell(cell)
    with pytest.raises(FileNotFoundError, match=re.escape(str(missing))):
        cell.fusion_config()


CONFIGS = {"tiny": TINY_CONFIG, "tiny-moe": tiny_moe_config()}


@pytest.mark.parametrize("name", sorted(PIN["configs"]))
def test_the_counts_equal_those_before_the_move(name):
    pin, config = PIN["configs"][name], CONFIGS[name]
    assert model_flops.generate(PIN["shape"], config, qwen3) == \
        pin["generate"]
    assert [list(c) for c in attn_fwd.calls(PIN["shape"], config, qwen3)] \
        == pin["attn_fwd_calls"]


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + key + "/")
        else:
            yield prefix + key, value


@pytest.mark.parametrize("name", sorted(PIN["configs"]))
def test_the_drawn_weights_equal_those_before_the_move(name):
    """Leaf order exactly; first and last values to a relative 1e-6 (a
    CPU may round torch's vectorised ``randn`` in its last bit
    otherwise)."""
    pin = PIN["configs"][name]
    drawn = [(path, t.reshape(-1)) for path, t in _leaves(
        weights.make(CONFIGS[name], PIN["seed"], "cpu", qwen3))]
    assert [path for path, _ in drawn] == [leaf[0] for leaf in pin["leaves"]]
    for (path, flat), (_, first, last) in zip(drawn, pin["leaves"]):
        assert [float(flat[0]), float(flat[-1])] == pytest.approx(
            [first, last], rel=1e-6), path
