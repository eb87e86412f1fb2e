"""CPU tests of the benchmark's harness: a tiny cell end to end, a cell
added as new files only, the check failing on a token altered where it is
produced, no forbidden module loaded, the traffic, the roofline and FLOP
counts against hand counts, and the trace reduction. Run with
``python -m pytest h100_bench/tests -q`` from the repository's root; the
card's tests (``-m cuda``) skip here."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from h100_bench.harness.peaks import bound_s
from h100_bench.harness.trace import Summary, _label_gaps, _union
from h100_bench.reference import qwen3
from h100_bench.roofline import model_flops, moe_gemm
from h100_bench.traffic.omics import batch_rows, kind_counts, strata

from .tiny import (BENCH, TINY_CONFIG, digest, make_bench, run_tiny,
                   tiny_moe_config, tiny_traffic)

ROOT = BENCH.parent


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make_bench(tmp_path_factory.mktemp("bench"))


def test_tiny_cell_runs_end_to_end_and_is_correct(bench):
    cell, out = run_tiny(bench, seconds=0.0)
    assert out.correct, out.checks
    (name, gap, limit), = out.checks
    assert name == "mean_sq_logit_gap" and gap <= 1e-8
    assert out.attempted == out.failed + 4 == 4
    assert out.end_to_end["samples_per_s"] > 0
    assert cell.extra["setup_s"] > 0
    assert out.record["batches"][0]["greedy"]
    assert out.record["stats_batches"] == []
    assert out.record["batches"][0]["stats"] is None


def test_added_workload_runs_with_no_file_edited(tmp_path):
    """A new MoE configuration, mix, limit and BENCHMARK.json entry: new
    files only; every file the benchmark had is byte for byte the same."""
    before = digest(BENCH)
    bench = make_bench(tmp_path, config=tiny_moe_config(),
                       traffic=tiny_traffic(greedy_every=1), name="tm.eval")
    copied = digest(bench)
    for rel, sha in copied.items():
        if rel in before:
            assert before[rel] == sha, rel
    added = set(copied) - set(before)
    assert added == {"configs/tiny-moe.json", "traffic/tiny_tm.eval.json",
                     "limits/tm.eval.json"}
    _, out = run_tiny(bench, name="tm.eval", seconds=0.0)
    assert out.correct, out.checks
    assert out.attempted == 4 and out.failed == 0


def test_a_token_altered_where_it_is_produced_fails_the_check(
        bench, monkeypatch):
    from molly_tpu_torch.inference import engine
    real = engine.sample_tokens

    def altered(logits, *args, **kwargs):
        tok = real(logits, *args, **kwargs)
        return (tok + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "sample_tokens", altered)
    _, out = run_tiny(bench, seconds=0.0)
    (_, gap, limit), = out.checks
    assert gap > limit and not out.correct


def test_a_run_loads_no_forbidden_module(bench):
    """In a process of its own: the harness, the driver, the program and
    the reference over a whole tiny run load no module whose top-level
    name is jax, jaxlib, flax, molly_tpu or benchmarks."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(BENCH / 'tests')!r}]\n"
            "from pathlib import Path\n"
            "from tiny import run_tiny\n"
            "from h100_bench.harness import env\n"
            f"_, out = run_tiny(Path({str(bench)!r}), seconds=0.0)\n"
            "assert out.correct\n"
            "print('FORBIDDEN', env.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FORBIDDEN []" in res.stdout


def test_forbidden_names_are_compared_whole():
    """In a process of its own, whose module table holds nothing that an
    earlier test of the same worker loaded: names that only begin with a
    forbidden one are not it; a submodule's top-level name is."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "from h100_bench.harness import env\n"
            "print('BEFORE', env.forbidden_modules())\n"
            "sys.modules['molly_tpu_torch_fake'] = sys\n"
            "sys.modules['jaxtyping_fake'] = sys\n"
            "print('PREFIXES', env.forbidden_modules())\n"
            "sys.modules['molly_tpu.sub'] = sys\n"
            "print('SUB', env.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in res.stdout.splitlines())
    assert lines == {"BEFORE": "[]", "PREFIXES": "[]",
                     "SUB": "['molly_tpu']"}


def test_traffic_is_the_same_for_a_seed_and_follows_its_mix():
    mix = json.loads((BENCH / "traffic" / "omics_eval_b32.json")
                     .read_text())["mix"]
    a = batch_rows(mix, 32, 2 ** 31 + 17, 3)
    assert a == batch_rows(mix, 32, 2 ** 31 + 17, 3)
    b = batch_rows(mix, 32, 99, 3)
    assert a != b
    counts = kind_counts(mix["samples"], 32)
    assert counts == [10, 5, 11, 2, 2, 2]

    def shape(rows):
        import re
        segs = sorted((m.group(1) == "protein", len(m.group(2)))
                      for r in rows
                      for m in re.finditer(r"<(dna|rna|protein)>(\w+)<",
                                           r["input"]))
        kinds = sorted(r["task"] for r in rows)
        return segs, kinds

    # another seed, another batch: the same multiset of shapes
    assert shape(a) == shape(b) == shape(batch_rows(mix, 32, 5, 0))
    segs, _ = shape(a)
    prot = sorted(n for is_prot, n in segs if is_prot)
    assert prot == sorted(strata(80, 1000, len(prot)))
    assert all(300 <= n <= 6000 for is_prot, n in segs if not is_prot)


def test_attention_roofline_matches_the_kernel_table():
    """PERF.md's decoder-prefill case: q [4,3072,16,128] over a
    [4,8,3136,256] cache, left pads 0 / 517 / 1203 / 2999 -> 0.0806 ms,
    bound by operations."""
    text = {"num_attention_heads": 16, "num_key_value_heads": 8,
            "head_dim": 128, "num_hidden_layers": 1}
    (flops, nbytes), = qwen3.prefill_attention_calls(
        [3072, 3072 - 517, 3072 - 1203, 3072 - 2999], 3072, 64, text)
    assert flops == 4 * 128 * 16 * 9_735_634
    assert round(bound_s(flops, nbytes) * 1e3, 4) == 0.0806
    assert flops / 989e12 > nbytes / 3.35e12


def test_grouped_gemm_roofline_matches_the_kernel_table():
    """PERF.md's prefill gate [98304,2048] x [128,2048,768] -> fp32 with 127
    active groups: 1.10 GB, 0.3296 ms, bound by bytes."""
    flops, nbytes = moe_gemm.gemm(98304, 2048, 768, 127)
    assert nbytes == 1_104_150_528
    assert round(bound_s(flops, nbytes) * 1e3, 4) == 0.3296
    assert moe_gemm.experts_reached(20000, 128, 8) == 128
    assert moe_gemm.experts_reached(1, 128, 8) == 8


def test_model_flops_by_hand():
    """The tiny model, one row of 10 real tokens, one live DNA segment of
    5 tokens, 3 tokens emitted, counted by hand."""
    c = TINY_CONFIG
    shape = {"rows": [{"n": 10, "emitted": 3, "segments": [("dna_rna", 5)]}]}
    # decoder token: 2 layers x (64*64 + 2*64*32 + 64*64 + 3*64*128)
    tok = 2 * 2 * (4096 + 4096 + 4096 + 24576)
    assert qwen3.token_flops(c["text"]) == tok
    # encoder token (SwiGLU): 2 layers x (4*32*32 + 3*32*64)
    enc = 2 * 2 * (4096 + 6144)
    assert model_flops.encoder_token(c["dna_rna"]) == enc
    head = 2 * 64 * 512
    attn_enc = 4 * 5 * 5 * 32 * 2
    proj = 2 * 5 * 32 * 64
    prefill = 10 * tok + 4 * 64 * 2 * 55 + head
    decode = sum(tok + 4 * 64 * 2 * (10 + j + 1) + head for j in range(2))
    assert model_flops.generate(shape, c, qwen3) == float(
        5 * enc + attn_enc + proj + prefill + decode)


def test_union_and_idle_gaps():
    assert _union([(5, 9), (0, 3), (2, 4), (9, 12)]) == [(0, 4), (5, 12)]
    host = [(0, 100, "outer"), (10, 30, "aten::mm"), (40, 60, "aten::add")]
    gaps = _label_gaps([(12, 20), (45, 55), (70, 90), (200, 210)], host)
    assert gaps == pytest.approx({"aten::mm": 8e-9, "aten::add": 10e-9,
                                  "outer": 20e-9, "python between operations": 10e-9})
    s = Summary(1.0, 0.25, {"void flash_fwd_tma_kernel<128>": 0.1,
                            "void flash_fwd_kernel<float>": 0.05,
                            "ampere_gemm": 0.1}, gaps)
    assert s.kernel_seconds([r"\bflash_fwd_tma_kernel\b",
                             r"\bflash_fwd_kernel\b"]) == pytest.approx(0.15)
    bd = s.breakdown()
    assert bd["device_ops"][0][1] == 0.1 and len(bd["idle_gaps"]) == 4


def test_a_traced_tiny_run_reads_its_per_layer_metrics(bench):
    """The traced path on the CPU (no device events: busy is 0): the
    window runs untraced, as in every run; after it, the stats batches and
    the profiled batch run again, and the per-layer metrics read them."""
    from h100_bench.harness.cell import load_cell, metric_reader
    from h100_bench.harness.main import run_cell
    import time as _time
    cell = load_cell("tiny.eval", bench)
    cell.seed, cell.seconds, cell.device = 5, 0.0, "cpu"
    cell.trace, cell.started = True, _time.time()
    out = run_cell(cell)
    assert out.correct
    rec = out.record
    assert len(rec["batches"]) == 1 and rec["batches"][0]["stats"] is None
    assert [b["greedy"] for b in rec["stats_batches"]] == [True, False]
    prof = rec["profiled"]
    assert prof["index"] == 0 and prof["stats"] is None
    assert prof["untraced_s"] == rec["batches"][0]["wall"]
    assert rec["trace"] is not None and rec["trace"].busy_s == 0
    assert rec["trace"].window_s > 0
    assert rec["window_s"] >= rec["batches"][0]["wall"]
    st = [b["stats"] for b in rec["stats_batches"]]
    assert metric_reader(bench, "encode_ms.eval")(rec) == pytest.approx(
        1e3 * (st[0]["encode_s"] + st[1]["encode_s"]) / 2)
    assert metric_reader(bench, "decode_step_ms.eval")(rec) == \
        pytest.approx(1e3 * (st[0]["decode_s"] + st[1]["decode_s"])
                      / (st[0]["decode_steps"] + st[1]["decode_steps"]))
    assert metric_reader(bench, "idle_pct.eval")(rec) == pytest.approx(100)
    flops = model_flops.generate(rec["batches"][0]["shape"], TINY_CONFIG,
                                 qwen3)
    assert metric_reader(bench, "mfu.eval")(rec) == pytest.approx(
        100 * flops / rec["window_s"] / 989e12)
    assert metric_reader(bench, "attn_fwd_roofline.eval")(rec) is None


def test_the_warmup_batch_stops_after_its_few_new_tokens(bench, monkeypatch):
    """Set-up's batch asks for ``warmup_new_tokens`` new tokens; the
    window's batches for ``max_new_tokens``."""
    from molly_tpu_torch.inference import engine
    asked = []
    real = engine.generate

    def spy(*args, **kwargs):
        asked.append(kwargs.get("gen", args[3] if len(args) > 3 else None)
                     .max_new_tokens)
        return real(*args, **kwargs)

    monkeypatch.setattr(engine, "generate", spy)
    _, out = run_tiny(bench, seconds=0.0)
    assert out.correct
    assert asked == [3, 4]


def test_metric_readers_find_nothing_without_a_trace():
    from h100_bench.harness.cell import metric_reader
    record = {"bench_dir": BENCH, "batches": [], "stats_batches": [],
              "trace": None, "profiled": None, "window_s": 1.0,
              "config": TINY_CONFIG, "memory_peak_bytes": 0}
    for name in ("attn_fwd_roofline.eval", "moe_gemm_roofline.eval",
                 "mfu.eval", "idle_pct.eval", "encode_ms.eval",
                 "decode_step_ms.cot", "peak_mem_gib.eval",
                 "sample_encode_ms.eval", "prefill_ms.eval"):
        assert metric_reader(BENCH, name)(record) is None, name


def test_every_benchmark_metric_has_a_reader_and_every_cell_its_files():
    from h100_bench.harness.cell import load_cell, metric_reader
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        metric_reader(BENCH, m["name"])
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.limits, w["name"]
        assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").exists()
        cfg = cell.fusion_config()
        assert cfg.text.hidden_size == cell.config["text"]["hidden_size"]
        assert (BENCH / "reference"
                / f"{cell.config['decoder']}.py").is_file()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_control_fails_the_eval_limit_on_the_card(card):
    """The control, the program's int8 weight-only decode, at the eval
    cell's own sizes on one seed, reads above the cell's limit."""
    from h100_bench.calibrate import readings
    from h100_bench.harness.cell import load_cell
    limit = load_cell("molly-1.7b.eval").limits["mean_sq_logit_gap"]
    (numbers,) = readings("molly-1.7b.eval", [20260001],
                          control="int8").values()
    assert numbers["mean_sq_logit_gap"] > limit


def test_benchmark_json_keeps_to_its_contract():
    import re
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    configs = {c["name"]: c for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert name.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        mine = [m for m in bench["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in bench["per_layer"]
                 if w["name"] in m["workloads"]]
        assert layer
        for m in layer:
            assert w["name"] in e2e[m["moves"]].get("workloads",
                                                    [w["name"]])
    assert len(json.dumps(bench)) < 64 * 1024


def test_the_reference_imports_nothing_of_the_program():
    """The plain reference (its decoder file too) and the traffic generator
    load no module of ``molly_tpu_torch`` (nor of JAX): they judge the
    program's output and take nothing it made."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import h100_bench.reference.model, h100_bench.reference.prompt\n"
            "import h100_bench.reference.qwen3\n"
            "import h100_bench.traffic.omics, h100_bench.harness.weights\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print('LOADED', sorted(tops & {'molly_tpu_torch', 'molly_tpu',"
            " 'jax', 'benchmarks'}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout
