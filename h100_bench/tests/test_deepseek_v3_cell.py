"""A DeepSeek-V3-family cell joins the benchmark by new files alone: a tiny
configuration that names ``reference/deepseek_v3.py`` runs ``correct`` on
the CPU in a copy of the folder to which only its configuration, mix and
limit were added (every file the benchmark had byte for byte the same);
traced, it reports the latent attention's and the router's spans and
counters; untraced, its host syncs are those of the code's sync sites,
with none in a decode layer."""

from __future__ import annotations

import copy
import time

import pytest

from .tiny import BENCH, TINY_CONFIG, digest, make_bench

CELL = "tds.eval"
SEED = 2 ** 31 + 5
TEXT = {
    "vocab_size": 512, "hidden_size": 64, "intermediate_size": 96,
    "moe_intermediate_size": 16, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4, "q_lora_rank": None,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "n_routed_experts": 8, "num_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "scoring_func": "sigmoid",
    "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
    "norm_topk_prob": True, "routed_scaling_factor": 2.446,
    "rms_norm_eps": 1e-5, "rope_theta": 50000, "tie_word_embeddings": False,
    "max_position_embeddings": 8192}
SPANS = ("molly/mla/q", "molly/mla/latent", "molly/mla/decompress",
         "molly/mla/absorb", "molly/mla/latent_attn", "molly/moe/router",
         "molly/moe/routed", "molly/moe/shared")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    before = digest(BENCH)
    config = copy.deepcopy(TINY_CONFIG)
    config.update(name="tiny-ds", decoder="deepseek_v3", text=TEXT)
    bench = make_bench(tmp_path_factory.mktemp("ds"), config=config,
                       name=CELL)
    copied = digest(bench)
    for rel, sha in copied.items():
        if rel in before:
            assert before[rel] == sha, rel
    assert set(copied) - set(before) == {
        "configs/tiny-ds.json", f"traffic/tiny_{CELL}.json",
        f"limits/{CELL}.json"}
    return bench


@pytest.fixture(scope="module")
def traced(bench):
    return _run(bench, trace=True)


def _run(bench, trace):
    from h100_bench.harness.cell import load_cell
    from h100_bench.harness.main import run_cell
    cell = load_cell(CELL, bench)
    cell.seed, cell.seconds, cell.device = SEED, 0.0, "cpu"
    cell.trace, cell.started = trace, time.time()
    return cell, run_cell(cell)


def test_a_deepseek_v3_cell_runs_correct_with_no_file_edited(bench):
    cell, out = _run(bench, trace=False)
    assert out.correct, out.checks
    (name, gap, limit), = out.checks
    assert name == "mean_sq_logit_gap" and gap <= 1e-8
    assert out.attempted == 4 and out.failed == 0
    assert out.record["decoder"].PROGRAM_MODULE == "deepseek_v3"
    assert type(cell.fusion_config().text).__name__ == "DeepseekV3Config"


def test_a_traced_deepseek_v3_run_reports_its_spans_and_counters(
        bench, traced):
    from h100_bench.harness.cell import metric_reader
    from h100_bench.harness.main import metrics_of
    cell, out = traced
    assert out.correct
    t, text = cell.traffic, TEXT
    L, E, k = text["num_hidden_layers"], text["num_experts"], 2
    B, S, T = t["batch_size"], t["max_length"], t["max_new_tokens"]
    for b in out.record["stats_batches"]:
        st = b["stats"]
        for name in SPANS:
            assert st["spans"][name]["n"] > 0, name
        steps = st["decode_steps"]
        assert st["spans"]["molly/mla/absorb"]["n"] == L * steps
        assert st["spans"]["molly/mla/decompress"]["n"] == L
        assert st["spans"]["molly/moe/routed"]["n"] == (L - 1) * (1 + steps)
        c = st["counts"]
        assert c["mla_cache_bytes"] == L * B * (S + T) * (32 + 8) * 4
        assert c["moe_expert_rows_mean"] == (L - 1) * B * S * k / E
        assert c["moe_expert_rows_max"] >= c["moe_expert_rows_mean"]
    # the cell's own metrics, read as the moonlight cell reads them
    assert metric_reader(bench, "moe_load_max.eval")(out.record) >= 100
    # the device trace exists on a card only
    for name in ("mla_fwd_roofline.eval", "moe_gemm_roofline.eval"):
        assert metric_reader(bench, name)(out.record) is None
    assert metrics_of(cell, out)["host_syncs.eval"]["value"] > 0


def test_its_host_syncs_are_the_sync_sites_with_none_in_a_layer(traced):
    """The uploads (the ids, the mask, each live modality's tokens and
    rows), an EOS check a decode step, a presence write a token, the
    tokens' copy: no decode layer reads a host value (Qwen3's attention
    offset does, once a layer and step)."""
    _, out = traced
    for b in out.record["stats_batches"]:
        st, n = b["stats"], b["stats"]["decode_steps"]
        live = {m for r in b["shape"]["rows"] for m, _ in r["segments"]}
        assert st["counts"]["host_syncs"] == 2 + 2 * len(live) + \
            st["spans"]["molly/sync/eos"]["n"] + (1 + n) + 1
        assert "molly/sync/q_offset" not in st["spans"]


def test_the_deepseek_v3_reference_imports_nothing_of_the_program():
    """In a process of its own: ``reference/deepseek_v3.py`` loads no
    module of ``molly_tpu_torch``, of JAX or of ``transformers`` (whose
    ``modeling_deepseek_v3.py`` it follows)."""
    import subprocess
    import sys
    root = BENCH.parent
    code = (f"import sys; sys.path[:0] = [{str(root)!r}]\n"
            "import h100_bench.reference.deepseek_v3\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print('LOADED', sorted(tops & {'molly_tpu_torch', 'molly_tpu',"
            " 'jax', 'benchmarks', 'transformers'}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_int8_control_fails_the_moonlight_limit_on_the_card(card):
    """The control, the program's int8 weight-only decode (the experts
    too), at the cell's own sizes on one seed, reads above the cell's
    limit."""
    from h100_bench.calibrate import readings
    from h100_bench.harness.cell import load_cell
    cell = "molly-moonlight-16b-a3b.eval"
    limit = load_cell(cell).limits["mean_sq_logit_gap"]
    (numbers,) = readings(cell, [20260001], control="int8").values()
    assert numbers["mean_sq_logit_gap"] > limit
