"""The port's parity runner (molly_tpu_torch.tools.parity) against the JAX
runner on the tiny random HF checkpoints of tests/test_parity_runner.py,
with the port on the CPU, and the per-layer hidden states it reads
(``output_hidden_states``) against molly_tpu's at 1e-5 in fp32."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.models import esm as jesm
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.models import tiny_esm, tiny_moe, tiny_qwen3
from molly_tpu_torch.models import esm, qwen3
from test_parity_runner import tiny_ckpts  # noqa: F401 (fixture)
from test_torch_models import _tcfg_of, _torch_params

ATOL = 1e-5


def _keys(report):
    """The report's shape: its keys, each check's keys and verdict, and the
    layer-table lengths."""
    return {"keys": sorted(report),
            "checks": [(c["check"], sorted(c), c["pass"])
                       for c in report["checks"]],
            "layers": {k: len(v) for k, v in report.items()
                       if k.endswith("_layerwise")},
            "all_pass": report["all_pass"]}


_MODES = {
    "end_to_end": ["--prompts", "4", "--seq-len", "24", "--new-tokens", "8"],
    "text_only": ["--prompts", "2", "--seq-len", "16", "--new-tokens", "4"],
    "full_gate": ["--full-gate", "--gate-prompts", "20", "--prompts", "2",
                  "--seq-len", "24", "--new-tokens", "6"],
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_port_runner_reports_like_the_jax_runner(tiny_ckpts, tmp_path,  # noqa: F811
                                                 mode):
    from molly_tpu.tools.parity import main as jax_main
    from molly_tpu_torch.tools.parity import main

    ckpts = ["--text", str(tiny_ckpts / "qwen")]
    if mode != "text_only":
        ckpts += ["--dna-rna", str(tiny_ckpts / "nt"),
                  "--protein", str(tiny_ckpts / "esm")]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    out = str(tmp_path / "port" / "parity.json")
    got = main(ckpts + _MODES[mode] + ["--output", out, "--device", "cpu"])
    ref = jax_main(ckpts + _MODES[mode] +
                   ["--output", str(tmp_path / "jax" / "parity.json")])
    with open(out) as f:
        assert json.load(f)["all_pass"] == got["all_pass"]
    assert _keys(got) == _keys(ref)
    assert got["all_pass"]
    for c in got["checks"]:
        if "max_abs_diff" in c:
            assert c["max_abs_diff"] < c["atol"] or (
                c["check"] == "eval_score_parity"
                and c["max_abs_diff"] <= c["atol"]), c
    for k, rows in got.items():
        if k.endswith("_layerwise"):
            assert all(r["max_abs"] < 2e-3 for r in rows), (k, rows)
    if mode == "full_gate":
        gate = next(c for c in got["checks"]
                    if c["check"] == "eval_score_parity")
        assert gate["token_match_fraction"] == 1.0
        assert gate["max_abs_diff"] == 0.0
        assert set(got["eval_score_gate"]) == set(ref["eval_score_gate"])
        # both stacks' JSONLs score alike on the port's and JAX's sides
        assert got["eval_score_gate"]["molly_tpu_scores"] == \
            ref["eval_score_gate"]["molly_tpu_scores"]


def test_runner_stops_without_a_card_unless_asked_for_the_cpu(tiny_ckpts):  # noqa: F811
    from molly_tpu_torch.tools.parity import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["--text", str(tiny_ckpts / "qwen")])


@pytest.mark.parametrize("moe", [False, True])
def test_decoder_hidden_states_match_jax_per_layer(moe):
    cfg = (tiny_moe if moe else tiny_qwen3)(num_hidden_layers=3)
    jparams = jqwen3.init_params(cfg, jax.random.key(1))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (2, 11))
    mask = np.ones_like(ids)
    mask[1, -3:] = 0
    jout, _, jper = jqwen3.forward_hidden(
        jparams, cfg, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), output_hidden_states=True)
    with torch.no_grad():
        out, aux, per = qwen3.forward_hidden(
            _torch_params(jparams), _tcfg_of(cfg),
            input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
            output_hidden_states=True)
    assert per.shape == (3, 2, 11, cfg.hidden_size)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    assert (aux is not None) == moe  # the MoE aux losses keep their slot
    with pytest.raises(ValueError, match="no-cache"):
        qwen3.forward_hidden(
            _torch_params(jparams), _tcfg_of(cfg),
            input_ids=torch.tensor(ids), output_hidden_states=True,
            cache=qwen3.init_cache(_tcfg_of(cfg), 2, 16))


@pytest.mark.parametrize("kw", [{}, {"position_embedding_type": "absolute",
                                     "emb_layer_norm_before": True}])
def test_encoder_hidden_states_match_jax_per_layer(kw):
    cfg = tiny_esm(**kw)
    jparams = jesm.init_params(cfg, jax.random.key(2))
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 30, (2, 10))
    ids[1, -2:] = cfg.pad_token_id
    jout, jper = jesm.forward_hidden(jparams, cfg, jnp.asarray(ids),
                                     output_hidden_states=True)
    with torch.no_grad():
        out, per = esm.forward_hidden(_torch_params(jparams), _tcfg_of(cfg),
                                      torch.tensor(ids),
                                      output_hidden_states=True)
    assert per.shape == (2, 2, 10, cfg.hidden_size)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
