"""``molly_tpu_torch.parallel.pipeline`` held against
``molly_tpu.parallel.pipeline`` (``tests/test_pipeline.py:49-97``): the
GPipe decoder's loss and gradients at pipe=2 with 2 and 4 microbatches
against JAX's plain (unpipelined) ones, the first train step's loss and
gradient norm through ``make_train_step(pp_micro=2)``, and
``pp_param_specs`` leaf for leaf. The port's side runs in 2 gloo ranks (one
spawn). fp32; the JAX tests' tolerances."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from molly_tpu.models import fusion, tiny_esm, tiny_qwen3
from molly_tpu.models.fusion import FusionConfig
from molly_tpu.parallel.pipeline import pp_param_specs as jspecs
from molly_tpu.training import TrainConfig, init_train_state, make_train_step
from molly_tpu_torch.parallel import pp_param_specs
from molly_tpu_torch.parallel.launch import run_ranks
from test_torch_models import _tcfg_of

LOSS_RTOL = 2e-5                   # test_pipeline.py
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # test_pipeline.py's gradient tolerance
NORM_RTOL = 1e-3                   # test_pipeline.py's grad-norm tolerance


def _setup():
    cfg = FusionConfig(
        text=tiny_qwen3(vocab_size=64, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=4, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=8),
        dna_rna=tiny_esm(vocab_size=16), protein=tiny_esm(vocab_size=20),
        dna_rna_k_tokens=4, protein_k_tokens=4)
    params = fusion.init_params(cfg, jax.random.key(0))
    B, S = 4, 24
    rng = np.random.default_rng(1)
    labels = np.full((B, S), -100, np.int32)
    labels[:, 12:] = rng.integers(1, 64, (B, S - 12))
    mask = np.ones((B, S), np.int32)
    mask[1, S - 4:] = 0
    batch = {
        "input_ids": rng.integers(0, 64, (B, S)).astype(np.int32),
        "attention_mask": mask, "labels": labels,
        "dna_rna_tokens": rng.integers(2, 16, (B, 1, 4)).astype(np.int32),
        "dna_rna_pos": np.array([[1], [2], [-1], [0]], np.int32),
        "protein_tokens": np.full((B, 1, 4), 1, np.int32),
        "protein_pos": np.full((B, 1), -1, np.int32),
        "task_label": np.zeros((B,), np.int32),
    }
    return cfg, params, batch


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def pp():
    cfg, params, batch = _setup()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: fusion.loss_fn(p, cfg, jb)[0])(params)
    tc = TrainConfig(learning_rate=1e-3, total_steps=4, train_bio=True,
                     train_mlp=True, train_llm=True)
    _, m = jax.jit(make_train_step(cfg, tc))(init_train_state(params, tc),
                                             jb, jax.random.key(1))
    got = run_ranks(ranks.pipeline_cases, 2, (
        _tcfg_of(cfg), jax.tree.map(np.asarray, params), batch, (2, 4)))
    return {"loss": float(loss), "grads": _flat(jax.tree.map(np.asarray,
                                                             grads)),
            "step": {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])},
            "got": got, "params": params}


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pp_loss_and_grads_match_the_plain_decoder(pp, n_micro):
    for rank_out in pp["got"]:
        got = rank_out[n_micro]
        np.testing.assert_allclose(got["loss"], pp["loss"], rtol=LOSS_RTOL)
        assert set(got["grads"]) == set(pp["grads"])
        for path, ref in pp["grads"].items():
            np.testing.assert_allclose(got["grads"][path], ref,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=path)


def test_pp_train_step_matches_the_plain_step(pp):
    for rank_out in pp["got"]:
        np.testing.assert_allclose(rank_out["step"]["loss"],
                                   pp["step"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(rank_out["step"]["grad_norm"],
                                   pp["step"]["grad_norm"], rtol=NORM_RTOL)


def test_pp_param_specs_equal_jax(pp):
    params = pp["params"]
    for tree in (params, params["text"]):
        js = _flat(jspecs(tree))
        ts = _flat(pp_param_specs(jax.tree.map(np.asarray, tree)))
        assert {k: tuple(v) for k, v in js.items()} == ts
