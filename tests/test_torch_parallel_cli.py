"""The port's train CLI under a spawned process group, one step per mesh
kind, against the JAX CLI's first-step metrics on its virtual-device mesh
(``test_ring_attention.py:125``, ``test_pipeline.py:129``): (fsdp, tensor),
(fsdp, seq) with ``--cp-zigzag``, (pipe, data) with 2 microbatches and
(fsdp, expert) over a MoE decoder. The JAX CLI spreads the global batch
over all 8 virtual devices, the port over 4 gloo ranks (one spawn for the
four runs); both start from the same weights (the JAX CLI's init, handed
to the port through ``--init-from``) and read the same 4 rows as one
global batch, each rank its (data, fsdp) shard of them. fp32."""

import json
import os

import numpy as np
import pytest
import torch

import jax

import torch_parallel_ranks as ranks
from molly_tpu.models import fusion as jfusion
from molly_tpu.training import cli as jcli
from molly_tpu_torch.models.convert import params_from_jax
from molly_tpu_torch.parallel.launch import run_ranks
from test_train_cli import _toy_parquet

LOSS_RTOL = 2e-5   # test_sharding.py's loss tolerance
NORM_RTOL = 1e-3   # test_pipeline.py's grad-norm tolerance

# mesh kind -> (JAX CLI flags on 8 devices, port flags on 4 ranks, extra)
KINDS = {
    "fsdp_tensor": (["--mesh-tensor", "2"],
                    ["--mesh-fsdp", "2", "--mesh-tensor", "2"], []),
    "seq_zigzag": (["--mesh-seq", "2", "--cp-zigzag", "true"],
                   ["--mesh-fsdp", "2", "--mesh-seq", "2", "--cp-zigzag",
                    "true"], []),
    "pipe": (["--mesh-pipe", "2", "--pp-microbatches", "2"],
             ["--mesh-pipe", "2", "--pp-microbatches", "2"], []),
    "expert": (["--mesh-expert", "2"],
               ["--mesh-fsdp", "2", "--mesh-expert", "2"],
               ["--moe-experts", "4", "--moe-topk", "2"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    data = str(tmp / "train.parquet")
    _toy_parquet(data, 4)
    common = ["--train-dataset-path", data, "--tiny", "--dtype", "float32",
              "--max-len", "192", "--dna-rna-k-tokens", "4",
              "--protein-k-tokens", "4", "--batch-size-per-gpu", "4",
              "--train-iters", "1", "--log-interval", "1", "--lr", "1e-3",
              "--save-interval", "100", "--prefetch-depth", "0"]
    jax_metrics, calls, inits = {}, [], {}
    real_init = jfusion.init_params
    for kind, (jflags, tflags, extra) in KINDS.items():
        seen = {}

        def capture(*a, **kw):
            seen["params"] = real_init(*a, **kw)
            return seen["params"]

        jfusion.init_params = capture
        try:
            jout = str(tmp / f"j_{kind}")
            jcli.run_training(jcli.build_argparser().parse_args(
                common + extra + jflags + ["--output-dir", jout]))
        finally:
            jfusion.init_params = real_init
        rec = [json.loads(line) for line in
               open(os.path.join(jout, "molly_tpu.jsonl"))]
        jax_metrics[kind] = rec[0]
        inits[kind] = seen["params"]
        init = str(tmp / f"init_{kind}")
        os.makedirs(init)
        torch.save({"params": params_from_jax(
            jax.tree.map(np.asarray, seen["params"]))},
            os.path.join(init, "state.pt"))
        calls.append(("cli_step", (common + extra + tflags + [
            "--output-dir", str(tmp / f"t_{kind}"), "--device", "cpu",
            "--init-from", init],)))
    # a resume of the (fsdp, tensor) run from the checkpoint it wrote
    fsdp_tensor = calls[0][1][0]
    calls.append(("cli_step", (fsdp_tensor[:fsdp_tensor.index(
        "--output-dir")] + ["--output-dir", str(tmp / "t_resumed"),
                            "--device", "cpu", "--resume-from",
                            str(tmp / "t_fsdp_tensor" / "ckpt_1")],)))
    got = run_ranks(ranks.many, 4, (calls,))
    saved = torch.load(str(tmp / "t_fsdp_tensor" / "ckpt_1" / "state.pt"),
                       weights_only=True)
    return (jax_metrics, {kind: [r[i] for r in got]
                          for i, kind in enumerate(KINDS)},
            [r[-1] for r in got], saved, inits["fsdp_tensor"])


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_cli_step_matches_the_jax_cli(runs, kind):
    jm, got = runs[0][kind], runs[1][kind]
    for history in got:  # every rank reports the global batch's metrics
        assert len(history) == 1
        step = history[0]
        np.testing.assert_allclose(step["loss"], jm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(step["grad_norm"], jm["grad_norm"],
                                   rtol=NORM_RTOL)
        assert not step["skipped"]
        if kind == "expert":
            np.testing.assert_allclose(step["moe_load_balance"],
                                       jm["moe_load_balance"], rtol=1e-5)
            assert step["moe_ep_dropped_frac"] == 0.0


def test_checkpoint_is_whole_and_a_resume_reshards_it(runs):
    """Rank 0 wrote the gathered state (every leaf at its whole shape), and
    a run resumed from it under the same mesh starts where the first run
    ended: its first loss is below the first run's (one step at lr 1e-3
    on the same rows), the same on every rank."""
    _, got, resumed, saved, jparams = runs
    whole = {k: tuple(v.shape) for k, v in ranks._flat(
        jax.tree.map(np.asarray, jparams)).items()}
    assert {k: tuple(v.shape) for k, v in
            ranks._flat(saved["params"]).items()} == whole
    first = got["fsdp_tensor"][0][0]["loss"]
    losses = [h[0]["loss"] for h in resumed]
    assert len(set(losses)) == 1 and losses[0] < first
