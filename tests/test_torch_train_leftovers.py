"""The last one-device training options of molly_tpu_torch held against the
port's own default path and against molly_tpu on the CPU, in fp32, at a
tiny size: the ``dots`` remat policy (loss and gradients against no remat,
dense with LoRA dropout and the tiny MoE, and against JAX's ``dots``), the
optimizer moments offloaded to host memory (three steps, a skipped
non-finite one among them, bit-equal to the default step; a checkpoint
round trip), the train CLI with both options, and three small helpers
against their JAX functions. Tolerances are stated beside each comparison.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.models import esm as jesm
from molly_tpu.models import fusion as jfusion
from molly_tpu.ops import attention as jattention
from molly_tpu.training import trainer as jtrainer
from molly_tpu_torch.models import esm, fusion, lora, qwen3
from molly_tpu_torch.models.convert import params_from_jax
from molly_tpu_torch.ops import attention
from molly_tpu_torch.training import checkpoint as ckpt
from molly_tpu_torch.training import trainer
from test_torch_models import _fusion_batch, _fusion_setup, _tcfg_of
from test_torch_moe import _moe_batch, _moe_regime
from test_torch_training import (_jax_grads, _jbatch, _np_tree,
                                 _random_adapter, _regime, _tbatch)

DOTS_ATOL = 1e-5   # dots against no remat and against JAX's dots, fp32


@pytest.fixture(autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread, as the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_remat(cfg, **kw):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, **kw))


def _dense_lora_dropout():
    """The dense fusion model with a random adapter and LoRA dropout 0.5:
    the recompute must draw the forward's masks again."""
    jcfg = _fusion_setup()
    tp = params_from_jax(_np_tree(jfusion.init_params(jcfg,
                                                      jax.random.key(14))))
    tp["lora"] = params_from_jax(_np_tree(_random_adapter(jcfg, 2, 3)))
    ttc = trainer.TrainConfig(lora=lora.LoraConfig(r=2, dropout=0.5))
    batch = _tbatch(_fusion_batch(jcfg, B=4, S=32, seed=7))
    return _tcfg_of(jcfg), tp, ttc, batch


def _moe_full():
    cfg, _, _, tp, ttc = _moe_regime("full")
    return _tcfg_of(cfg), tp, ttc, _tbatch(_moe_batch(cfg, B=4, S=32,
                                                       seed=4))


def _moe_lora():
    cfg, _, _, tp, ttc = _moe_regime("lora")
    return _tcfg_of(cfg), tp, ttc, _tbatch(_moe_batch(cfg, B=4, S=32,
                                                       seed=5))


CASES = {"dense-lora-dropout": _dense_lora_dropout, "moe-full": _moe_full,
         "moe-lora": _moe_lora}


def _grads(cfg, tp, ttc, batch):
    trainer.init_train_state(tp, ttc)
    g, m = trainer.make_grad_fn(cfg, ttc)(tp, batch,
                                          torch.Generator().manual_seed(9))
    return g, m


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dots_loss_and_gradients_equal_no_remat(case, skip):
    """Loss and every trainable gradient under ``dots`` (the first ``skip``
    layers unchecked) equal the step without remat: within 1e-5, and in
    fact bit for bit (the saved products are the forward's, the recompute
    runs the same ops on the same data)."""
    cfg, tp, ttc, batch = CASES[case]()
    base, bm = _grads(cfg, tp, ttc, batch)
    got, m = _grads(_with_remat(cfg, remat=True, remat_policy="dots",
                                remat_skip_layers=skip), tp, ttc, batch)
    assert abs(float(m["loss"]) - float(bm["loss"])) <= DOTS_ATOL
    for k in ("moe_load_balance",):
        if k in bm:
            assert float(m[k]) == float(bm[k])
    for a, b in zip(got, base):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=DOTS_ATOL)
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    assert float(m["loss"]) == float(bm["loss"])
    assert any(bool(g.any()) for g in got)


def test_dots_saves_the_matrix_products_and_recomputes_the_rest(
        monkeypatch):
    """The policy saves the 2-D products (the layer linears, the LoRA
    bypasses, the MoE router) and nothing else; the backward then runs no
    forward product again, where ``full`` runs every one of them twice."""
    cfg, tp, ttc, batch = _moe_lora()
    decisions = []
    real = qwen3._dots_policy

    def policy(ctx, op, *args, **kwargs):
        out = real(ctx, op, *args, **kwargs)
        decisions.append((op, out))
        return out

    monkeypatch.setattr(qwen3, "_dots_policy", policy)
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.checkpoint import CheckpointPolicy

    class CountMm(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in qwen3._SAVED_DOTS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    def backward_mms(policy_kw):
        run_cfg = _with_remat(cfg, remat=True, **policy_kw)
        trainer.init_train_state(tp, ttc)
        train = trainer._trainable_leaves(tp, ttc)
        embeds = fusion.build_inputs_embeds(tp, run_cfg, batch)
        hidden, _ = qwen3.forward_hidden(
            tp["text"], run_cfg.text, inputs_embeds=embeds.detach(),
            attention_mask=batch["attention_mask"], lora=tp["lora"],
            lora_scale=2.0)
        loss = hidden.square().mean()
        with CountMm() as count:
            torch.autograd.grad(loss, train, allow_unused=True)
        return count.n

    with_dots = backward_mms(dict(remat_policy="dots"))
    saved = [op for op, p in decisions if p == CheckpointPolicy.MUST_SAVE]
    assert saved and set(saved) <= qwen3._SAVED_DOTS
    recomputed = {op for op, p in decisions
                  if p == CheckpointPolicy.PREFER_RECOMPUTE}
    assert torch.ops.aten.bmm.default not in set(saved)
    assert not recomputed & qwen3._SAVED_DOTS
    with_full = backward_mms(dict(remat_policy="full"))
    # under full the recompute runs every saved product again
    assert with_full == with_dots + len(saved)


def test_dots_gradients_match_jax_dots():
    """A full fine-tune step under ``dots`` in both packages: loss within
    1e-5, every trainable gradient within 1e-5 (JAX's read from its first
    Adam moment, as ``test_torch_training`` reads them)."""
    cfg, jp, jtc, tp, ttc = _regime("full")
    cfg = _with_remat(cfg, remat=True, remat_policy="dots")
    batch = _fusion_batch(cfg, B=4, S=48, seed=4)
    jstate = jtrainer.init_train_state(jp, jtc)
    jstate, jm = jtrainer.make_train_step(cfg, jtc)(
        jstate, _jbatch(batch), jax.random.key(0))
    ref = _jax_grads(jstate)
    trainer.init_train_state(tp, ttc)
    grads, tm = trainer.make_grad_fn(_tcfg_of(cfg), ttc)(tp, _tbatch(batch))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= DOTS_ATOL
    paths = trainer.trainable_paths(tp, ttc)
    assert sorted(paths) == sorted(ref)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), ref[path], atol=DOTS_ATOL,
                                   err_msg=path)


def test_unknown_remat_policy_raises():
    cfg, tp, ttc, batch = _dense_lora_dropout()
    with pytest.raises(ValueError, match="remat_policy"):
        _grads(_with_remat(cfg, remat=True, remat_policy="nope"), tp, ttc,
               batch)


# ------------------------------------------------------------ offload


def _offload_run(offload, steps=3, nan_at=1):
    """Three steps of the full fine-tune with weight decay; step ``nan_at``
    (0-based) sees a NaN in a trainable norm and must be skipped. Returns
    the trainable leaves and both moments after every step, the metrics
    and the final state."""
    jcfg = _fusion_setup()
    tp = params_from_jax(_np_tree(jfusion.init_params(jcfg,
                                                      jax.random.key(15))))
    ttc = trainer.TrainConfig(learning_rate=1e-2, warmup_ratio=0.0,
                              weight_decay=0.1, offload_opt_state=offload)
    state = trainer.init_train_state(tp, ttc)
    step = trainer.make_train_step(_tcfg_of(jcfg), ttc)
    stats = {}
    if offload:
        state = trainer.offload_opt_state(state)
        step = trainer.make_offloaded_step(step, state, stats)
    after, metrics = [], []
    for i in range(steps):
        batch = _tbatch(_fusion_batch(jcfg, B=4, S=32, seed=20 + i))
        saved = None
        if i == nan_at:
            saved = tp["text"]["final_norm"][0].item()
            with torch.no_grad():
                tp["text"]["final_norm"][0] = float("nan")
        state, m = step(state, batch, None)
        if saved is not None:
            with torch.no_grad():
                tp["text"]["final_norm"][0] = saved
        metrics.append(m)
        after.append(([t.detach().clone() for t in
                       trainer._trainable_leaves(tp, ttc)],
                      [t.clone() for t in state.opt_state["mu"]],
                      [t.clone() for t in state.opt_state["nu"]]))
    return after, metrics, state, stats


def test_offloaded_steps_bit_equal_to_the_default_step(monkeypatch):
    """Three steps, the second skipped by the non-finite guard: params and
    both moments after every step equal bit for bit; the skipped step
    leaves the moments and the optimizer count as they were. The staging
    slots hold 1,000 elements here, so larger leaves stream in chunks."""
    monkeypatch.setattr(trainer, "_OFFLOAD_CHUNK", 1000)
    ref, rm, rstate, _ = _offload_run(False)
    got, gm, gstate, stats = _offload_run(True)
    assert [m["skipped"] for m in gm] == [m["skipped"] for m in rm] == \
        [False, True, False]
    assert gstate.opt_state["count"] == rstate.opt_state["count"] == 2
    assert set(gstate.opt_state) == {"mu", "nu", "count"}
    for (p0, mu0, nu0), (p1, mu1, nu1) in zip(ref, got):
        assert all(torch.equal(a, b) for a, b in zip(p0, p1))
        assert all(torch.equal(a, b) for a, b in zip(mu0, mu1))
        assert all(torch.equal(a, b) for a, b in zip(nu0, nu1))
    # the skipped step moved nothing
    assert all(torch.equal(a, b) for a, b in zip(got[0][1], got[1][1]))
    n_bytes = sum(t.numel() * t.element_size()
                  for t in gstate.opt_state["mu"])
    assert stats["offload_bytes"] == 2 * 4 * n_bytes  # 2 steps, in and out


def test_offload_placement_on_the_cpu():
    """On the CPU the params already live in host memory: the moments stay
    ordinary (unpinned) CPU tensors, placed by ``host_opt_shardings``, and
    ``offload_opt_state`` keeps them, in place."""
    jcfg = _fusion_setup()
    tp = params_from_jax(_np_tree(jfusion.init_params(jcfg,
                                                      jax.random.key(1))))
    state = trainer.init_train_state(tp, trainer.TrainConfig())
    place = trainer.host_opt_shardings(state)
    assert len(place["mu"]) == len(state.opt_state["mu"]) > 0
    assert {(p.device.type, p.pinned) for p in place["mu"] + place["nu"]} \
        == {("cpu", False)}
    mu = state.opt_state["mu"]
    before = list(mu)
    off = trainer.offload_opt_state(state)
    assert off.opt_state["mu"] is mu
    assert all(a is b for a, b in zip(mu, before))
    # with offload_opt_state the moments are made in host memory at init
    state = trainer.init_train_state(tp, trainer.TrainConfig(
        offload_opt_state=True))
    assert all(t.device.type == "cpu" and not t.any()
               for t in state.opt_state["mu"] + state.opt_state["nu"])


def test_offloaded_state_round_trips_through_a_checkpoint(tmp_path):
    _, _, state, _ = _offload_run(True, steps=2, nan_at=-1)
    path = str(tmp_path / "ckpt")
    ckpt.save_train_state(path, state)
    # restore into a fresh offloaded state: the values land in ITS host
    # tensors, which stay where they were placed
    jcfg = _fusion_setup()
    tp = params_from_jax(_np_tree(jfusion.init_params(jcfg,
                                                      jax.random.key(2))))
    ttc = trainer.TrainConfig(offload_opt_state=True)
    fresh = trainer.offload_opt_state(trainer.init_train_state(tp, ttc))
    host = list(fresh.opt_state["mu"]) + list(fresh.opt_state["nu"])
    restored = ckpt.restore_train_state(path, fresh)
    assert restored.step == 2 and restored.opt_state["count"] == 2
    assert all(a is b for a, b in zip(
        restored.opt_state["mu"] + restored.opt_state["nu"], host))
    for name in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(
            restored.opt_state[name], state.opt_state[name]))
    assert all(torch.equal(a, b) for a, b in zip(
        trainer._trainable_leaves(restored.params, ttc),
        trainer._trainable_leaves(state.params, ttc)))


def test_train_cli_with_offload_and_dots_equals_the_default(tmp_path):
    """The train CLI end to end on the CPU with ``--offload-opt-state true
    --gradient-checkpointing true --remat-policy dots``: every step's loss
    and gradient norm equal the run without them, bit for bit, and the
    saved state restores."""
    from test_train_cli import _toy_parquet

    from molly_tpu_torch.training.cli import build_argparser, run_training

    data = str(tmp_path / "train.parquet")
    _toy_parquet(data, 8)
    common = ["--train-dataset-path", data, "--tiny", "--dtype", "float32",
              "--max-len", "192", "--dna-rna-k-tokens", "4",
              "--protein-k-tokens", "4", "--batch-size-per-gpu", "4",
              "--train-iters", "2", "--log-interval", "1",
              "--save-interval", "2", "--lr", "1e-3", "--device", "cpu"]
    runs = {}
    for name, extra in (("default", []), ("offload+dots", [
            "--offload-opt-state", "true", "--gradient-checkpointing",
            "true", "--remat-policy", "dots"])):
        out = str(tmp_path / name)
        res = run_training(build_argparser().parse_args(
            common + extra + ["--output-dir", out]))
        runs[name] = (res, [json.loads(l) for l in open(
            os.path.join(out, "molly_tpu.jsonl"))])
    (ref, rrec), (got, grec) = runs["default"], runs["offload+dots"]
    assert got["steps"] == ref["steps"] == 2
    assert [(h["loss"], h["grad_norm"]) for h in got["history"]] == \
        [(h["loss"], h["grad_norm"]) for h in ref["history"]]
    assert grec == rrec
    assert os.path.exists(tmp_path / "offload+dots" / "ckpt_2" / "state.pt")
    state = got["state"]
    for name in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(
            state.opt_state[name], ref["state"].opt_state[name]))


# ------------------------------------------------------------ helpers


def test_erf_gelu_matches_jax():
    x = np.random.default_rng(0).normal(size=(3, 17)).astype(np.float32) * 4
    np.testing.assert_allclose(
        esm.erf_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jesm.erf_gelu(jnp.asarray(x))), atol=1e-6)


def test_shift_for_next_token_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 7, 5)).astype(np.float32)
    labels = rng.integers(-100, 5, (2, 7))
    ref = jfusion.shift_for_next_token(jnp.asarray(logits),
                                       jnp.asarray(labels))
    got = fusion.shift_for_next_token(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_rep", [1, 3])
def test_repeat_kv_matches_jax(n_rep):
    x = np.random.default_rng(2).normal(size=(2, 5, 2, 4)).astype(np.float32)
    got = attention.repeat_kv(torch.from_numpy(x), n_rep)
    ref = np.asarray(jattention.repeat_kv(jnp.asarray(x), n_rep))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
