"""The training slice of molly_tpu_torch held against molly_tpu on the CPU, in
fp32, at a tiny size: one step's loss and every trainable gradient against
``make_train_step`` in four regimes, the optimizer against optax, the
schedule, grad accumulation, remat, the non-finite guard, adapters crossing
between the packages, and the train loop's JSONL.

The JAX step does not hand out gradients; with ``grad_clip = 0`` the first
Adam moment after one step is ``(1 - b1) * g``, so the gradients are read
from the optimizer state. Tolerances are stated beside each comparison.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from molly_tpu.models import fusion as jfusion
from molly_tpu.models import lora as jlora
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.inference import engine as jengine
from molly_tpu.training import checkpoint as jckpt
from molly_tpu.training import trainer as jtrainer
from molly_tpu_torch.inference import engine
from molly_tpu_torch.models import lora, qwen3
from molly_tpu_torch.models.convert import (opt_state_from_numpy,
                                            params_from_jax)
from molly_tpu_torch.training import checkpoint as ckpt
from molly_tpu_torch.training import trainer
from test_torch_models import _fusion_batch, _fusion_setup, _tcfg_of

GRAD_RTOL = 1e-3   # of each gradient's max-abs (fp32, different sum orders)
LOSS_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _random_adapter(jcfg, r, seed):
    """An adapter with a non-zero B, so that A has a gradient."""
    rng = np.random.default_rng(seed)
    ad = jlora.init_lora(jcfg.text, jlora.LoraConfig(r=r),
                         jax.random.key(seed))
    return jax.tree.map(
        lambda x: jnp.asarray(x + 0.02 * rng.normal(size=x.shape).astype(
            np.float32)), ad)


def _tc(cls, lora_cls=None, **kw):
    if kw.get("lora") is not None and lora_cls is not None:
        kw["lora"] = lora_cls(**kw["lora"])
    return cls(**kw)


def _both_tc(**kw):
    return (_tc(jtrainer.TrainConfig, jlora.LoraConfig, **dict(kw)),
            _tc(trainer.TrainConfig, lora.LoraConfig, **dict(kw)))


def _jax_grads(state, b1=0.9):
    """{path: gradient} read from the first Adam moment after ONE step with
    grad_clip = 0 (mu = (1 - b1) * g)."""
    adam = [s for s in jax.tree.leaves(
        state.opt_state, is_leaf=lambda x: isinstance(
            x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(adam[0].mu)[0]:
        out["/".join(str(p.key) for p in kp)] = np.asarray(leaf) / (1 - b1)
    return out


def _regime(name):
    """(jax params, jax train cfg, torch params, torch train cfg, reference
    is exact)."""
    cfg = _fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(11))
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0,
              grad_clip=0.0)
    if name == "projector_only":
        kw["train_llm"] = False
    if name in ("lora", "qlora"):
        kw["lora"] = dict(r=4, alpha=8.0, dropout=0.0)
        jp = {**jp, "lora": _random_adapter(cfg, 4, 5)}
    tp = params_from_jax(_np_tree(jp))
    if name == "qlora":
        # the port multiplies the activations as given by the int8 weights
        # (what the Pallas kernel does); the JAX package's CPU path rounds
        # them to bf16 first. The exact reference is therefore the JAX LoRA
        # step over the DEQUANTIZED base.
        q = jqwen3.quantize_for_training(jp["text"], cfg.text)
        dense = {k: (v["w_q"].astype(jnp.float32) * v["scale"][:, None, :]
                     if isinstance(v, dict) else v)
                 for k, v in q["layers"].items()}
        jp = {**jp, "text": {**jp["text"], "layers": dense}}
        tp["text"] = qwen3.quantize_for_training(tp["text"],
                                                 _tcfg_of(cfg.text))
    jtc, ttc = _both_tc(**kw)
    return cfg, jp, jtc, tp, ttc


@pytest.mark.parametrize("name", ["full", "projector_only", "lora", "qlora"])
def test_one_step_loss_and_gradients_match_make_train_step(name):
    cfg, jp, jtc, tp, ttc = _regime(name)
    batch = _fusion_batch(cfg, B=4, S=48, seed=4)
    jstate = jtrainer.init_train_state(jp, jtc)
    jstate, jm = jtrainer.make_train_step(cfg, jtc)(
        jstate, _jbatch(batch), jax.random.key(0))
    ref = _jax_grads(jstate)

    trainer.init_train_state(tp, ttc)
    grads, tm = trainer.make_grad_fn(_tcfg_of(cfg), ttc)(tp, _tbatch(batch))
    paths = trainer.trainable_paths(tp, ttc)
    assert sorted(paths) == sorted(ref), (paths, sorted(ref))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=LOSS_ATOL)
    assert int(tm["tokens"]) == int(jm["tokens"])
    for k in ("domain_loss_sum", "domain_loss_count"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=1e-5)
    for path, g in zip(paths, grads):
        r = ref[path]
        tol = GRAD_RTOL * max(np.abs(r).max(), 1e-6)
        np.testing.assert_allclose(g.numpy(), r, atol=tol, err_msg=path)
    np.testing.assert_allclose(float(trainer.global_norm(grads)),
                               float(jm["grad_norm"]), rtol=1e-4)


def test_qlora_loss_close_to_the_jax_int8_path():
    """Against the JAX package's own int8 CPU path, which rounds the
    activations to bf16 before each int8 product: 3e-2 on the loss."""
    cfg, _, jtc, tp, ttc = _regime("qlora")
    jp = jfusion.init_params(cfg, jax.random.key(11))
    jp = {**jp, "lora": _random_adapter(cfg, 4, 5),
          "text": jqwen3.quantize_for_training(jp["text"], cfg.text)}
    batch = _fusion_batch(cfg, B=4, S=48, seed=4)
    _, jm = jtrainer.make_train_step(cfg, jtc)(
        jtrainer.init_train_state(jp, jtc), _jbatch(batch),
        jax.random.key(0))
    trainer.init_train_state(tp, ttc)
    _, tm = trainer.make_grad_fn(_tcfg_of(cfg), ttc)(tp, _tbatch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=3e-2)


def test_trainable_mask_matches_jax():
    cfg = _fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(0))
    jp = {**jp, "lora": _random_adapter(cfg, 2, 1)}
    tp = params_from_jax(_np_tree(jp))
    for kw in ({}, {"train_bio": True}, {"train_mlp": False},
               {"train_llm": False}, {"lora": dict(r=2)}):
        jtc, ttc = _both_tc(**kw)
        jm = jtrainer.trainable_mask(jp, jtc)
        tm = trainer.trainable_mask(tp, ttc)
        assert jax.tree.leaves(jm) == jax.tree.leaves(tm), kw


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup,total,floor", [(0.1, 50, 0.0),
                                                (0.03, 3, 0.0),
                                                (0.25, 8, 0.1)])
def test_schedule_values_match_optax(schedule, warmup, total, floor):
    jtc, ttc = _both_tc(learning_rate=3e-4, warmup_ratio=warmup,
                        total_steps=total, schedule=schedule,
                        min_lr_ratio=floor)
    js, ts = jtrainer.make_schedule(jtc), trainer.make_schedule(ttc)
    for step in range(total + 3):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5,
                                   atol=1e-12, err_msg=str(step))


@pytest.mark.parametrize("clip,decay", [(1.0, 0.0), (0.0, 0.0), (0.5, 0.1)])
def test_three_optimizer_steps_match_optax(clip, decay):
    """The written-out chain against optax on the same gradients: 1e-6 on
    parameters and moments."""
    rng = np.random.default_rng(0)
    shapes = {"text": {"w": (5, 7), "n": (7,)},
              "dna_rna": {"e": (3, 3)},
              "dna_rna_projector": {"kernel": (4, 6), "bias": (6,)}}
    params = {k: {n: rng.normal(size=s).astype(np.float32)
                  for n, s in v.items()} for k, v in shapes.items()}
    grads = [{k: {n: (3 * rng.normal(size=s)).astype(np.float32)
                  for n, s in v.items()} for k, v in shapes.items()}
             for _ in range(3)]
    jtc, ttc = _both_tc(learning_rate=1e-2, warmup_ratio=0.4, total_steps=5,
                        grad_clip=clip, weight_decay=decay)
    jp = jax.tree.map(jnp.asarray, params)
    tx = jtrainer.make_optimizer(jp, jtc)
    opt = tx.init(jp)
    tp = params_from_jax(params)
    state = trainer.init_train_state(tp, ttc)
    train = trainer._trainable_leaves(tp, ttc)
    paths = trainer.trainable_paths(tp, ttc)
    assert paths == ["text/w", "text/n", "dna_rna_projector/kernel",
                     "dna_rna_projector/bias"]
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        jg["dna_rna"] = jax.tree.map(jnp.zeros_like, jg["dna_rna"])
        upd, opt = tx.update(jg, opt, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [_t(g[p.split("/")[0]][p.split("/")[1]]) for p in paths]
        trainer.apply_optimizer(train, tg, state.opt_state, ttc,
                                trainer.global_norm(tg))
    for p, leaf in zip(paths, train):
        a, b = p.split("/")
        np.testing.assert_allclose(leaf.detach().numpy(),
                                   np.asarray(jp[a][b]), atol=1e-6,
                                   err_msg=p)
    np.testing.assert_array_equal(tp["dna_rna"]["e"].numpy(),
                                  params["dna_rna"]["e"])   # frozen
    assert state.opt_state["count"] == 3


def test_three_train_steps_match_the_jax_step():
    """Loss and gradient norm of three consecutive steps (clip on, warmup,
    weight decay): 1e-4 relative, the drift of fp32 sums over three
    updates."""
    cfg = _fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(12))
    tp = params_from_jax(_np_tree(jp))
    jtc, ttc = _both_tc(learning_rate=1e-3, total_steps=4, warmup_ratio=0.5,
                        weight_decay=0.01, grad_clip=1.0)
    jstep = jtrainer.make_train_step(cfg, jtc)
    tstep = trainer.make_train_step(_tcfg_of(cfg), ttc)
    jstate = jtrainer.init_train_state(jp, jtc)
    tstate = trainer.init_train_state(tp, ttc)
    for i in range(3):
        batch = _fusion_batch(cfg, B=4, S=48, seed=20 + i)
        jstate, jm = jstep(jstate, _jbatch(batch), jax.random.key(i))
        tstate, tm = tstep(tstate, _tbatch(batch), None)
        for k in ("loss", "grad_norm", "learning_rate"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} step {i}")
        assert bool(tm["skipped"]) == bool(jm["skipped"]) is False
        assert set(tm) == set(jm)
    assert tstate.step == int(jstate.step) == 3
    np.testing.assert_allclose(
        tstate.params["protein_projector"]["kernel"].detach().numpy(),
        np.asarray(jstate.params["protein_projector"]["kernel"]), atol=1e-5)


def test_grad_accumulation_2x2_matches_the_jax_step():
    cfg = _fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(13))
    tp = params_from_jax(_np_tree(jp))
    jtc, ttc = _both_tc(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0,
                        grad_clip=0.0, accum_steps=2)
    batch = _fusion_batch(cfg, B=4, S=48, seed=6)
    batch["labels"][0, :40] = -100   # microbatches with unequal token counts
    jstate, jm = jtrainer.make_train_step(cfg, jtc)(
        jtrainer.init_train_state(jp, jtc), _jbatch(batch),
        jax.random.key(0))
    ref = _jax_grads(jstate)
    trainer.init_train_state(tp, ttc)
    grads, tm = trainer.make_grad_fn(_tcfg_of(cfg), ttc)(tp, _tbatch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=LOSS_ATOL)
    assert int(tm["tokens"]) == int(jm["tokens"])
    for path, g in zip(trainer.trainable_paths(tp, ttc), grads):
        tol = GRAD_RTOL * max(np.abs(ref[path]).max(), 1e-6)
        np.testing.assert_allclose(g.numpy(), ref[path], atol=tol,
                                   err_msg=path)
    # and it is not the same as one pass over the whole batch
    _, ttc1 = _both_tc(grad_clip=0.0)
    _, m1 = trainer.make_grad_fn(_tcfg_of(cfg), ttc1)(tp, _tbatch(batch))
    assert abs(float(m1["loss"]) - float(tm["loss"])) > 1e-4


@pytest.mark.parametrize("kw", [dict(remat=True),
                                dict(remat=True, remat_skip_layers=1),
                                dict(remat=True, remat_policy="attn"),
                                dict(remat=True, remat_policy="hot")])
def test_remat_gradients_bit_equal_to_no_remat(kw):
    cfg = _tcfg_of(_fusion_setup())
    tp = params_from_jax(_np_tree(jfusion.init_params(
        _fusion_setup(), jax.random.key(14))))
    tp["lora"] = params_from_jax(_np_tree(_random_adapter(
        _fusion_setup(), 2, 3)))
    ttc = trainer.TrainConfig(lora=lora.LoraConfig(r=2, dropout=0.5))
    trainer.init_train_state(tp, ttc)
    batch = _tbatch(_fusion_batch(_fusion_setup(), B=4, S=32, seed=7))

    def grads(c):
        g, m = trainer.make_grad_fn(c, ttc)(
            tp, batch, torch.Generator().manual_seed(9))
        return g, float(m["loss"])

    base, base_loss = grads(cfg)
    got, loss = grads(dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, **kw)))
    assert loss == base_loss
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    assert any(bool(g.any()) for g in got)


def test_non_finite_guard_keeps_the_old_state():
    cfg = _fusion_setup()
    tp = params_from_jax(_np_tree(jfusion.init_params(
        cfg, jax.random.key(15))))
    ttc = trainer.TrainConfig(learning_rate=1e-2, warmup_ratio=0.0)
    state = trainer.init_train_state(tp, ttc)
    step = trainer.make_train_step(_tcfg_of(cfg), ttc)
    batch = _tbatch(_fusion_batch(cfg, B=4, S=32, seed=8))
    state, m = step(state, batch, None)
    assert not m["skipped"] and state.opt_state["count"] == 1
    before = {p: t.detach().clone() for p, t in zip(
        trainer.trainable_paths(tp, ttc),
        trainer._trainable_leaves(tp, ttc))}
    mu_before = [t.clone() for t in state.opt_state["mu"]]
    with torch.no_grad():
        tp["text"]["final_norm"][0] = float("nan")
    state, m = step(state, batch, None)
    assert m["skipped"] is True and state.step == 2
    assert state.opt_state["count"] == 1
    for p, t in zip(trainer.trainable_paths(tp, ttc),
                    trainer._trainable_leaves(tp, ttc)):
        if p != "text/final_norm":
            assert torch.equal(t.detach(), before[p]), p
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state["mu"],
                                                 mu_before))


# ------------------------------------------------------------ checkpoints


def test_adapter_npz_crosses_between_the_packages(tmp_path):
    """An adapter exported by either package loads in the other, and greedy
    generation after merge_lora is token-exact."""
    cfg = _fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(16))
    jad = _random_adapter(cfg, 4, 9)
    jlc, tlc = jlora.LoraConfig(r=4, alpha=12.0), lora.LoraConfig(r=4,
                                                                  alpha=12.0)
    tp = params_from_jax(_np_tree(jp))
    tad = params_from_jax(_np_tree(jad))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.export_adapter(jpath, {**jp, "lora": jad}, lora_cfg=jlc)
    ckpt.export_adapter(tpath, {**tp, "lora": tad}, lora_cfg=tlc)
    a, b = np.load(jpath), np.load(tpath)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ckpt.adapter_meta(jpath) == jckpt.adapter_meta(tpath) == \
        {"r": 4, "alpha": 12.0}

    # fresh trees with other projectors: the archive must replace them
    jp2 = jfusion.init_params(cfg, jax.random.key(17))
    jp2 = {**jp2, "text": jp["text"], "dna_rna": jp["dna_rna"],
           "protein": jp["protein"]}
    tp2 = params_from_jax(_np_tree(jp2))
    from_torch = jckpt.load_adapter(tpath, jp2)      # port -> JAX
    from_jax = ckpt.load_adapter(jpath, tp2)         # JAX -> port
    for t in jad["layers"]:
        for k in "ab":
            np.testing.assert_array_equal(
                from_jax["lora"]["layers"][t][k].numpy(),
                np.asarray(from_torch["lora"]["layers"][t][k]))
    np.testing.assert_array_equal(
        from_jax["protein_projector"]["kernel"].numpy(),
        np.asarray(jp["protein_projector"]["kernel"]))

    batch = _fusion_batch(cfg, B=4, S=40, seed=5)
    gen = jengine.GenerationConfig(max_new_tokens=6, do_sample=False,
                                   repetition_penalty=1.0, eos_token_id=3,
                                   pad_token_id=0)
    ref = np.asarray(jengine.generate(from_torch, cfg, _jbatch(batch), gen,
                                      jax.random.key(0), lora_alpha=12.0))
    got = engine.generate(from_jax, _tcfg_of(cfg), batch, _tcfg_of(gen),
                          lora_alpha=12.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    base = engine.generate(tp2, _tcfg_of(cfg), batch, _tcfg_of(gen))
    assert not np.array_equal(base.numpy(), ref)  # the adapter matters


def test_train_state_round_trip(tmp_path):
    cfg = _fusion_setup()
    tp = params_from_jax(_np_tree(jfusion.init_params(
        cfg, jax.random.key(18))))
    ttc = trainer.TrainConfig(learning_rate=1e-2, warmup_ratio=0.0)
    state = trainer.init_train_state(tp, ttc)
    step = trainer.make_train_step(_tcfg_of(cfg), ttc)
    batch = _tbatch(_fusion_batch(cfg, B=4, S=32, seed=8))
    state, _ = step(state, batch, None)
    path = str(tmp_path / "ckpt_1")
    ckpt.save_train_state(path, state)
    ckpt.wait_for_saves()
    want = tp["protein_projector"]["kernel"].detach().clone()
    state, m2 = step(state, batch, None)             # moves on

    tp2 = params_from_jax(_np_tree(jfusion.init_params(
        cfg, jax.random.key(19))))
    fresh = trainer.init_train_state(tp2, ttc)
    restored = ckpt.restore_train_state(path, fresh)
    assert restored.step == 1 and restored.opt_state["count"] == 1
    assert torch.equal(restored.params["protein_projector"]["kernel"], want)
    assert restored.params["protein_projector"]["kernel"].requires_grad
    _, m2b = step(restored, batch, None)             # same second step
    assert float(m2b["loss"]) == float(m2["loss"])
    grafted = ckpt.graft_params(tp2, ckpt.load_params(path))
    assert torch.equal(grafted["protein_projector"]["kernel"], want)


def test_optimizer_state_from_numpy_moments():
    cfg = _fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(20))
    tp = params_from_jax(_np_tree(jp))
    ttc = trainer.TrainConfig()
    state = trainer.init_train_state(tp, ttc)
    mu = jax.tree.map(lambda x: np.full(x.shape, 0.5, np.float32),
                      _np_tree(jp))
    nu = jax.tree.map(lambda x: np.full(x.shape, 0.25, np.float32),
                      _np_tree(jp))
    opt = opt_state_from_numpy(mu, nu, 7, tp, ttc)
    assert opt["count"] == 7
    assert [m.shape for m in opt["mu"]] == \
        [m.shape for m in state.opt_state["mu"]]
    assert all(bool((m == 0.5).all()) for m in opt["mu"])
    assert all(bool((v == 0.25).all()) for v in opt["nu"])


# ---------------------------------------------------------------- the CLI


def test_train_loop_tiny_writes_the_jax_clis_jsonl_keys(tmp_path):
    from test_train_cli import _toy_parquet

    from molly_tpu.training.cli import build_argparser as jparser
    from molly_tpu.training.cli import run_training as jrun
    from molly_tpu_torch.training.cli import build_argparser, run_training

    data = str(tmp_path / "train.parquet")
    _toy_parquet(data, 16)   # the JAX CLI shards a batch over all 8 devices
    common = ["--train-dataset-path", data, "--eval-dataset-path", data,
              "--tiny", "--dtype", "float32", "--max-len", "192",
              "--eval-max-len", "192", "--dna-rna-k-tokens", "4",
              "--protein-k-tokens", "4", "--batch-size-per-gpu", "8",
              "--train-iters", "2", "--log-interval", "1",
              "--eval-interval", "2", "--save-interval", "2", "--lr", "1e-3",
              "--compute-domain-losses", "true", "--use-lora", "true",
              "--lora-r", "2"]
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jres = jrun(jparser().parse_args(common + ["--output-dir", jout]))
    tres = run_training(build_argparser().parse_args(
        common + ["--output-dir", tout, "--device", "cpu"]))
    assert tres["steps"] == jres["steps"] == 2
    assert set(jres) <= set(tres)
    jrec = [json.loads(l) for l in open(os.path.join(jout, "molly_tpu.jsonl"))]
    trec = [json.loads(l) for l in open(os.path.join(tout, "molly_tpu.jsonl"))]
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    assert os.path.exists(os.path.join(tout, "ckpt_2", "state.pt"))
    # the adapter the port's CLI wrote loads in the JAX package
    meta = jckpt.adapter_meta(os.path.join(tout, "adapter_2.npz"))
    assert meta == {"r": 2, "alpha": 64.0}


def test_train_cli_flags_match_the_jax_cli_and_build_the_mesh():
    from molly_tpu.parallel import make_mesh as jmake_mesh
    from molly_tpu.training.cli import build_argparser as jparser
    from molly_tpu_torch.training.cli import build_argparser, build_mesh

    def flags(p):
        return {a.dest: a.default for a in p._actions if a.dest != "help"}

    jf, tf = flags(jparser()), flags(build_argparser())
    assert {k: tf[k] for k in jf} == jf       # same flags, same defaults
    assert set(tf) - set(jf) == {"device"}
    base = ["--train-dataset-path", "x.parquet"]
    # every mesh flag parses and builds the JAX CLI's mesh (one process:
    # every axis 1, as the JAX CLI's mesh over one device)
    for extra in ([], ["--mesh-data", "1"], ["--mesh-fsdp", "-1"],
                  ["--mesh-fsdp", "1", "--mesh-expert", "1"],
                  ["--mesh-seq", "1", "--cp-zigzag", "true"]):
        mesh = build_mesh(build_argparser().parse_args(base + extra))
        jmesh = jmake_mesh(devices=jax.devices()[:1])
        assert mesh.shape == dict(jmesh.shape)
    mesh = build_mesh(build_argparser().parse_args(
        base + ["--mesh-pipe", "1"]))
    assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1,
                          "expert": 1}
    # the layout of a multi-rank flag set is the JAX CLI's too
    from molly_tpu_torch.parallel import make_mesh
    args = build_argparser().parse_args(
        base + ["--mesh-data", "2", "--mesh-tensor", "2"])
    got = make_mesh(data=args.mesh_data, fsdp=args.mesh_fsdp,
                    tensor=args.mesh_tensor, devices=list(range(8)))
    ref = jmake_mesh(data=2, fsdp=-1, tensor=2)
    assert got.shape == dict(ref.shape)
    np.testing.assert_array_equal(
        got.devices, np.vectorize(lambda d: d.id)(ref.devices))