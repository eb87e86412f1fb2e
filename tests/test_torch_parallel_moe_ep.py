"""``molly_tpu_torch.ops.moe.moe_mlp_expert_sharded`` and the MoE decoder
under expert parallelism, held against ``molly_tpu`` on its virtual-device
mesh: values, ``load_balance``, ``router_z`` and the gradients of x and the
router at expert=2 and expert=4, ``ep_dropped_frac`` exactly (also with
drops), int8 experts, a fused gate-and-up stack and expert LoRA; then the
MoE decoder's loss and gradients with ``expert_parallel`` at (expert=2) and
(fsdp=2, expert=2) against JAX's unsharded ones, at (fsdp=2, expert=2) with
buffers that overflow against JAX on the same mesh (the global batch's
drops), and its KV-cache decode at 2e-4 (``test_moe.py:647-699``). The port's side runs in gloo ranks, one
spawn per world size. fp32; tolerances beside each comparison."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.models import tiny_moe
from molly_tpu.ops.moe import (moe_mlp, moe_mlp_expert_sharded,
                               quantize_experts)
from molly_tpu.parallel import make_mesh
from molly_tpu_torch.parallel.launch import run_ranks
from test_torch_models import _tcfg_of

ATOL = 1e-5                      # test_moe.py's EP value tolerance
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5  # test_moe.py's sharded-grad tolerance
DECODE_TOL = 2e-4                # test_moe.py:680


def _weights(seed, E=4, H=16, I=32):
    ks = jax.random.split(jax.random.key(seed), 4)
    return {"router": 0.5 * jax.random.normal(ks[0], (H, E), jnp.float32),
            "gate": 0.2 * jax.random.normal(ks[1], (E, H, I), jnp.float32),
            "up": 0.2 * jax.random.normal(ks[2], (E, H, I), jnp.float32),
            "down": 0.2 * jax.random.normal(ks[3], (E, I, H), jnp.float32)}


def _cases():
    """name -> (the case for the ranks, the JAX call's kwargs)."""
    out = {}
    for name, seed, kw in (("grad", 10, dict(capacity_factor=4.0)),
                           ("drops", 12, dict(capacity_factor=0.5)),
                           ("drops_tight", 14, dict(capacity_factor=0.25)),
                           ("int8", 24, dict(capacity_factor=4.0)),
                           ("fused", 26, dict(capacity_factor=4.0)),
                           ("lora", 33, dict(capacity_factor=4.0))):
        w = _weights(seed)
        x = jax.random.normal(jax.random.key(seed + 1), (32, 16), jnp.float32)
        c = {"x": np.asarray(x), "router": np.asarray(w["router"]), "k": 2,
             "capacity_factor": kw["capacity_factor"]}
        jw = {k: w[k] for k in ("gate", "up", "down")}
        if name == "int8":
            jw = {k: quantize_experts(v) for k, v in jw.items()}
        for k, v in jw.items():
            c[k] = jax.tree.map(np.asarray, v)
        if name == "grad":
            c["grad"] = True
        if name == "fused":
            c["fused"] = True
        if name == "lora":
            c["lora"] = {"expert_gate": {
                "a": np.asarray(jax.random.normal(jax.random.key(35),
                                                  (4, 16, 4)) / 4),
                "b": np.asarray(0.1 * jax.random.normal(jax.random.key(36),
                                                        (4, 4, 32)))}}
            c["lora_scale"] = 2.0
        out[name] = c
    return out


def _jax_case(c, n_dev):
    """The JAX package's expert-sharded call (and its gradients) on an
    expert axis of n_dev virtual devices."""
    wg = c["gate"]
    wu = c["up"]
    if c.get("fused"):
        wg, wu = np.concatenate([c["gate"], c["up"]], -1), None
    kw = dict(num_experts_per_tok=c["k"],
              capacity_factor=c["capacity_factor"])
    if "lora" in c:
        kw.update(lora=c["lora"], lora_scale=c["lora_scale"])

    def f(x, router):
        out, aux = moe_mlp_expert_sharded(x, router, wg, wu, c["down"], **kw)
        return jnp.sum(out ** 2) + aux["load_balance"], (out, aux)

    mesh = make_mesh(data=1, fsdp=1, expert=n_dev,
                     devices=jax.devices()[:n_dev])
    with jax.sharding.set_mesh(mesh):
        if c.get("grad"):
            (loss, (out, aux)), (dx, dr) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(c["x"], c["router"])
        else:
            loss, (out, aux) = jax.jit(f)(c["x"], c["router"])
            dx = dr = None
    return {"out": np.asarray(out), "loss": float(loss),
            "dx": None if dx is None else np.asarray(dx),
            "drouter": None if dr is None else np.asarray(dr),
            **{k: float(v) for k, v in aux.items()}}


def _moe_model():
    cfg = dataclasses.replace(tiny_moe(), dtype="float32")
    params = jqwen3.init_params(cfg, jax.random.key(0))
    ids = jax.random.randint(jax.random.key(1), (4, 16), 0, cfg.vocab_size)
    labels = jax.random.randint(jax.random.key(2), (4, 16), 0,
                                cfg.vocab_size)

    def loss_fn(p):
        logits = jqwen3.forward_logits(p, cfg, input_ids=ids)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(lp[:, :-1], labels[:, 1:, None],
                                             axis=-1))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    ref_logits = jqwen3.forward_logits(params, cfg, input_ids=ids)
    ep_cfg = _tcfg_of(dataclasses.replace(cfg, expert_parallel=True,
                                          ep_capacity_factor=4.0))
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(jax.tree.map(np.asarray, grads), "")
    return (ep_cfg, jax.tree.map(np.asarray, params), np.asarray(ids),
            np.asarray(labels), float(loss), flat,
            np.asarray(ref_logits[:, -1]))


DROP_CAPACITY = 0.5  # the decoder's EP buffers overflow at this factor


def _moe_drop_model(params, ids, labels):
    """The MoE decoder's loss, gradients and layer-mean ``ep_dropped_frac``
    in the JAX package with ``expert_parallel`` at capacity DROP_CAPACITY on
    a (fsdp=2, expert=2) mesh of its virtual devices, the batch sharded over
    fsdp: its shard_map is manual over ``expert`` only, so the capacity and
    the dropped pairs are the global batch's."""
    from molly_tpu.parallel import shard_batch, shard_params
    cfg = dataclasses.replace(tiny_moe(), dtype="float32",
                              expert_parallel=True,
                              ep_capacity_factor=DROP_CAPACITY)

    def loss_fn(p, ids, labels):
        hidden, aux = jqwen3.forward_hidden(p, cfg, input_ids=ids)
        logits = jqwen3.logits_from_hidden(p, cfg, hidden)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.mean(jnp.take_along_axis(lp[:, :-1], labels[:, 1:, None],
                                            axis=-1))
        return nll, aux["moe_aux"]["ep_dropped_frac"]

    mesh = make_mesh(data=1, fsdp=2, expert=2, devices=jax.devices()[:4])
    with jax.sharding.set_mesh(mesh):
        sp = shard_params({"text": params}, mesh)["text"]
        sb = shard_batch({"ids": ids, "labels": labels}, mesh)
        (loss, dropped), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(sp, sb["ids"], sb["labels"])
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(jax.tree.map(np.asarray, grads), "")
    return {"loss": float(loss), "ep_dropped_frac": float(dropped),
            "grads": flat}


@pytest.fixture(scope="module")
def ep():
    cases = _cases()
    model = _moe_model()
    ep_cfg, params, ids, labels = model[:4]
    drop_cfg = dataclasses.replace(ep_cfg, ep_capacity_factor=DROP_CAPACITY)
    got = {}
    for world, mesh_kw in ((2, dict(expert=2)),
                           (4, dict(fsdp=2, expert=2))):
        calls = [("moe_ep_cases", (cases,)),
                 ("moe_model_cases", (ep_cfg, params, ids, labels, mesh_kw))]
        if world == 4:
            calls.append(("moe_model_cases",
                          (drop_cfg, params, ids, labels, mesh_kw)))
        got[world] = run_ranks(ranks.many, world, (calls,))
    refs = {n: {w: _jax_case(c, w) for w in (2, 4)}
            for n, c in cases.items()}
    return {"got": got, "refs": refs, "model": model,
            "drop_ref": _moe_drop_model(params, ids, labels)}


CASES = ["grad", "drops", "drops_tight", "int8", "fused", "lora"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_expert_sharded_values_and_aux_match_jax(ep, name, world):
    ref = ep["refs"][name][world]
    for rank_out in ep["got"][world]:
        got = rank_out[0][name]
        np.testing.assert_allclose(got["out"], ref["out"], rtol=ATOL,
                                   atol=ATOL)
        for k in ("load_balance", "router_z"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6)
        # the same rows overflow the same buffers: equal to the bit
        assert got["ep_dropped_frac"] == ref["ep_dropped_frac"]
    if name.startswith("drops"):
        assert ref["ep_dropped_frac"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_expert_sharded_router_and_input_grads_match_jax(ep, world):
    ref = ep["refs"]["grad"][world]
    for rank_out in ep["got"][world]:
        got = rank_out[0]["grad"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        for k in ("dx", "drouter"):
            np.testing.assert_allclose(got[k], ref[k], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=k)


def test_expert_sharded_without_drops_equals_the_dropless_mlp(ep):
    """capacity 4 covers every row: the EP result is moe_mlp's."""
    c = _cases()["grad"]
    ref, _ = moe_mlp(c["x"], c["router"], c["gate"], c["up"], c["down"],
                     num_experts_per_tok=2)
    for world in (2, 4):
        for rank_out in ep["got"][world]:
            np.testing.assert_allclose(rank_out[0]["grad"]["out"],
                                       np.asarray(ref), rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_moe_decoder_ep_loss_and_grads_match_jax_unsharded(ep, world):
    _, _, _, _, loss, grads, _ = ep["model"]
    for rank_out in ep["got"][world]:
        got = rank_out[1]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert set(got["grads"]) == set(grads)
        for path, ref in grads.items():
            np.testing.assert_allclose(got["grads"][path], ref,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=path)


@pytest.mark.parametrize("world", [2, 4])
def test_moe_decoder_ep_kv_cache_decode_matches_jax(ep, world):
    last = ep["model"][-1]
    for rank_out in ep["got"][world]:
        np.testing.assert_allclose(rank_out[1]["last"], last,
                                   rtol=DECODE_TOL, atol=DECODE_TOL)


def test_moe_decoder_ep_drops_under_fsdp_match_jax(ep):
    """(fsdp=2, expert=2) at a capacity that overflows: each rank holds half
    the batch, but the capacity, the pairs dropped and ep_dropped_frac are
    the global batch's, as in JAX; so are the loss and every gradient."""
    ref = ep["drop_ref"]
    assert ref["ep_dropped_frac"] > 0
    for rank_out in ep["got"][4]:
        got = rank_out[2]
        np.testing.assert_allclose(got["ep_dropped_frac"],
                                   ref["ep_dropped_frac"], rtol=1e-6)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert set(got["grads"]) == set(ref["grads"])
        for path, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][path], g,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=path)


def test_expert_parallel_without_a_mesh_is_moe_mlp_plus_zero_drops():
    """``expert_parallel=True`` with no expert axis runs, as in JAX
    (``moe.py:250-259``): moe_mlp's values and aux plus a zero
    ep_dropped_frac."""
    import torch

    from molly_tpu_torch.ops import moe
    c = _cases()["grad"]
    t = {k: torch.from_numpy(np.array(c[k]))
         for k in ("x", "router", "gate", "up", "down")}
    out, aux = moe.moe_mlp_expert_sharded(
        t["x"], t["router"], t["gate"], t["up"], t["down"],
        num_experts_per_tok=2)
    ref, raux = moe_mlp_expert_sharded(
        c["x"], c["router"], c["gate"], c["up"], c["down"],
        num_experts_per_tok=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ATOL,
                               atol=ATOL)
    assert sorted(aux) == sorted(raux)
    for k in raux:
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=1e-6)
    assert float(aux["ep_dropped_frac"]) == 0.0
