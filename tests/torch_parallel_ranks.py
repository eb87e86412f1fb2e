"""The rank side of the multi-device tests of ``molly_tpu_torch.parallel``:
functions that ``parallel.launch.run_ranks`` runs in spawned gloo ranks on
the CPU. Each rank builds the same inputs from numpy trees the test hands
it, takes its blocks, runs the port under the mesh and returns numpy
results (gathered where a whole tensor is compared). This module imports
torch and ``molly_tpu_torch`` only: the ranks never load JAX."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from molly_tpu_torch.models import qwen3
from molly_tpu_torch.models.convert import params_from_jax
from molly_tpu_torch.models.lora import LoraConfig
from molly_tpu_torch.parallel import (make_mesh, make_pp_mesh,
                                      pp_param_specs, shard_batch,
                                      shard_params, sharding, use_mesh)
from molly_tpu_torch.training import trainer


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _batch(batch_np):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch_np.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _grads(cfg, params, batch, tc, mesh):
    """Loss metrics and the WHOLE gradient of every trainable leaf."""
    state = trainer.init_train_state(params, tc)
    train = trainer._trainable_leaves(state.params, tc)
    grads, metrics = trainer.make_grad_fn(cfg, tc)(state.params, batch)
    specs = [sharding.spec_of(t) for t in train]
    full = sharding.gather_params(
        [sharding.set_spec(g, s) for g, s in zip(grads, specs)], mesh)
    paths = trainer.trainable_paths(state.params, tc)
    return ({k: float(v) for k, v in metrics.items() if v.ndim == 0},
            {p: _np(g) for p, g in zip(paths, full)})


def sharded_loss_and_grads(rank, world, dev, cfg, params_np, batch_np, cases):
    """Per case (name, mesh kwargs, kind): the fusion loss and the gradients
    of every leaf (``kind="full"``, every subtree trainable) or of the
    adapters and projectors (``"qlora"``: LoRA over the int8 base that
    ``params_np`` holds, with an adapter whose b is non-zero)."""
    out = {}
    for name, mesh_kw, kind in cases:
        mesh = make_mesh(**mesh_kw)
        params = params_from_jax(params_np)
        if kind == "qlora":
            r = next(iter(params["lora"]["layers"].values()))["a"].shape[-1]
            tc = trainer.TrainConfig(lora=LoraConfig(r=r, alpha=2.0 * r,
                                                     dropout=0.0))
        else:
            tc = trainer.TrainConfig(train_bio=True)
        with use_mesh(mesh):
            out[name] = _grads(cfg, shard_params(params, mesh),
                               shard_batch(_batch(batch_np), mesh), tc, mesh)
    return out


def sharded_decode(rank, world, dev, cfg, params_np, embeds_np, mask_np,
                   gen, meshes):
    """Greedy tokens of ``engine._generate_from_embeds`` over
    ``shard_params(..., bare_text=True)`` blocks, one run per mesh."""
    from molly_tpu_torch.inference import engine
    out = {}
    for name, mesh_kw in meshes:
        mesh = make_mesh(**mesh_kw)
        with use_mesh(mesh):
            sp = shard_params(params_from_jax(params_np), mesh,
                              bare_text=True)
            toks = engine._generate_from_embeds(
                sp, cfg, torch.from_numpy(embeds_np),
                torch.from_numpy(mask_np), gen,
                torch.Generator().manual_seed(1))
        out[name] = toks.numpy()
    return out


def moe_ep_cases(rank, world, dev, cases):
    """``moe_mlp_expert_sharded`` on an expert axis of ``world`` ranks, each
    case a dict: x, router, gate / up / down (whole [E, ..] stacks, numpy,
    or int8 ``{w_q, scale}`` dicts of them), optionally ``lora`` (whole expert
    adapters), ``fused`` (one gate-and-up stack), ``capacity_factor``, and
    ``grad`` (also the gradients of x and the router through
    sum(out^2) + load_balance). The rank passes its block of experts."""
    from molly_tpu_torch.ops import moe
    mesh = make_mesh(expert=world)
    out = {}
    with use_mesh(mesh):
        for name, c in cases.items():
            E = c["router"].shape[1]
            lo, hi = rank * E // world, (rank + 1) * E // world
            x = torch.from_numpy(c["x"]).requires_grad_(c.get("grad", False))
            router = torch.from_numpy(c["router"]).requires_grad_(
                c.get("grad", False))
            stacks = {k: ({n: torch.from_numpy(a) for n, a in c[k].items()}
                          if isinstance(c[k], dict) else torch.from_numpy(c[k]))
                      for k in ("gate", "up", "down")}
            if c.get("fused"):
                wg = (torch.cat([stacks["gate"], stacks["up"]], -1)
                      if not isinstance(stacks["gate"], dict) else
                      {k: torch.cat([stacks["gate"][k], stacks["up"][k]], -1)
                       for k in ("w_q", "scale")})
                stacks = {"gate": wg, "up": None, "down": stacks["down"]}

            def local(w):
                if w is None:
                    return None
                if isinstance(w, dict):
                    return {k: v[lo:hi] for k, v in w.items()}
                return w[lo:hi]

            lora = None
            if "lora" in c:
                lora = {n: {k: torch.from_numpy(v[lo:hi])
                            for k, v in ab.items()}
                        for n, ab in c["lora"].items()}
            y, aux = moe.moe_mlp_expert_sharded(
                x, router, local(stacks["gate"]), local(stacks["up"]),
                local(stacks["down"]), num_experts_per_tok=c["k"],
                capacity_factor=c.get("capacity_factor", 2.0), lora=lora,
                lora_scale=c.get("lora_scale", 1.0))
            res = {"out": _np(y), **{k: float(v) for k, v in aux.items()}}
            if c.get("grad"):
                loss = (y.float() ** 2).sum() + aux["load_balance"]
                gx, gr = torch.autograd.grad(loss, (x, router))
                res.update(loss=float(loss), dx=_np(gx), drouter=_np(gr))
            out[name] = res
    return out


def moe_model_cases(rank, world, dev, cfg, params_np, ids_np, labels_np,
                    mesh_kw):
    """The MoE decoder under ``mesh_kw`` with ``cfg.expert_parallel``: the
    loss of the JAX test's forward (mean next-token nll; each rank its rows
    of the batch and its share of the mean) and the whole gradients of
    every leaf, and the layers' mean ``ep_dropped_frac``; then KV-cache
    decode of the whole batch (prefill S-1 tokens, one step) and its last
    logits."""
    from molly_tpu_torch.parallel import comm
    mesh = make_mesh(**mesh_kw)
    ids = torch.from_numpy(ids_np).long()
    labels = torch.from_numpy(labels_np).long()
    with use_mesh(mesh):
        sp = shard_params({"text": params_from_jax(params_np)}, mesh)["text"]
        train = list(_flat(sp).items())
        for _, t in train:
            t.requires_grad_(t.is_floating_point())
        rows = shard_batch({"ids": ids, "labels": labels}, mesh)
        hidden, aux = qwen3.forward_hidden(sp, cfg, input_ids=rows["ids"])
        logits = qwen3.logits_from_hidden(sp, cfg, hidden)
        dropped = float(aux["moe_aux"]["ep_dropped_frac"])
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll = -lp[:, :-1].gather(-1, rows["labels"][:, 1:, None])
        loss = nll.sum() / (labels.shape[0] * (labels.shape[1] - 1))
        wrt = [(p, t) for p, t in train if t.requires_grad]
        grads = torch.autograd.grad(loss, [t for _, t in wrt])
        grads = sharding.sync_grads(
            grads, [sharding.spec_of(t) for _, t in wrt], mesh)
        full = sharding.gather_params(
            [sharding.set_spec(g, sharding.spec_of(t))
             for g, (_, t) in zip(grads, wrt)], mesh)
        loss = comm.all_reduce(loss.detach(),
                               mesh.group(*sharding.BATCH_AXES))
        B, S = ids.shape
        with torch.no_grad():
            cache = qwen3.init_cache(cfg, B, S)
            _, cache = qwen3.forward_hidden(sp, cfg, input_ids=ids[:, :-1],
                                            cache=cache, cache_index=0)
            hidden, _ = qwen3.forward_hidden(sp, cfg, input_ids=ids[:, -1:],
                                             cache=cache, cache_index=S - 1)
            last = qwen3.logits_from_hidden(sp, cfg, hidden)
    return {"loss": float(loss), "last": _np(last[:, 0]),
            "ep_dropped_frac": dropped,
            "grads": {p: _np(g) for (p, _), g in zip(wrt, full)}}


def ring_cases(rank, world, dev, cases):
    """``ring_attention_sharded`` on a ``seq`` axis of ``world`` ranks: per
    case the output and the gradients of q, k, v through
    sum(sin(out) * row_mask) (rows of the query mask only)."""
    from molly_tpu_torch.parallel import ring_attention_sharded
    mesh = make_mesh(seq=world)
    out = {}
    with use_mesh(mesh):
        for name, c in cases.items():
            q, k, v = (torch.from_numpy(c[n]).requires_grad_(True)
                       for n in ("q", "k", "v"))
            mask = torch.from_numpy(c["mask"])
            o = ring_attention_sharded(q, k, v, mask, causal=c["causal"],
                                       zigzag=c["zigzag"])
            sel = mask.to(torch.float32)[..., None, None]
            loss = (torch.sin(o) * sel).sum()
            gq, gk, gv = torch.autograd.grad(loss, (q, k, v))
            out[name] = {"out": _np(o), "dq": _np(gq), "dk": _np(gk),
                         "dv": _np(gv)}
    return out


def pipeline_cases(rank, world, dev, cfg, params_np, batch_np, micros):
    """``pp_loss_fn`` on a (pipe=world, data=1) mesh at each microbatch
    count: the loss and the whole gradients of every leaf (all trainable),
    and the first step's metrics through ``make_train_step``."""
    from molly_tpu_torch.parallel import pp_loss_fn
    mesh = make_pp_mesh(pipe=world)
    out = {}
    for n_micro in micros:
        params = params_from_jax(params_np)
        sp = sharding.shard_tree(params, pp_param_specs(params), mesh)
        leaves = _flat(sp)
        for t in leaves.values():
            t.requires_grad_(True)
        with use_mesh(mesh):
            loss, _ = pp_loss_fn(sp, cfg, _batch(batch_np), n_micro=n_micro)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            full = sharding.gather_params(
                [sharding.set_spec(g, sharding.spec_of(t))
                 for g, t in zip(grads, leaves.values())], mesh)
        out[n_micro] = {"loss": float(loss),
                        "grads": {p: _np(g) for p, g in zip(leaves, full)}}
    params = params_from_jax(params_np)
    sp = sharding.shard_tree(params, pp_param_specs(params), mesh)
    tc = trainer.TrainConfig(learning_rate=1e-3, total_steps=4,
                             train_bio=True, pp_micro=2)
    with use_mesh(mesh):
        state = trainer.init_train_state(sp, tc)
        _, m = trainer.make_train_step(cfg, tc)(state, _batch(batch_np))
    out["step"] = {"loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"])}
    return out


def cli_step(rank, world, dev, argv):
    """``training.cli.run_training`` on these ranks; its per-step history."""
    from molly_tpu_torch.training import cli
    res = cli.run_training(cli.build_argparser().parse_args(argv))
    return res["history"]


def with_cfg(cfg, **text):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                             **text))


def many(rank, world, dev, calls):
    """Several of the functions above in one spawn: ``calls`` is a list of
    (function name, args); returns their results in order."""
    return [globals()[name](rank, world, dev, *args) for name, args in calls]
