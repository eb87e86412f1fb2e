"""Pipeline parallelism (GPipe) for the stacked-layer decoder, the
counterpart of ``molly_tpu/parallel/pipeline.py``.

  - the leading [L, ...] axis of every decoder layer leaf is split over a
    ``pipe`` axis (``pp_param_specs``): stage d holds layers
    d*L/P .. (d+1)*L/P - 1, run through ``qwen3._layer``;
  - the batch is split into M microbatches and a clock loop of M + P - 1
    ticks flows activations stage to stage (``comm.exchange`` a tick);
    the last stage's outputs go to every stage;
  - the backward is explicit (``_Pipeline``): it walks the ticks in
    reverse, each stage recomputing its layers for one microbatch from
    the input it stashed and handing the input's gradient to the stage
    before it, so no send or receive is left to the autograd engine. The
    embeddings' gradient comes back from stage 0 to every stage.

Embedding, encoders, final norm and LM head run outside the loop, the same
on every stage (replicated over ``pipe``, the batch split over ``data``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import comm
from .comm import Mesh

PIPE_AXIS = "pipe"
DATA_AXIS = "data"


def make_pp_mesh(pipe: int, data: int = 1, devices=None) -> Mesh:
    """2-axis (pipe, data) mesh for pipeline-parallel runs."""
    if devices is None:
        running = dist.is_available() and dist.is_initialized()
        devices = list(range(dist.get_world_size() if running else 1))
    assert pipe * data == len(devices), (pipe, data, len(devices))
    return Mesh(np.asarray(devices).reshape(pipe, data),
                (PIPE_AXIS, DATA_AXIS))


def pp_param_specs(params: Any) -> Any:
    """Decoder layer-stacked leaves split over pipe on axis 0; everything
    else (embeddings, norms, encoders, projectors) replicated. Works for
    fusion trees (text/layers/...) and bare qwen3 trees (layers/...)."""
    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + [k]) for k, v in tree.items()}
        if "layers" in names:
            i = names.index("layers")
            if i == 0 or (i == 1 and names[0] == "text"):
                return (PIPE_AXIS,)
        return ()
    return walk(params, [])


def _flat(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _flat(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, run, group, n_stage, d, *layer_leaves):
        M = xs.shape[0]
        stash = [None] * M

        def stage(x, m):
            with torch.no_grad():
                return run(x, m, layer_leaves)

        outs = torch.zeros_like(xs)
        recv = None
        for t in range(M + n_stage - 1):
            m = t - d
            y = None
            if 0 <= m < M:
                x_in = xs[m] if d == 0 else recv
                stash[m] = x_in
                y = stage(x_in, m)
                if d == n_stage - 1:
                    outs[m] = y
            sends = [(y, d + 1)] if (y is not None and d < n_stage - 1) \
                else []
            wants = d > 0 and 0 <= t + 1 - d < M
            got = comm.exchange(sends, [(xs[0], d - 1)] if wants else [],
                                group)
            recv = got[0] if got else None
        ctx.run, ctx.group, ctx.n_stage, ctx.d = run, group, n_stage, d
        ctx.stash = stash
        ctx.save_for_backward(*layer_leaves)
        # the last stage's outputs, on every stage
        return comm.broadcast(outs, n_stage - 1, group)

    @staticmethod
    def backward(ctx, g_outs):
        layer_leaves = ctx.saved_tensors
        run, group, n_stage, d = ctx.run, ctx.group, ctx.n_stage, ctx.d
        M = g_outs.shape[0]
        need = [t.requires_grad for t in layer_leaves]
        grads = [torch.zeros_like(t) if n else None
                 for t, n in zip(layer_leaves, need)]
        dxs = torch.zeros_like(g_outs)
        g_recv = None
        for t in reversed(range(M + n_stage - 1)):
            m = t - d
            dx = None
            if 0 <= m < M:
                g_y = g_outs[m] if d == n_stage - 1 else g_recv
                with torch.enable_grad():
                    x = ctx.stash[m].detach().requires_grad_(True)
                    leaves = [p.detach().requires_grad_(n)
                              for p, n in zip(layer_leaves, need)]
                    y = run(x, m, leaves)
                    wrt = [x] + [p for p in leaves if p.requires_grad]
                    got = torch.autograd.grad(y, wrt, g_y,
                                              allow_unused=True)
                dx = got[0]
                it = iter(got[1:])
                for i, n in enumerate(need):
                    if n:
                        g = next(it)
                        if g is not None:
                            grads[i] += g
                if d == 0:
                    dxs[m] = dx
            sends = [(dx, d - 1)] if (dx is not None and d > 0) else []
            wants = d < n_stage - 1 and 0 <= t - 1 - d < M
            got = comm.exchange(sends, [(g_outs[0], d + 1)] if wants else [],
                                group)
            g_recv = got[0] if got else None
        ctx.stash = None
        # the embeddings' gradient lives on stage 0: every stage takes it,
        # so the replicated leaves before the loop get the same gradient
        dxs = comm.broadcast(dxs, 0, group)
        return (dxs, None, None, None, None, *grads)


def decoder_forward_pp(
    params: Dict[str, Any],
    cfg,
    *,
    inputs_embeds: torch.Tensor,              # [B, S, H]
    attention_mask: Optional[torch.Tensor],   # [B, S]
    n_micro: int,
    axis_name: str = PIPE_AXIS,
) -> torch.Tensor:
    """Pipelined decoder stack -> final hidden states [B, S, H].
    ``params["layers"]`` holds this stage's L/P layers (a block cut by
    ``pp_param_specs``)."""
    from ..models import qwen3
    from ..ops.norms import rms_norm
    B, S, H = inputs_embeds.shape
    assert B % n_micro == 0, (B, n_micro)
    assert not cfg.context_parallel, (
        "context_parallel (ring attention) cannot run inside the pipeline "
        "clock loop; use one or the other")
    mb = B // n_micro
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.int32,
                                    device=inputs_embeds.device)
    positions = torch.clamp(
        torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1, min=0)
    cos, sin = qwen3.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                                  dtype=inputs_embeds.dtype)
    xs = inputs_embeds.reshape(n_micro, mb, S, H)
    coss = cos.reshape(n_micro, mb, *cos.shape[1:])
    sins = sin.reshape(n_micro, mb, *sin.shape[1:])
    masks = attention_mask.reshape(n_micro, mb, S)
    mesh = comm.current_mesh()
    group = mesh.group(axis_name) if mesh is not None else None
    n_stage = mesh.size(axis_name) if mesh is not None else 1
    d = mesh.index(axis_name) if group is not None else 0
    lp = params["layers"]
    leaves = _flat(lp, [])
    L_loc = leaves[0].shape[0]

    def run(x, m, layer_leaves):
        layers = qwen3._unstack_layers(_rebuild(lp, iter(layer_leaves)),
                                       L_loc)
        for p in layers:
            x, _ = qwen3._layer(cfg, x, p, coss[m], sins[m], masks[m], True,
                                None, 0)
        return x

    if group is None:
        hidden = torch.stack([run(xs[m], m, leaves)
                              for m in range(n_micro)])
    else:
        hidden = _Pipeline.apply(xs, run, group, n_stage, d, *leaves)
    return rms_norm(hidden.reshape(B, S, H), params["final_norm"],
                    cfg.rms_norm_eps)


def pp_loss_fn(
    params: Dict[str, Any],
    cfg,  # FusionConfig
    batch: Dict[str, torch.Tensor],
    *,
    n_micro: int,
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fusion-model LM loss with the decoder pipelined over ``pipe``: a
    drop-in for ``fusion.loss_fn``; encoders, injection and LM head run
    the same on every stage."""
    from ..models import fusion
    embeds = fusion.build_inputs_embeds(params, cfg, batch)
    hidden = decoder_forward_pp(
        params["text"], cfg.text, inputs_embeds=embeds,
        attention_mask=batch.get("attention_mask"), n_micro=n_micro)
    return fusion.loss_from_hidden(params, cfg, hidden, batch, z_loss=z_loss)
