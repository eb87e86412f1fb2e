"""The mesh and its sharding rules, the counterpart of
``molly_tpu/parallel/sharding.py`` on ``torch.distributed``.

The rules are the JAX package's, copied: a spec is a tuple with one entry
per leading dim of a leaf (an axis name, None, or a tuple of axis names for
a dim split over several axes), matched on the leaf's "/"-joined tree path,
first match wins. What GSPMD does with a spec, the port does by hand:

  - each rank STORES only its block of every leaf (``shard_params``: the
    block its mesh coordinates name; the block keeps its spec in
    ``spec_of``), and the optimizer moments are made like their leaf, so
    the memory is ZeRO-3's over ``fsdp``;
  - ``full`` gathers a block where it is used (a decoder layer's weights
    just before the layer, inside the loop over stacked layers; the
    embedding, the head and the frozen encoders in full before use), and
    its backward hands each rank the gradient of its block: summed over
    the batch axes (``data``, ``fsdp``, ``seq``), taken as it is over the
    others, whose ranks compute the same thing;
  - ``tensor`` is Megatron-style inside ``models.qwen3``; ``expert`` keeps
    each rank's experts local (``ops.moe.moe_mlp_expert_sharded``);
  - after the backward ``sync_grads`` sums each block's gradient over the
    batch axes its spec does not shard (the data-parallel reduction), and
    ``global_norm`` counts every distinct block once.

Ranks map to mesh coordinates the way ``np.asarray(devices).reshape(...)``
maps JAX's device ids; ``dcn_data`` folds into ``data`` slice-major, which
is the JAX package's off-TPU order.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import comm
from .comm import Mesh

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"  # context parallelism (ring attention)
EXPERT_AXIS = "expert"  # MoE expert parallelism
# axes whose ranks see different tokens: gradients sum over them
BATCH_AXES = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS)

Spec = Tuple[Any, ...]


def make_mesh(data: int = 1, fsdp: int = -1, tensor: int = 1,
              seq: int = 1, expert: int = 1, devices=None,
              dcn_data: int = 1) -> Mesh:
    """Build a 5-axis mesh. fsdp=-1 means "all remaining ranks".
    ``devices``: the global ranks to lay out (default every rank of the
    running process group, or just rank 0 without one). dcn_data > 1 folds
    into the data axis, slice-major (size ``dcn_data * data``)."""
    if devices is None:
        running = dist.is_available() and dist.is_initialized()
        devices = list(range(dist.get_world_size() if running else 1))
    n = len(devices)
    if fsdp == -1:
        assert n % (dcn_data * data * tensor * seq * expert) == 0, (
            n, dcn_data, data, tensor, seq, expert)
        fsdp = n // (dcn_data * data * tensor * seq * expert)
    assert dcn_data * data * fsdp * tensor * seq * expert == n, (
        dcn_data, data, fsdp, tensor, seq, expert, n)
    axes = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, SEQ_AXIS, EXPERT_AXIS)
    arr = np.asarray(devices).reshape(dcn_data * data, fsdp, tensor, seq,
                                      expert)
    return Mesh(arr, axes)


# ---------------------------------------------------------------------------
# parameter sharding rules (matched on "/"-joined tree paths)
# ---------------------------------------------------------------------------

_PARAM_RULES: Tuple[Tuple[str, Spec], ...] = (
    # --- Qwen3 decoder ---
    (r"text/embed$", (TENSOR_AXIS, FSDP_AXIS)),
    (r"text/lm_head$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"text/layers/(q_proj|k_proj|v_proj)$", (None, FSDP_AXIS, TENSOR_AXIS)),
    (r"text/layers/o_proj$", (None, TENSOR_AXIS, FSDP_AXIS)),
    (r"text/layers/(gate_proj|up_proj)$", (None, FSDP_AXIS, TENSOR_AXIS)),
    (r"text/layers/down_proj$", (None, TENSOR_AXIS, FSDP_AXIS)),
    # QLoRA int8 base: {w_q, scale} keep the base-weight layout; scale is
    # per output column [L, N]
    (r"text/layers/(q_proj|k_proj|v_proj|gate_proj|up_proj)/w_q$",
     (None, FSDP_AXIS, TENSOR_AXIS)),
    (r"text/layers/(q_proj|k_proj|v_proj|gate_proj|up_proj)/scale$",
     (None, TENSOR_AXIS)),
    (r"text/layers/(o_proj|down_proj)/w_q$",
     (None, TENSOR_AXIS, FSDP_AXIS)),
    (r"text/layers/(o_proj|down_proj)/scale$", (None, FSDP_AXIS)),
    (r"text/layers/expert_(gate|up)/w_q$",
     (None, EXPERT_AXIS, FSDP_AXIS, TENSOR_AXIS)),
    (r"text/layers/expert_(gate|up)/scale$",
     (None, EXPERT_AXIS, TENSOR_AXIS)),
    (r"text/layers/expert_down/w_q$",
     (None, EXPERT_AXIS, TENSOR_AXIS, FSDP_AXIS)),
    (r"text/layers/expert_down/scale$", (None, EXPERT_AXIS, FSDP_AXIS)),
    # MoE: experts [L, E, H, I] over the expert axis; the per-expert
    # matrix dims also over fsdp / tensor
    (r"text/layers/router$", ()),
    (r"text/layers/expert_(gate|up|gateup)$",
     (None, EXPERT_AXIS, FSDP_AXIS, TENSOR_AXIS)),
    (r"text/layers/expert_down$",
     (None, EXPERT_AXIS, TENSOR_AXIS, FSDP_AXIS)),
    (r"text/layers/(input_norm|post_attn_norm|q_norm|k_norm)$", ()),
    (r"text/final_norm$", ()),
    # --- ESM encoders (frozen, but still sharded to save memory) ---
    (r"(dna_rna|protein)/embed$", ()),
    (r"(dna_rna|protein)/pos_embed$", (None, FSDP_AXIS)),
    (r"(dna_rna|protein)/layers/(q|k|v)$", (None, FSDP_AXIS, TENSOR_AXIS)),
    (r"(dna_rna|protein)/layers/attn_out$", (None, TENSOR_AXIS, FSDP_AXIS)),
    (r"(dna_rna|protein)/layers/ffn_in$", (None, FSDP_AXIS, TENSOR_AXIS)),
    (r"(dna_rna|protein)/layers/ffn_out$", (None, TENSOR_AXIS, FSDP_AXIS)),
    (r"(dna_rna|protein)/", ()),  # biases, layernorms
    # --- projectors (tiny) ---
    (r"(dna_rna|protein)_projector/", ()),
    # --- LoRA adapters: A input-sharded, B output-sharded; expert-stacked
    #     adapters ride the expert axis like their base weights ---
    (r"lora/.*expert_[a-z]+/(a)$", (None, EXPERT_AXIS, FSDP_AXIS, None)),
    (r"lora/.*expert_[a-z]+/(b)$", (None, EXPERT_AXIS, None, TENSOR_AXIS)),
    (r"lora/.*/(a)$", (None, FSDP_AXIS, None)),
    (r"lora/.*/(b)$", (None, None, TENSOR_AXIS)),
)

# a standalone text model (no "text/" prefix) reuses the same rules
_BARE_RULES = tuple(
    (pat.replace("text/", ""), spec) for pat, spec in _PARAM_RULES
    if pat.startswith(r"text/"))


def spec_for_path(path_str: str, rules=_PARAM_RULES) -> Spec:
    for pat, spec in rules:
        if re.search(pat, path_str):
            return spec
    return ()


def _map_with_path(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def param_specs(params: Any, *, bare_text: bool = False) -> Any:
    """The spec tree of a fusion (or bare qwen3) param tree."""
    rules = _BARE_RULES if bare_text else _PARAM_RULES
    return _map_with_path(lambda path, _: spec_for_path(path, rules), params)


# [B, S] batch arrays whose dim 1 is the text sequence: these shard over
# seq under context parallelism
_SEQ_DIM_KEYS = ("input_ids", "attention_mask", "labels")


def batch_specs(batch: Dict[str, Any],
                seq_shard: bool = False) -> Dict[str, Spec]:
    """Every batch array over the combined data axes (and the text sequence
    dim over ``seq`` under context parallelism)."""
    def spec(name, _leaf):
        if seq_shard and any(name.endswith(k) for k in _SEQ_DIM_KEYS):
            return ((DATA_AXIS, FSDP_AXIS), SEQ_AXIS)
        return ((DATA_AXIS, FSDP_AXIS),)
    return _map_with_path(spec, batch)


# ---------------------------------------------------------------------------
# blocks and gathers
# ---------------------------------------------------------------------------

_SPEC_ATTR = "_molly_spec"


def spec_of(t: torch.Tensor) -> Optional[Spec]:
    """The spec a block was cut with (``shard_params``), None for a tensor
    that is not a block."""
    return getattr(t, _SPEC_ATTR, None)


def set_spec(t: torch.Tensor, spec: Optional[Spec]) -> torch.Tensor:
    if spec is not None:
        setattr(t, _SPEC_ATTR, tuple(spec))
    return t


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def block(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        n = mesh.size(*axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"over {axes} ({n} ranks)")
        s = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(*axes) * s, s)
    return x


def shard_params(params: Any, mesh: Mesh, *, bare_text: bool = False
                 ) -> Any:
    """Each leaf cut to this rank's block (a copy of its own, so the full
    tensor can be freed), tagged with its spec. With every axis 1 the
    leaves are returned as they are."""
    return shard_tree(params, param_specs(params, bare_text=bare_text),
                      mesh)


def shard_tree(params: Any, specs: Any, mesh: Mesh) -> Any:
    """``shard_params`` under a spec tree of the caller's (the pipeline's
    ``pp_param_specs``)."""
    def cut(x, spec):
        if all(mesh.size(*_axes(e)) == 1 for e in spec):
            return set_spec(x, spec)
        return set_spec(block(x, spec, mesh).contiguous().clone(), spec)

    return _zip_map(cut, params, specs)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def full(x: torch.Tensor, keep: Tuple[str, ...] = (),
         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The block ``x`` gathered over every axis of its spec but ``keep``
    (under the current mesh); a tensor without a spec is returned as it is.
    Backward: the gradient of this rank's block, summed over the batch axes
    (whose ranks saw other tokens) and taken as it is over the rest."""
    spec = spec_of(x)
    mesh = mesh or comm.current_mesh()
    if spec is None or mesh is None:
        return x
    for dim, entry in enumerate(spec):
        for ax in reversed(_axes(entry)):
            if ax in keep or mesh.size(ax) == 1:
                continue
            x = comm.gather(x, dim, mesh.group(ax),
                            "sum" if ax in BATCH_AXES else "slice")
    return x


def full_tree(tree: Any, keep: Tuple[str, ...] = ()) -> Any:
    """``full`` of every leaf of a tree."""
    if isinstance(tree, dict):
        return {k: full_tree(v, keep) for k, v in tree.items()}
    return full(tree, keep)


def unbind_stacked(w: torch.Tensor):
    """``w.unbind(0)`` of a stacked [L, ...] block, each layer's view
    tagged with the spec of the remaining dims."""
    spec = spec_of(w)
    views = w.unbind(0)
    if spec is not None:
        for v in views:
            set_spec(v, spec[1:])
    return views


def gather_params(params: Any, mesh: Optional[Mesh] = None) -> Any:
    """Every leaf in full, without autograd (checkpoints, exports); blocks
    come back as full tensors, other leaves as they are."""
    mesh = mesh or comm.current_mesh()

    def one(x):
        spec = spec_of(x)
        if spec is None or mesh is None:
            return x
        x = x.detach()
        for dim, entry in enumerate(spec):
            for ax in reversed(_axes(entry)):
                if mesh.size(ax) > 1:
                    x = comm.all_gather(x, dim, mesh.group(ax))
        return x

    if isinstance(params, dict):
        return {k: gather_params(v, mesh) for k, v in params.items()}
    if isinstance(params, list):
        return [gather_params(v, mesh) for v in params]
    return one(params) if isinstance(params, torch.Tensor) else params


def sync_axes(spec: Optional[Spec], mesh: Mesh) -> Tuple[str, ...]:
    """The batch axes a block's gradient still sums over after its
    gathers' backward: those its spec does not shard."""
    sharded = {a for e in (spec or ()) for a in _axes(e)}
    return tuple(a for a in BATCH_AXES
                 if a in mesh.shape and a not in sharded
                 and mesh.size(a) > 1)


def sync_grads(grads, specs, mesh: Optional[Mesh] = None):
    """Sum every gradient over the batch axes its block is replicated on,
    one bucket (a flat all-reduce) per set of axes and dtype."""
    mesh = mesh or comm.current_mesh()
    if mesh is None:
        return grads
    buckets: Dict[Tuple, list] = {}
    for i, (g, spec) in enumerate(zip(grads, specs)):
        axes = sync_axes(spec, mesh)
        if axes:
            buckets.setdefault((axes, g.dtype), []).append(i)
    out = list(grads)
    for (axes, _), idx in buckets.items():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        flat = comm.all_reduce(flat, mesh.group(*axes))
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def replicas(spec: Optional[Spec], mesh: Mesh) -> int:
    """How many ranks hold the same block."""
    sharded = math.prod(mesh.size(*_axes(e)) for e in (spec or ()))
    return mesh.devices.size // sharded


def global_norm(grads, specs, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """sqrt of the summed squares of the full gradients: each block's
    squares (fp32, in chunks) divided by its replica count, summed over
    every rank, so every distinct block counts once."""
    mesh = mesh or comm.current_mesh()
    if not grads:
        return torch.zeros(())
    chunk = 1 << 25

    def squares(g):
        return sum(c.to(torch.float32).square().sum()
                   for c in g.reshape(-1).split(chunk))

    if mesh is None or mesh.devices.size == 1:
        return torch.sqrt(sum(squares(g) for g in grads))
    total = sum(squares(g) / replicas(s, mesh) for g, s in zip(grads, specs))
    return torch.sqrt(comm.all_reduce(total.reshape(1),
                                      dist.group.WORLD)[0])


def shard_batch(batch: Any, mesh: Mesh, seq_shard: bool = False) -> Any:
    """This rank's rows of a GLOBAL batch (the block of its (data, fsdp)
    coordinate), and under ``seq_shard`` its part of the text sequence."""
    seq_shard = seq_shard and mesh.shape.get(SEQ_AXIS, 1) > 1
    return _zip_map(lambda x, spec: block(x, spec, mesh), batch,
                    batch_specs(batch, seq_shard=seq_shard))


def make_global_batch(batch: Any, mesh: Mesh,
                      seq_shard: bool = False) -> Any:
    """The batch a rank feeds: its OWN rows (read from its shard of the
    dataset, ``host_shard_range`` over the (data, fsdp) coordinate), which
    together with the other ranks' rows form the global batch sharded over
    (data, fsdp): the port's counterpart of
    ``jax.make_array_from_process_local_data``. Under ``seq_shard`` the
    text sequence is cut to this rank's part."""
    if not (seq_shard and mesh.shape.get(SEQ_AXIS, 1) > 1):
        return batch
    n, i = mesh.size(SEQ_AXIS), mesh.index(SEQ_AXIS)

    def cut(name, x):
        if any(name.endswith(k) for k in _SEQ_DIM_KEYS):
            s = x.shape[1] // n
            return x[:, i * s:(i + 1) * s]
        return x
    return _map_with_path(cut, batch)


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def initialize_distributed(**kw) -> None:
    """Join the process group that ``torchrun`` (or a caller's environment)
    describes: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``,
    and ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` for the device. A no-op for one
    process, or when a group is already running. ``kw`` overrides
    ``backend``, ``device``, ``rank`` and ``world_size``."""
    if dist.is_initialized():
        return
    world = int(kw.get("world_size", os.environ.get("WORLD_SIZE", 1)))
    if world <= 1:
        return
    rank = int(kw.get("rank", os.environ.get("RANK", 0)))
    device = torch.device(kw.get("device") or local_device())
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = kw.get("backend") or comm.choose_backend(device, local_world)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    if rank == 0:
        print(f"distributed: {world} ranks, backend "
              f"{comm.describe_backend(device)}", flush=True)


def local_device(requested: Optional[str] = None) -> torch.device:
    """The card of this rank: ``cuda:LOCAL_RANK`` when every local rank has
    one (``comm.own_cards``, the rule that picks NCCL), else ``cuda:0``
    (ranks share it, over gloo); ``requested`` (``--device``) wins."""
    if requested:
        return torch.device(requested)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", 1)))
    if comm.own_cards(local_world):
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cuda", 0)


def host_shard_range(n: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) slice of a dataset owned by this process (default: the
    rank of the running process group)."""
    running = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if running else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if running else 1)
    per = n // pc
    start = pi * per
    stop = n if pi == pc - 1 else start + per
    return start, stop
