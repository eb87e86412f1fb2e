"""The port's mesh and every collective it runs, on ``torch.distributed``.

Where the JAX package writes sharding annotations and lets XLA insert the
collectives, the port runs one process per rank and calls them itself; all
of them live here:

  - ``Mesh``: the ranks laid out on named axes (``sharding.make_mesh``,
    ``pipeline.make_pp_mesh``), one process group per axis and per set of
    axes that a collective spans (built once, on every rank, in one order).
  - ``use_mesh``: the mesh the model code runs under (the counterpart of
    ``jax.sharding.set_mesh``); ``current_mesh()`` reads it.
  - plain collectives (``all_gather``, ``all_reduce``, ``reduce_scatter``,
    ``broadcast``, ``exchange``) and their autograd pairs: ``gather``
    (all-gather forward; reduce-scatter or own-slice backward),
    ``reduce_from`` (all-reduce forward, identity backward: the output of a
    row-parallel product), ``reduce_grad`` (identity forward, all-reduce
    backward: a replicated input of a partitioned computation) and
    ``all_reduce_sum`` (both ways: a sum every rank's loss reads).

Backends: NCCL when every rank has a card of its own, gloo on the CPU and
when ranks share one card (NCCL refuses two ranks on one device). Every
collective hands gloo a CUDA tensor as it is (gloo's all-reduce, broadcast,
all-gather and reduce-scatter take them); its point-to-point calls refuse
them, so ``exchange`` stages a CUDA tensor through pinned host memory under
gloo (``p2p_staged``). ``STATS`` counts the calls and the payload bytes a
rank hands to collectives.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# calls and payload bytes per collective kind on this rank (the input of
# an all-reduce, reduce-scatter, broadcast or send; the output of an
# all-gather); ``reset_stats`` zeroes them
STATS: Dict[str, float] = {}


def reset_stats() -> None:
    STATS.clear()


def _count(kind: str, nbytes: int) -> None:
    STATS[kind + "_calls"] = STATS.get(kind + "_calls", 0) + 1
    STATS[kind + "_bytes"] = STATS.get(kind + "_bytes", 0) + nbytes
    STATS["bytes"] = STATS.get("bytes", 0) + nbytes


def bytes_moved() -> float:
    return STATS.get("bytes", 0)


class Mesh:
    """Ranks laid out on named axes: ``devices`` is an int array of global
    ranks with one dimension per axis (the layout ``np.reshape`` gives JAX's
    device list). When a process group of exactly these ranks is running,
    one group is built for every set of the axes longer than 1 (every rank
    calls ``new_group`` for every group, in one order, as torch requires);
    without one (a single process, or a layout inspected for its map) the
    mesh only answers shape and coordinate questions."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        assert self.devices.ndim == len(self.axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        running = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if running else 1
        self.rank = dist.get_rank() if running else 0
        self._groups: Dict[Tuple[str, ...], object] = {}
        where = np.argwhere(self.devices == self.rank)
        self.coords = (dict(zip(self.axis_names, where[0].tolist()))
                       if len(where) else None)
        if running and self.world > 1:
            assert self.devices.size == self.world and sorted(
                self.devices.ravel().tolist()) == list(range(self.world)), (
                "the mesh must hold every rank of the process group once")
            self._build_groups()

    def _build_groups(self) -> None:
        long_axes = [a for a in self.axis_names if self.shape[a] > 1]
        for n in range(1, len(long_axes) + 1):
            for axes in itertools.combinations(long_axes, n):
                if n == len(long_axes) and self.devices.size == self.world:
                    self._groups[axes] = dist.group.WORLD
                    continue
                keep = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(len(self.axis_names))
                        if i not in keep]
                arr = np.transpose(self.devices, rest + keep).reshape(
                    -1, math.prod(self.shape[a] for a in axes))
                for ranks in arr.tolist():
                    g = dist.new_group(sorted(ranks))
                    if self.rank in ranks:
                        self._groups[axes] = g

    def _norm(self, axes: Iterable[str]) -> Tuple[str, ...]:
        axes = set(axes)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def size(self, *axes: str) -> int:
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's linear coordinate over ``axes`` (major first, in
        mesh order): its index within ``group(*axes)``."""
        idx = 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only on
        ``axes``; None when that set is a single rank."""
        key = self._norm(axes)
        if not key:
            return None
        if key not in self._groups:
            raise RuntimeError(f"no process group for axes {key}: the mesh "
                               "was built without a running process group")
        return self._groups[key]


_MESH: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    """The mesh set by ``use_mesh``, or None (one device)."""
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the model code under ``mesh``: param leaves carrying a spec
    (``sharding.shard_params``) are gathered where they are used, and the
    tensor-, expert- and batch-axis collectives run over its groups."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


def own_cards(local_world: int) -> bool:
    """Does every one of ``local_world`` ranks on this host have a card of
    its own (``cuda:LOCAL_RANK``)? Else they share ``cuda:0``."""
    return torch.cuda.is_available() and \
        torch.cuda.device_count() >= local_world


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every local rank has a card of its own, gloo otherwise (the
    CPU, or ranks sharing one card: NCCL refuses a duplicate device)."""
    if device.type == "cuda" and own_cards(local_world):
        return "nccl"
    return "gloo"


def p2p_staged(t: torch.Tensor, group=None) -> bool:
    """Does a point-to-point transfer of ``t`` stage through host memory?
    Every CUDA tensor under gloo does: gloo's send and recv refuse them."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def describe_backend(device: torch.device) -> str:
    backend = dist.get_backend()
    if backend == "gloo" and device.type == "cuda":
        return "gloo, point-to-point host-staged"
    return backend


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; a new tensor (``t`` is left as it is)."""
    if group is None:
        return t
    _count("all_reduce", t.numel() * t.element_size())
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    n = _size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    _count("all_gather", out.numel() * out.element_size())
    # contiguous like the block it stands in for (the kernels take
    # contiguous weights)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over ``group``, then this rank's block along ``dim``."""
    if group is None:
        return t
    n = _size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _count("reduce_scatter", src.numel() * src.element_size())
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def broadcast(t: torch.Tensor, src_index: int, group) -> torch.Tensor:
    """Group rank ``src_index``'s ``t`` on every rank of ``group``."""
    if group is None:
        return t
    _count("broadcast", t.numel() * t.element_size())
    src = dist.get_global_rank(group, src_index)
    out = t.detach().clone().contiguous()
    dist.broadcast(out, src, group=group)
    return out


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], group
             ) -> Sequence[torch.Tensor]:
    """Point-to-point in one batch (``batch_isend_irecv``, so that a ring
    cannot deadlock): send each ``(tensor, group_rank)`` and receive into a
    tensor shaped like each ``(template, group_rank)``; returns the
    received tensors on the templates' devices."""
    ops, outs = [], []
    staged = any(p2p_staged(t, group) for t, _ in list(sends) + list(recvs))
    for t, peer in sends:
        buf = _to_host(t) if staged else t.detach().contiguous()
        _count("send", buf.numel() * buf.element_size())
        ops.append(dist.P2POp(dist.isend, buf,
                              dist.get_global_rank(group, peer), group))
    for t, peer in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype,
                          device="cpu" if staged else t.device,
                          pin_memory=staged)
        outs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [o.to(t.device) for o, (t, _) in zip(outs, recvs)]


# ---------------------------------------------------------------------------
# autograd pairs
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, bwd_sum):
        ctx.dim, ctx.group, ctx.bwd_sum = dim, group, bwd_sum
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd_sum:
            g = reduce_scatter(g, ctx.dim, ctx.group)
        else:
            g = g.chunk(_size(ctx.group), ctx.dim)[_rank(ctx.group)]
        return g.contiguous(), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, fwd, bwd):
        ctx.group, ctx.bwd = group, bwd
        return all_reduce(x, group) if fwd else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(g, ctx.group) if ctx.bwd else g), None, None, None


def gather(x: torch.Tensor, dim: int, group, backward: str = "sum"
           ) -> torch.Tensor:
    """All-gather along ``dim``. Backward ``"sum"``: the ranks computed on
    different data (a batch axis), so the gradients are summed and each
    rank keeps its block (a reduce-scatter); ``"slice"``: every rank holds
    the same gradient (a replicated use), so each keeps its own block."""
    if group is None:
        return x
    assert backward in ("sum", "slice"), backward
    return _Gather.apply(x, dim, group, backward == "sum")


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward, identity backward: the partial outputs of a
    row-parallel product summed into the replicated result."""
    if group is None:
        return x
    return _Reduce.apply(x, group, True, False)


def reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward: a replicated tensor read by a
    computation partitioned over ``group`` (each rank's gradient is a part
    of the whole)."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Reduce.apply(x, group, False, True)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce both ways: a sum over ``group`` that every rank's share of
    the loss reads (the global token count is a plain ``all_reduce``; the
    router's mean probabilities need the gradient)."""
    if group is None:
        return x
    return _Reduce.apply(x, group, True, True)
