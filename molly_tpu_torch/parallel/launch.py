"""Run a function on N ranks of a fresh process group, each in a process of
its own (``torch.multiprocessing``, spawn start method): the way the tests
and the card's smoke run hold a mesh against a one-rank run without
``torchrun``.

Rendezvous goes through a ``FileStore`` in a directory of the caller's
(never a fixed TCP port: runs started together would collide). Each rank
gets one intra-op thread unless asked otherwise. The backend is
``comm.choose_backend``'s: NCCL when every rank has a card of its own, gloo
otherwise (the CPU, or ranks sharing one card). A rank that raises or exits
non-zero fails the whole call.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def _child(rank: int, fn: Callable, world: int, args: Sequence[Any],
           device: str, root: str, threads: int,
           timeout_s: Optional[float]) -> None:
    torch.set_num_threads(threads)
    from . import comm
    dev = torch.device(device)
    if dev.type == "cuda":
        backend = comm.choose_backend(dev, world)
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    else:
        backend = "gloo"
    store = dist.FileStore(os.path.join(root, "store"), world)
    kw = ({"timeout": datetime.timedelta(seconds=timeout_s)}
          if timeout_s else {})
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, **kw)
    try:
        result = fn(rank, world, dev, *args)
        torch.save(result, os.path.join(root, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *,
              device: str = "cpu", root: Optional[str] = None,
              threads: int = 1,
              timeout_s: Optional[float] = None) -> List[Any]:
    """``fn(rank, world, device, *args)`` on ``world`` ranks; returns each
    rank's return value (saved with ``torch.save``), in rank order. ``fn``
    must be importable by name (a module-level function). ``device``:
    ``"cpu"``, or ``"cuda"`` for each rank's card (its own under NCCL,
    ``cuda:0`` shared under gloo). ``timeout_s``: the process group's
    collective timeout (torch's default when None)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        mp.start_processes(_child, args=(fn, world, tuple(args), device, tmp,
                                         threads, timeout_s),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
