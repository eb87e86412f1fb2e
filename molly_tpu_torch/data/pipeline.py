"""Asynchronous host input pipeline: tokenize-once caching, background
prefetch, and host-to-device transfer overlap.

The reference gets host/device overlap from torch DataLoader worker
processes (the upstream project; HF Trainer's get_batch_samples). This stack's
dataset work is pure numpy + tokenizer calls, so threads suffice: the GIL
is released inside numpy, regex, and blocking device waits, and a batch of
tokenization is milliseconds — what matters is that it happens WHILE the
device executes the current step, not between steps.

Three composable pieces:

  - ``CachingDataset``: memoizes ``dataset[i]`` across epochs so each
    sample is tokenized exactly once per run (the reference re-tokenizes
    every epoch; its DataLoader workers only hid the cost).
  - ``prefetch(it, depth)``: a bounded background-thread producer over any
    batch iterator (double-buffered at depth=2).
  - ``device_put_prefetch(batches, put)``: issues the (async) host-to-
    device transfer of batch i+1 before yielding batch i, so the transfer
    rides under step i's execution.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional


class CachingDataset:
    """Tokenize-once wrapper: ``ds[i]`` is computed on first access and
    replayed from memory afterwards. Samples are fixed-shape numpy dicts
    (a few KB each), so even 100k-sample datasets cache in low GBs of
    host RAM; pass ``max_items`` to bound it (LRU-free: items past the
    cap are simply recomputed — epoch iteration order is near-cyclic so
    a plain dict keeps the hot head of the dataset)."""

    def __init__(self, dataset, max_items: Optional[int] = None):
        self._ds = dataset
        self._cache: Dict[int, Any] = {}
        self._max = max_items

    def __len__(self) -> int:
        return len(self._ds)

    def __getattr__(self, name):  # passthrough (task maps, config, ...)
        return getattr(self._ds, name)

    def __getitem__(self, i: int):
        hit = self._cache.get(i)
        if hit is None:
            hit = self._ds[i]
            if self._max is None or len(self._cache) < self._max:
                self._cache[i] = hit
        return hit


_END = object()


def prefetch(iterator: Iterable[Any], depth: int = 2) -> Iterator[Any]:
    """Run ``iterator`` in a daemon thread, handing items through a
    bounded queue. depth=2 double-buffers: one batch being consumed, one
    ready, one in flight. Exceptions in the producer re-raise at the
    consumer's next request; the producer stops early if the consumer
    drops the generator (GC closes it)."""
    q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def worker():
        try:
            for item in iterator:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_END)
        except BaseException as e:  # re-raised consumer-side
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def device_put_prefetch(batches: Iterable[Any],
                        put: Callable[[Any], Any]) -> Iterator[Any]:
    """Yield device-resident batches one transfer ahead: batch i+1's
    ``put`` (``to_device`` below: a pinned-memory, non-blocking copy) is
    issued before batch i is yielded, so the host-to-device copy overlaps
    step i's execution."""
    prev = None
    for b in batches:
        d = put(b)
        if prev is not None:
            yield prev
        prev = d
    if prev is not None:
        yield prev


def to_device(device) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """The ``put`` of the port (``jax.device_put`` in ``molly_tpu``): every
    numpy array of a collated batch becomes a tensor on ``device``. For a
    CUDA device the host tensor is pinned and the copy is non-blocking, so
    it runs on the copy engine under the current step; other values
    (task names, raw strings) pass through."""
    import numpy as np
    import torch
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(v))
                out[k] = (t.pin_memory().to(device, non_blocking=True)
                          if cuda else t.to(device))
            else:
                out[k] = v
        return out

    return put


def input_pipeline(dataset, batch_size: int, *, shuffle: bool = False,
                   seed: int = 0, epoch: int = 0, collate_fn=None,
                   put: Optional[Callable[[Any], Any]] = None,
                   depth: int = 2, drop_last: bool = True):
    """The composed pipeline the train CLI uses: epoch iterator ->
    background prefetch -> (optional) one-ahead device transfer."""
    from .collate import (collate_train, iterate_batches,
                          iterate_stream_batches)

    if hasattr(dataset, "iter_epoch"):  # StreamingOmicsDataset: shuffle
        # lives in its row-group/reservoir logic, not in an index permute
        it = iterate_stream_batches(dataset, batch_size, epoch=epoch,
                                    drop_last=drop_last,
                                    collate_fn=collate_fn or collate_train)
    else:
        it = iterate_batches(dataset, batch_size, shuffle=shuffle,
                             seed=seed, drop_last=drop_last,
                             collate_fn=collate_fn or collate_train,
                             epoch=epoch)
    out = prefetch(it, depth=depth)
    if put is not None:
        out = device_put_prefetch(out, put)
    return out
