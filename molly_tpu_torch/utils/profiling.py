"""Profiling, the counterpart of ``molly_tpu/utils/profiling.py``: named
spans and counters recorded in memory, synchronizing phase marks, a
``torch.profiler`` trace context and per-step timing stats.

Spans and counters cost nothing unless something asks for them. With no
recording current on any thread and no profiler running, ``span()`` and
``sync()`` return one shared no-op context after one check, and
``count()`` returns at once: no allocation, no clock read, no event.

Under ``recording(stats)`` a span records its host interval
(``time.perf_counter_ns``) and its parent; a ``device=True`` span on a card
also records a pair of CUDA events from a reused pool. Nothing is read or
synchronized while the work runs: the events, and any counter whose value
lives on the device, are read once, when the recording closes, which its
callers do after a synchronization they make anyway (the tokens' copy to
the host, the last phase mark, the train step's final synchronize).

Whenever the torch profiler is enabled, each span also opens a range of
that name in its trace, on the same clock as the kernels, so an idle gap
inside it can be named. The range is a function-scope record
(``_RecordFunctionFast``), as an operator's is: ``record_function``'s user
annotations get a twin on the device's timeline that spans the gaps
between their kernels, and a trace reader would count it as device work.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
# read through the module at every call: ``from ... import`` of the flag
# would keep the value it had at import
from torch.autograd import profiler as _autograd_profiler

_local = threading.local()
_lock = threading.Lock()
_open = 0                # recordings open in the process, on any thread
_EVENTS: List[Any] = []  # idle CUDA event pairs, reused


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("rec", "name", "waits", "events", "range", "t0",
                 "child_ns", "wait_ns")

    def __init__(self, rec, name: str, device: bool):
        self.rec, self.name, self.waits = rec, name, False
        self.events = (rec.event_pair() if device and rec is not None
                       and torch.cuda.is_initialized() else None)

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _RecordFunctionFast(self.name)
            self.range.__enter__()
        if self.rec is not None:
            self.rec.stack.append(self)
            self.child_ns = self.wait_ns = 0
            if self.events is not None:
                self.events[0].record()
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            ns = time.perf_counter_ns() - self.t0
            if self.events is not None:
                self.events[1].record()
            self.rec.close(self, ns)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class _Recorder:
    """One thread's spans and counters between a recording's open and
    close, aggregated by name as they close."""

    def __init__(self):
        self.stack: List[_Span] = []
        # name -> [n, ns, self ns, ns waiting in syncs, event pairs]
        self.spans: Dict[str, list] = {}
        self.counts: Dict[str, Any] = {}

    def event_pair(self):
        if _EVENTS:
            return _EVENTS.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def close(self, sp: _Span, ns: int) -> None:
        self.stack.pop()
        wait = ns if sp.waits else sp.wait_ns
        agg = self.spans.get(sp.name)
        if agg is None:
            agg = self.spans[sp.name] = [0, 0, 0, 0, []]
        agg[0] += 1
        agg[1] += ns
        agg[2] += ns - sp.child_ns
        agg[3] += wait
        if sp.events is not None:
            agg[4].append(sp.events)
        if self.stack:
            parent = self.stack[-1]
            parent.child_ns += ns
            parent.wait_ns += wait

    def write(self, stats: Dict[str, Any]) -> None:
        """Adds what was recorded to ``stats["spans"]`` and
        ``stats["counts"]``, reading the device events and counters."""
        spans = stats.setdefault("spans", {})
        for name, (n, ns, self_ns, wait_ns, events) in self.spans.items():
            device_s = (sum(a.elapsed_time(b) for a, b in events) / 1e3
                        if events else None)
            _EVENTS.extend(events)
            old = spans.get(name)
            if old is None:
                spans[name] = {"n": n, "host_s": ns / 1e9,
                               "self_host_s": self_ns / 1e9,
                               "sync_s": wait_ns / 1e9,
                               "device_s": device_s}
                continue
            old["n"] += n
            old["host_s"] += ns / 1e9
            old["self_host_s"] += self_ns / 1e9
            old["sync_s"] += wait_ns / 1e9
            if device_s is not None:
                old["device_s"] = (old["device_s"] or 0.0) + device_s
        counts = stats.setdefault("counts", {})
        for name, v in self.counts.items():
            if isinstance(v, torch.Tensor):
                v = v.item()
            counts[name] = counts.get(name, 0) + v


def _recorder() -> Optional[_Recorder]:
    return getattr(_local, "rec", None)


def active() -> bool:
    """Is a recording current on the calling thread? (For callers whose
    counts cost something to work out.)"""
    return bool(_open) and _recorder() is not None


def span(name: str, device: bool = False):
    """A context naming a part of the work: recorded under a current
    recording (with CUDA event time too when ``device``), a range in the
    trace under the profiler, else nothing."""
    if not _open and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    rec = _recorder()
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(rec, name, device)


def count(name: str, n=1) -> None:
    """Adds ``n`` (a number, or a tensor read when the recording closes) to
    the counter ``name`` of the current recording, if there is one."""
    if not _open:
        return
    rec = _recorder()
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


def sync(site: str, n: int = 1):
    """The span ``molly/sync/<site>`` around a blocking host read (``n`` of
    them), each counted in ``host_syncs``: on a card, the host waits there
    for the device's backlog."""
    if not _open and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    count("host_syncs", n)
    sp = span("molly/sync/" + site)
    if sp is not _NOOP:
        sp.waits = True
    return sp


@contextlib.contextmanager
def recording(stats: Optional[Dict[str, Any]]):
    """Makes a recorder current on the calling thread and, when the block
    ends without an exception, adds what it recorded to ``stats``:
    ``stats["spans"][name] = {"n", "host_s", "self_host_s", "sync_s",
    "device_s"}`` (self time leaves out the child spans; ``sync_s`` is the
    host time in ``sync`` spans at any depth inside, the span's own when it
    is one; ``device_s`` is the CUDA event time of ``device=True`` spans on
    a card, else None) and ``stats["counts"][name]``. The caller
    synchronizes before the block
    ends; the recorder never does. A no-op when ``stats`` is None or a
    recording is already current on this thread (that one records the
    block)."""
    global _open
    if stats is None or _recorder() is not None:
        yield
        return
    rec = _local.rec = _Recorder()
    with _lock:
        _open += 1
    try:
        yield
    finally:
        _local.rec = None
        with _lock:
            _open -= 1
    rec.write(stats)


def phase_marks(stats: Dict[str, float], device: torch.device):
    """Wall-clock phases for ``stats``: returns ``mark(name)``, which adds
    the seconds since the previous mark (the first: since this call) to
    ``stats[name]``. This call and every mark synchronize ``device`` first,
    so a phase holds the device work it queued; callers make marks only
    when asked for timings."""

    def now() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    last = [now()]

    def mark(name: str) -> None:
        t = now()
        stats[name] = stats.get(name, 0.0) + t - last[0]
        last[0] = t

    return mark


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the host and, when there is one, the
    card; writes ``<log_dir>/trace.json`` (Chrome trace format) and
    ``<log_dir>/key_averages.txt``. Every span (``span``) is a range in it:
    the train step's ``molly/forward``, ``molly/backward`` and
    ``molly/optimizer`` among them. No-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "key_averages.txt"), "w") as fh:
        fh.write(prof.key_averages().table(
            sort_by="self_cuda_time_total" if len(acts) > 1
            else "self_cpu_time_total", row_limit=40))


class StepTimer:
    """Wall-clock step timing with warmup skip and percentile summary."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._seen = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip_first:
            self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        import numpy as np
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "max_s": float(t.max()),
        }
