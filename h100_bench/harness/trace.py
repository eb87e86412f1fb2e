"""A traced slice: ``torch.profiler`` (CUPTI) over one batch run again
after the window, reduced in memory to what the per-layer readers and the
result's ``device`` and ``breakdown`` need. Nothing is written to disk.

Busy time is the union of the device's kernel, copy and set intervals
inside the slice, so work on two streams at once counts once; idle is the
rest of the slice. Each idle gap is labelled by the innermost host
operation running at its middle: what the host was doing while the device
waited."""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

import torch

SLICE_NAME = "bench::profiled_slice"
_TOP = 10
_LOOK_BACK = 64


class Summary:
    """``busy_s``, ``window_s``, device time by kernel name, and the
    breakdown of the result line."""

    def __init__(self, window_s: float, busy_s: float,
                 kernels: Dict[str, float], gaps: Dict[str, float]):
        self.window_s, self.busy_s = window_s, busy_s
        self.kernels, self.gaps = kernels, gaps

    def kernel_seconds(self, patterns: List[str]) -> float:
        """Device seconds of the kernels whose names match any pattern."""
        rx = [re.compile(p) for p in patterns]
        return sum(s for name, s in self.kernels.items()
                   if any(r.search(name) for r in rx))

    def breakdown(self) -> Dict[str, List[Tuple[str, float]]]:
        top = sorted(self.kernels.items(), key=lambda x: -x[1])[:_TOP]
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])[:_TOP]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _is_device_work(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = str(getattr(e, "activity_type", lambda: "")()).lower()
    return "annotation" not in kind and not e.name().startswith("bench::")


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(prof) -> Optional[Summary]:
    """The profiled slice's summary, or None if the trace holds no slice."""
    events = prof.profiler.kineto_results.events()
    span = next((e for e in events if e.name() == SLICE_NAME
                 and e.device_type() == torch.autograd.DeviceType.CPU), None)
    if span is None:
        return None
    t0, t1 = span.start_ns(), span.start_ns() + span.duration_ns()
    device, host = [], []
    kernels: Dict[str, float] = {}
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if _is_device_work(e):
            lo, hi = max(a, t0), min(a + d, t1)
            if hi > lo:
                device.append((lo, hi))
                kernels[e.name()] = kernels.get(e.name(), 0.0) + \
                    (hi - lo) * 1e-9
        elif e.device_type() == torch.autograd.DeviceType.CPU and d > 0 \
                and e.name() != SLICE_NAME:
            host.append((a, a + d, e.name()))
    busy = _union(device)
    busy_ns = sum(b - a for a, b in busy)
    gaps, edge = [], t0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if t1 > edge:
        gaps.append((edge, t1))
    return Summary((t1 - t0) * 1e-9, busy_ns * 1e-9, kernels,
                   _label_gaps(gaps, host))


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host operation at each gap's middle
    (among the last ``_LOOK_BACK`` operations started before it), or
    "python between operations" where none was running."""
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        j = bisect.bisect_right(starts, mid)
        best = None
        for k in range(j - 1, max(-1, j - 1 - _LOOK_BACK), -1):
            s, e, name = host[k]
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        label = best[2] if best is not None else "python between operations"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-9
    return out


class ProfiledSlice:
    """``with ProfiledSlice() as s: ...`` profiles the block, synchronized
    at both ends; ``s.summary`` holds the reduction afterwards."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self.cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if self.cuda:  # the CPU only in the harness's tests
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.span = record_function(SLICE_NAME)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        self.summary = summarize(self.prof) if exc[0] is None else None
        del self.prof
        return False
