"""Profiling, the counterpart of ``molly_tpu/utils/profiling.py``: a
``torch.profiler`` trace context and per-step timing stats.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the host and, when there is one, the
    card; writes ``<log_dir>/trace.json`` (Chrome trace format),
    ``<log_dir>/key_averages.txt`` and ``<log_dir>/summary.json``: the
    window's wall seconds (the profiler's own overhead included) and the
    device-busy seconds (summed self device time of every kernel and copy).
    The train step marks its phases as ``molly/forward``, ``molly/backward``
    and ``molly/optimizer`` ranges in the trace. No-op when
    log_dir is None."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "key_averages.txt"), "w") as fh:
        fh.write(prof.key_averages().table(
            sort_by="self_cuda_time_total" if len(acts) > 1
            else "self_cpu_time_total", row_limit=40))

    # kernels and copies are the rows that ran on the card; the device-side
    # twin of a marked ``molly/...`` range spans its kernels AND the gaps
    # between them, so it is not busy time and is left out
    busy_us = sum(
        getattr(e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0))  # renamed in 2.x
        for e in prof.key_averages()
        if "CUDA" in str(e.device_type).upper()
        and not e.key.startswith("molly/"))
    summary = {"wall_s": wall, "device_busy_s": busy_us / 1e6}
    import json
    with open(os.path.join(log_dir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)


class StepTimer:
    """Wall-clock step timing with warmup skip and percentile summary."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._seen = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, tokens: int = 0) -> float:
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip_first:
            self.times.append(dt)
        self._last_tokens = tokens
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
