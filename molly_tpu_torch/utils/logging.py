"""Observability: console logging, wall-clock timers, step metrics, and a
pluggable tracker (JSONL file / tensorboard-style callbacks), the
counterpart of ``molly_tpu/utils/logging.py``. One process drives one
device here, so that process is always the main one.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional


def is_main_process() -> bool:
    return True


def print_rank_0(*args, **kw) -> None:
    if is_main_process():
        print(*args, **kw, flush=True)


@contextlib.contextmanager
def time_count(label: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print_rank_0(f"[{label}] {time.perf_counter() - t0:.2f}s")


class _Tracker:
    """Experiment-tracker sink, rank-0 only, graceful no-op when the
    library is absent — mirrors the reference's swanlab/wandb/tensorboard
    reporting."""

    def __init__(self, backend: str, experiment: str,
                 log_dir: Optional[str], config: Optional[Dict] = None):
        self.backend = backend
        self._run = None
        try:
            if backend == "wandb":
                import wandb
                self._run = wandb.init(project="molly_tpu_torch", name=experiment,
                                       config=config or {},
                                       dir=log_dir or None)
                self._log = lambda step, rec: self._run.log(rec, step=step)
                self._close = self._run.finish
            elif backend == "swanlab":
                import swanlab
                self._run = swanlab.init(project="molly_tpu_torch",
                                         experiment_name=experiment,
                                         config=config or {})
                self._log = lambda step, rec: swanlab.log(rec, step=step)
                self._close = swanlab.finish
            elif backend == "tensorboard":
                from torch.utils.tensorboard import SummaryWriter
                self._run = SummaryWriter(
                    os.path.join(log_dir or ".", "tb", experiment))
                self._log = lambda step, rec: [
                    self._run.add_scalar(k, v, step) for k, v in rec.items()]
                self._close = self._run.close
            else:
                raise ValueError(f"unknown tracker backend: {backend}")
        except (ImportError, OSError) as e:
            print_rank_0(f"[tracker] {backend} unavailable ({e}); "
                         f"metrics go to JSONL only")
            self._run = None

    def log(self, step: int, record: Dict[str, float]) -> None:
        if self._run is not None:
            self._log(step, record)

    def close(self) -> None:
        if self._run is not None:
            self._close()


class MetricLogger:
    """Rank-0 JSONL metric stream + console line + optional tracker
    backends (report_to ⊆ {"jsonl", "wandb", "swanlab", "tensorboard"};
    record shape {"step": n, **metrics})."""

    def __init__(self, log_dir: Optional[str] = None,
                 experiment: str = "molly", console_every: int = 1,
                 report_to: Optional[Any] = ("jsonl",),
                 config: Optional[Dict] = None):
        self.console_every = console_every
        self._fh = None
        self._trackers = []
        if not is_main_process():
            return
        if isinstance(report_to, str):
            report_to = [s for s in report_to.split(",") if s]
        report_to = list(report_to or [])
        if log_dir and "jsonl" in report_to:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{experiment}.jsonl"), "a")
        for backend in report_to:
            if backend in ("jsonl", "none"):
                continue
            self._trackers.append(_Tracker(backend, experiment, log_dir,
                                           config))

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if not is_main_process():
            return
        record = {"step": int(step)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                continue
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        payload = {k: v for k, v in record.items() if k != "step"}
        for t in self._trackers:
            t.log(int(step), payload)
        if self.console_every and step % self.console_every == 0:
            parts = " ".join(f"{k}={v:.5g}" for k, v in record.items()
                             if k != "step")
            print(f"step {step}: {parts}", flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        for t in self._trackers:
            t.close()


def domain_loss_metrics(metrics: Dict[str, Any],
                        task_names: Optional[Dict[int, str]] = None
                        ) -> Dict[str, float]:
    """Expand per-task domain sums/counts into loss_<task> entries, the
    key shape the reference logs. Values may be tensors or arrays."""
    from ..data.omics_dataset import TASK_ID_MAP

    if "domain_loss_sum" not in metrics:
        return {}
    names = {tid: frag for frag, tid in TASK_ID_MAP}
    names[len(names)] = "unknown"
    if task_names:
        names.update(task_names)
    sums = metrics["domain_loss_sum"]
    counts = metrics["domain_loss_count"]
    out = {}
    for i in range(len(names)):
        c = float(counts[i])
        if c > 0:
            out[f"loss_{names[i]}"] = float(sums[i]) / c
    return out
