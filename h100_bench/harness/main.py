"""One run of one cell: ``run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. Prints the cell's end-to-end metrics (``--trace 0``) or
its per-layer metrics (``--trace 1``) as the last line of standard output,
and each number its check compared, beside its limit, as the last lines of
standard error."""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

from . import env
from .cell import Cell, load_cell, metric_reader
from .result import Outcome, emit, result_line


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser("h100_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def setup_done(cell: Cell, before: Dict[str, int]) -> None:
    """Called by a driver when set-up ends and the window starts: records
    ``setup_s`` and says whether the run compiled anything."""
    cell.extra["setup_s"] = time.time() - cell.started
    after = env.build_snapshot()
    new = {k: after[k] - before.get(k, 0) for k in after}
    if any(new.values()):
        what = ", ".join(f"{n} new {k.replace('_', ' ')}"
                         for k, n in new.items() if n)
        print(f"[bench] set-up {cell.extra['setup_s']:.2f} s; compiled in "
              f"this run: {what}", flush=True)
    else:
        print(f"[bench] set-up {cell.extra['setup_s']:.2f} s; compiled "
              f"nothing: {after['nvcc_and_native_libraries']} nvcc and "
              f"native libraries and {after['triton_cache_files']} Triton "
              f"cache files were all there before this run", flush=True)


def run_cell(cell: Cell) -> Outcome:
    before = env.build_snapshot()
    cell.extra["setup_done"] = lambda: setup_done(cell, before)
    return cell.driver().run(cell)


def metrics_of(cell: Cell, outcome: Outcome) -> Dict[str, Dict[str, Any]]:
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values: Dict[str, Optional[float]] = {}
    if cell.trace:
        for m in cell.per_layer:
            values[m["name"]] = metric_reader(cell.bench_dir,
                                              m["name"])(outcome.record)
    else:
        for m in cell.end_to_end:
            # a quantity split by cell ("<quantity>.<cell kind>") is the
            # driver's quantity before the first dot
            name = m["name"]
            values[name] = (cell.extra["setup_s"] if name == "setup_s" else
                            outcome.end_to_end.get(name.split(".", 1)[0]))
    return {name: {"value": v, "unit": units[name]}
            for name, v in values.items() if v is not None}


def main(argv: List[str], started: float) -> int:
    args = parse(argv)
    import torch
    cell = load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: the cell asks for {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, \
        bool(args.trace)
    cell.device, cell.started = "cuda", started
    outcome = run_cell(cell)
    found = env.forbidden_modules()
    if found:
        print(f"h100_bench: the run loaded {found}, which no run may load",
              file=sys.stderr)
        return 3
    summary = outcome.record.get("trace")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    if cell.trace:
        if summary is None or summary.busy_s <= 0:
            print("h100_bench: the traced slice holds no device work",
                  file=sys.stderr)
            return 4
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
    line = result_line(outcome, metrics_of(cell, outcome), device,
                       summary.breakdown() if cell.trace else None)
    for note in outcome.notes:
        print(f"[bench] {note}", flush=True)
    emit(line, outcome)
    return 0
