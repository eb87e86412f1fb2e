"""Readings that set a cell's limits (not part of a benchmark run): the
program's check numbers on many seeds and the control's on a few, each run
at the cell's own sizes with a window of greedy batches only, as many as
hold the requests a run compares, and as many requests compared.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control int8 --control-seeds 4,5,6]

The control is the program's own lower-precision path: ``int8`` puts the
decoder's weights (the experts too) through ``quantize_for_decode`` of the
program's model module that the configuration's ``reference/<decoder>.py``
names, the int8 weight-only decode the inference CLI's ``--int8`` runs.
Prints one line a reading and a JSON summary last."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100_bench.harness import env  # noqa: E402

env.set_cache_env()


def readings(workload, seeds, control=None, bench_dir=None, device="cuda",
             dump=None):
    """{seed: {number: reading}} for runs of one batch."""
    import torch
    from h100_bench.harness.cell import load_cell
    from h100_bench.harness.main import run_cell
    out = {}
    for seed in seeds:
        cell = load_cell(workload, *([bench_dir] if bench_dir else []))
        cell.seed, cell.seconds, cell.device = seed, 0.0, device
        cell.control, cell.started = control, time.time()
        t = cell.traffic
        t["greedy_every"] = 1
        cell.extra["batches"] = -(-t["check_requests"] // t["batch_size"])
        cell.extra["no_warmup"] = True  # readings only: nothing is timed
        outcome = run_cell(cell)
        out[seed] = outcome.record["check_numbers"]
        if dump:  # every token's gap, to weigh other numbers afterwards
            import numpy as np
            Path(dump).mkdir(parents=True, exist_ok=True)
            np.save(Path(dump) / f"{workload}.{control or 'program'}."
                    f"{seed}.npy", outcome.record["check_gaps"])
        print(f"[calibrate] {workload} {control or 'program'} seed {seed}: "
              f"{outcome.notes[-1]}", flush=True)
        del outcome
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser("h100_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default=None, choices=("int8",))
    p.add_argument("--control-seeds", default="")
    p.add_argument("--dump", default=None,
                   help="a directory for every checked token's gap")
    a = p.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    summary = {"workload": a.workload,
               "program": readings(a.workload, ints(a.seeds),
                                   dump=a.dump)}
    if a.control:
        summary["control"] = a.control
        summary["control_readings"] = readings(
            a.workload, ints(a.control_seeds), control=a.control,
            dump=a.dump)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
