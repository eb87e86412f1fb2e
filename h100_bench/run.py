"""The benchmark's one command: one run of one cell.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout of the repository, on a machine with the
CUDA cards the cell asks for (see README.md)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100_bench.harness import env  # noqa: E402

env.set_cache_env()  # before torch, and with it Triton, is imported
STARTED = env.process_start()

from h100_bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
