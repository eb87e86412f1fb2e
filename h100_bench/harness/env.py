"""The process around a run: cache directories fixed inside the checkout,
the process's start time, what was built, and the modules a run must not
hold."""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / ".cache"
# nvcc's libraries and the native tokenizer stay where the program keeps
# them (named by a hash of their source), inside the checkout
PROGRAM_BUILD_DIR = ROOT / "molly_tpu_torch" / "_build"

# top-level module names that no process of the benchmark may hold: the JAX
# stack, the JAX package and the JAX package's benchmarks. Compared as whole
# names: ``molly_tpu_torch`` is not ``molly_tpu``.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "molly_tpu",
                               "benchmarks"})


def set_cache_env() -> None:
    """Point every compiler cache at a fixed directory of the checkout, and
    keep libraries that could load JAX by themselves from doing so. Runs
    before torch (and with it Triton) is imported."""
    fixed = {"TRITON_CACHE_DIR": CACHE_DIR / "triton",
             "TORCH_EXTENSIONS_DIR": CACHE_DIR / "torch_extensions",
             "CUDA_CACHE_PATH": CACHE_DIR / "nv"}
    for key, path in fixed.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def process_start() -> float:
    """The wall-clock time at which this process was created (from
    ``/proc``, to 10 ms), so that set-up counts the interpreter's start and
    every import; the time of this call where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among the modules loaded now."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & FORBIDDEN_MODULES)


def build_snapshot() -> Dict[str, int]:
    """How many files the program's build directory and the Triton cache
    hold: compared before and after set-up, so a run says whether it
    compiled anything."""
    def count(path: Path) -> int:
        return sum(1 for p in path.rglob("*") if p.is_file()) \
            if path.exists() else 0
    return {"nvcc_and_native_libraries": count(PROGRAM_BUILD_DIR),
            "triton_cache_files": count(CACHE_DIR / "triton")}
