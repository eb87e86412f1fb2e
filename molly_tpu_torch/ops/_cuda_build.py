"""Build and load the port's CUDA kernels (``molly_tpu_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, which is loaded with ``ctypes``. Nothing
includes PyTorch's headers, so a build takes seconds, not minutes. All
sources compile in parallel (one ``nvcc`` each, started together).

Libraries go to ``molly_tpu_torch/_build/`` (git-ignored), named by a hash of
their source, the shared header and the flags, so an edited source rebuilds
and an unchanged one is reused. Importing this module needs no ``nvcc``; a
build runs only when a CUDA tensor first needs a kernel, or when
``build()`` is called. A failed build raises with the compiler's output.

Every exported C function returns the ``cudaError_t`` of its launch
(``cudaGetLastError()`` right after it); ``check()`` raises on nonzero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "int8_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, all in
    parallel; raise with the compiler output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            lib.molly_cuda_error_string.restype = ctypes.c_char_p
            lib.molly_cuda_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.molly_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
