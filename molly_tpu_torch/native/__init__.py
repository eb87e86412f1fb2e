"""Native (C++) runtime components, loaded over ctypes.

A copy of ``molly_tpu/native`` (the port keeps its own). The shared library
is built on first use with g++ into ``molly_tpu_torch/_build/`` (git-ignored),
not beside the source. Falls back gracefully: callers check ``available()``
and use the pure-Python implementations otherwise.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "tokenizers.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(_BUILD_DIR, "libmolly_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, _SRC],
            check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, _LIB)  # atomic: concurrent builds agree
        return None
    except (subprocess.CalledProcessError, OSError,
            subprocess.TimeoutExpired) as e:
        return getattr(e, "stderr", str(e)) or str(e)


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None on failure."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            err = _build()
            if err:
                _build_error = err
                return None
        lib = ctypes.CDLL(_LIB)
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        p_i32 = ctypes.POINTER(i32)
        p_i64 = ctypes.POINTER(i64)
        for name in ("nt_encode", "protein_encode"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, i32, i32, p_i32]
            fn.restype = i32
        for name in ("nt_encode_batch", "protein_encode_batch"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, p_i64, i32, i32, p_i32]
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def build_error() -> Optional[str]:
    return _build_error
