"""Native (C++) runtime components, loaded via ctypes.

The library is built on demand with the system toolchain into the
checkout's build/native/ directory; every entry point has a pure-Python
fallback so the framework works without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "levelize.cpp")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "native")
    os.makedirs(cache, exist_ok=True)
    out = os.path.join(cache, f"levelize-{tag}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.CalledProcessError):
        return None


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("IYOKAN_NO_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    L = ctypes.CDLL(path)
    L.levelize.restype = ctypes.c_int
    L.levelize.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    L.gate_census.restype = None
    L.gate_census.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    _lib = L
    return _lib


def levelize(n_nodes: int, src: np.ndarray, dst: np.ndarray
             ) -> Optional[np.ndarray]:
    """Longest-path levels; None if the native library is unavailable.

    Raises ValueError on a combinational cycle.
    """
    L = lib()
    if L is None:
        return None
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    out = np.zeros(n_nodes, np.int32)
    rc = L.levelize(n_nodes, len(src), src, dst, out)
    if rc != 0:
        raise ValueError("combinational cycle detected")
    return out
