"""Build and load the port's hand-written CUDA kernels.

Every source under csrc/ has a plain C interface.  It is compiled for
sm_90a by nvcc into a shared library under build/kernels/ (named by the
hash of the source and the csrc/ headers it includes, so an edited source
or header builds anew and an unchanged one is reused) and loaded with
ctypes at first use -- never at import, so the CPU tests import every
module without nvcc.  `build` starts one nvcc per source that is not built
yet, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "kernels")
LOGS = {}   # source name -> nvcc/ptxas output of this process's build
_libs = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cand = [shutil.which("nvcc"),
            os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def sources(name: str, csrc: str = None) -> list:
    """csrc/<name> and every csrc/ header it includes ("x.cuh"), directly
    or through another header, in first-seen order (csrc: another source
    directory, default CSRC)."""
    csrc = csrc or CSRC
    seen, todo = [], [name]
    while todo:
        cur = todo.pop(0)
        if cur in seen:
            continue
        seen.append(cur)
        with open(os.path.join(csrc, cur)) as f:
            todo += re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(),
                               re.M)
    return seen


def lib_path(name: str, csrc: str = None, build_dir: str = None) -> str:
    """build/kernels/lib<stem>-<hash>.so of the source csrc/<name>; the
    hash covers the source and the headers it includes."""
    csrc = csrc or CSRC
    h = hashlib.sha256()
    for src in sources(name, csrc):
        with open(os.path.join(csrc, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(build_dir or BUILD_DIR,
                        f"lib{os.path.splitext(name)[0]}-"
                        f"{h.hexdigest()[:16]}.so")


def build(*names: str, csrc: str = None, build_dir: str = None) -> list:
    """Compile the named csrc/ sources (those not built yet, in parallel)
    and return their library paths; raises if any nvcc fails.  LOGS[name]
    holds the nvcc/ptxas output (-Xptxas -v: registers, shared memory and
    spills per kernel), or "cached" for a library that was reused.  csrc,
    build_dir: other source and library directories (default CSRC,
    BUILD_DIR)."""
    csrc, build_dir = csrc or CSRC, build_dir or BUILD_DIR
    os.makedirs(build_dir, exist_ok=True)
    outs = [lib_path(n, csrc, build_dir) for n in names]
    procs = []
    for name, out in zip(names, outs):
        if os.path.exists(out):
            LOGS.setdefault(name, "cached")   # keep this process's build log
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, os.path.join(csrc, name)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        so, se = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{se}")
            continue
        os.replace(tmp, out)
        LOGS[name] = so + se
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library of csrc/<name> (built at first use); bind(lib)
    declares its functions' argument and result types once."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build(name)[0])
            bind(lib)
            _libs[name] = lib
        return _libs[name]
