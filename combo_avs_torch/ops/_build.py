"""Compile the port's CUDA sources with nvcc on first use and load them.

Each source in `combo_avs_torch/csrc/` is built on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ctypes. Libraries go to `combo_avs_torch/_build/`
(git-ignored) under a name that carries a hash of the source and the flags,
so an edited source is never served by a stale library. Nothing here runs at
import time: a CPU-only process never compiles anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(source: str) -> str:
    """Where the library built from `csrc/<source>` lives."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def load_all(sources) -> list:
    """Build every `csrc/<source>` whose library is missing, one nvcc process
    per source, all started together; then load each (once per process)."""
    with _lock:
        todo = [s for s in sources if s not in _libs and not os.path.exists(library_path(s))]
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = find_nvcc()
            jobs = []
            for source in todo:
                path = library_path(source)
                tmp = f"{path}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
                jobs.append((source, path, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            failed = []
            for source, path, tmp, proc in jobs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed ({proc.returncode}) for {source}:\n{out}")
                else:
                    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
            if failed:
                raise RuntimeError("\n".join(failed))
        for source in sources:
            if source not in _libs:
                _libs[source] = ctypes.CDLL(library_path(source))
        return [_libs[s] for s in sources]


def load(source: str) -> ctypes.CDLL:
    """Build `csrc/<source>` if its library is missing, then load it (once
    per process)."""
    return load_all([source])[0]
