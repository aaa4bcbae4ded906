"""Compile the port's native sources on first use and load them.

Each CUDA source in `combo_avs_torch/csrc/` is built with nvcc on its own
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with ctypes. Host C sources (the JPEG codec,
`combo_avs_torch/native/jpeg.c`) take the host route, `load_host`: the C
compiler of `$CC`, else `cc` or `gcc`. Libraries go to
`combo_avs_torch/_build/` (git-ignored) under a name that carries a hash of
the source and the flags, so an edited source is never served by a stale
library, and each is renamed into place whole. Nothing here runs at import
time: a process compiles only what it calls, and a CPU-only one never runs
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O2", "-std=c11", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def find_cc() -> list:
    """The host C compiler's command: `$CC` (split like a shell word list),
    else `cc` or `gcc` on PATH."""
    if os.environ.get("CC"):
        return shlex.split(os.environ["CC"])
    for name in ("cc", "gcc"):
        path = shutil.which(name)
        if path:
            return [path]
    raise RuntimeError("no C compiler found (set CC or put cc or gcc on PATH)")


def _hashed_path(src_path: str, flags) -> str:
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src_path))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def library_path(source: str) -> str:
    """Where the library built from `csrc/<source>` lives."""
    return _hashed_path(os.path.join(CSRC, source), NVCC_FLAGS)


def host_library_path(source: str) -> str:
    """Where the library built from the host source `<package>/<source>`
    (e.g. "native/jpeg.c") lives."""
    return _hashed_path(os.path.join(_PKG, source), HOST_FLAGS)


def _compile(jobs) -> None:
    """Run every (name, command, library path) at once; each library is
    written to a temporary name and renamed into place (a concurrent loader
    sees all of it or nothing). Raises RuntimeError naming each failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running, failed = [], []
    for name, cmd, path in jobs:
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            proc = subprocess.Popen([*cmd, "-o", tmp], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            failed.append(f"cannot run {cmd[0]} for {name}: {e}")
            continue
        running.append((name, cmd[0], path, tmp, proc))
    for name, tool, path, tmp, proc in running:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(tool)} failed ({proc.returncode}) for {name}:\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_all(sources) -> list:
    """Build every `csrc/<source>` whose library is missing, one nvcc process
    per source, all started together; then load each (once per process)."""
    with _lock:
        todo = [s for s in sources if s not in _libs and not os.path.exists(library_path(s))]
        if todo:
            nvcc = find_nvcc()
            _compile([(s, [nvcc, *NVCC_FLAGS, os.path.join(CSRC, s)], library_path(s))
                      for s in todo])
        for source in sources:
            if source not in _libs:
                _libs[source] = ctypes.CDLL(library_path(source))
        return [_libs[s] for s in sources]


def load(source: str) -> ctypes.CDLL:
    """Build `csrc/<source>` if its library is missing, then load it (once
    per process)."""
    return load_all([source])[0]


def load_host(source: str) -> ctypes.CDLL:
    """Build the host C source `<package>/<source>` (e.g. "native/jpeg.c")
    with the host compiler if its library is missing, then load it (once per
    process). Without a compiler it raises RuntimeError; there is no
    fallback."""
    with _lock:
        if source not in _libs:
            path = host_library_path(source)
            if not os.path.exists(path):
                _compile([(source, [*find_cc(), *HOST_FLAGS, os.path.join(_PKG, source)], path)])
            _libs[source] = ctypes.CDLL(path)
        return _libs[source]
