"""Peak resident memory of each port test module run alone on the CPU.

    python3 scripts/peak_rss_test_modules.py ["tests/test_torch_*.py"]

Runs each module matching the glob (relative to the repo root) in its own
pytest process, as one tier-1 worker would, and prints its peak resident
set (`os.wait4`'s ru_maxrss, KiB on Linux), its exit code and its seconds.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def peak_rss_by_module(pattern="tests/test_torch_*.py"):
    """{module: (peak resident GiB, exit code, seconds)}, each module run
    alone in its own pytest process."""
    out = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for path in sorted(glob.glob(os.path.join(REPO, pattern))):
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                                 "-p", "no:xdist", os.path.relpath(path, REPO)], cwd=REPO, env=env,
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        _, status, usage = os.wait4(proc.pid, 0)
        out[os.path.relpath(path, REPO)] = (
            usage.ru_maxrss / 2**20, os.waitstatus_to_exitcode(status), time.perf_counter() - t0)
    return out


if __name__ == "__main__":
    for module, (gib, rc, sec) in peak_rss_by_module(*sys.argv[1:]).items():
        print(f"{module}: peak RSS {gib:.2f} GiB, exit {rc}, {sec:.0f} s", flush=True)
