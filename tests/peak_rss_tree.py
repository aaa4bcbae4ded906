"""Peak resident memory summed over a command's whole process tree.

    python3 tests/peak_rss_tree.py [--cwd DIR] -- python -m pytest tests/test_torch_ddp.py

Runs the command and samples, every 0.1 s, the resident set of it and of
every process it started (psutil), and prints the peak of their sum, the
largest number of processes alive at once, the exit code and the seconds;
with `--timeline S`, also each process's RSS every S seconds.
A module fixture that runs several processes at once (tests/test_torch_ddp.py)
holds their sum, which no single process's ru_maxrss shows.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import psutil


def tree_rss(proc: psutil.Process):
    """(summed RSS bytes, process count) of `proc` and its descendants."""
    total, n = 0, 0
    for p in [proc, *proc.children(recursive=True)]:
        try:
            total += p.memory_info().rss
            n += 1
        except psutil.Error:  # ended between the listing and the reading
            pass
    return total, n


def _each(proc: psutil.Process):
    out = []
    for p in [proc, *proc.children(recursive=True)]:
        try:
            out.append(f"{' '.join(p.cmdline()[-3:])[-40:]} {p.memory_info().rss / 2**30:.2f}")
        except psutil.Error:
            pass
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cwd", default=None)
    ap.add_argument("--every", type=float, default=0.1)
    ap.add_argument("--timeline", type=float, default=0.0,
                    help="also print the sum and each process's RSS every this many seconds")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, cwd=args.cwd)
    proc = psutil.Process(child.pid)
    peak = peak_n = 0
    last = 0.0
    while child.poll() is None:
        try:
            rss, n = tree_rss(proc)
        except psutil.Error:
            break
        peak, peak_n = max(peak, rss), max(peak_n, n)
        now = time.perf_counter() - t0
        if args.timeline and now - last >= args.timeline:
            last = now
            print(f"{now:7.1f} s {rss / 2**30:6.2f} GiB: " + ", ".join(_each(proc)), flush=True)
        time.sleep(args.every)
    rc = child.wait()
    print(f"peak summed RSS {peak / 2**30:.2f} GiB, at most {peak_n} processes, exit {rc}, "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
