#!/usr/bin/env python3
"""Runs one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

and prints its result as the last line of standard output (see
``harness.py``)."""

import os
import sys
import time


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux: from its
    start time in /proc, to a clock tick); else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    STARTED = process_start()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark.harness import main
    sys.exit(main(started=STARTED))
