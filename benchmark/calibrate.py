#!/usr/bin/env python3
"""Readings that a cell's limits are set from: for each seed, the numbers
that decide ``correct`` for the program (the lower readings) and for the
control, the plain reference computed with its products in TF32 in the
program's place (the upper readings), at the cell's own sizes and over
as much work as a run judges; a train cell adds a planted fault (its
driver's ``readings``).

    python3 benchmark/calibrate.py --workload NAME --seed N [--seed N ...]
        [--controls K] [--out DIR]

One process reads every seed. The benchmark's own runs never run the
control. Prints one JSON line per seed and, with ``--out``, appends them
to DIR/calibrate-<workload>.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--controls", type=int, default=1000,
                   help="run the control (and a train cell's fault) on the "
                        "first this many seeds only")
    p.add_argument("--out")
    args = p.parse_args(argv)
    harness.cache_dirs()
    lines = []
    for n, seed in enumerate(args.seed):
        cell = harness.load_cell(args.workload, seed, 0.0, False)
        harness.look_for_chips(cell.chips)
        driver = harness.load_module(harness.BENCH_DIR / "drivers" /
                                     f"{cell.traffic['driver']}.py")
        t0 = time.perf_counter()
        line = {"seed": seed,
                **driver.readings(cell, control=n < args.controls)}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(Path(args.out) / f"calibrate-{args.workload}.jsonl",
                  "a") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
