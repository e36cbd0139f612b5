"""The benchmark's harness: runs one cell of ``BENCHMARK.json`` once and
prints its one JSON line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own, found by name:

- ``configs/<config>.json``: the model block (the program's config
  fields), the dtype, the kernel flags of serving and training;
- ``workloads/<traffic>.json``: the mix's parameters, and ``driver``,
  the name of the file under ``drivers/`` that runs it;
- ``checks/<cell>.json``: the numbers that decide ``correct`` and their
  limits, with the readings each limit was set from;
- ``metrics/<metric>.py``: a ``read(run)`` that takes one per-layer
  metric from the traced run (``Run``), or None where there is nothing
  to read.

A driver's ``run(cell)`` makes the program's inputs and weights from the
seed, warms up, measures for ``--seconds``, optionally traces a short
steady stretch after the window, frees the program and judges what the
window served against the plain reference under ``reference/``. It
returns a ``Run``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# what the process that prints the result may not hold once the window
# has closed (whole top-level module names)
FORBIDDEN = ("jax", "jaxlib", "flax", "grounded_video_description_tpu")


def load_module(path: Path):
    """A module from a file of the benchmark (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell of the manifest, with its files read."""
    name: str
    chips: int
    config: Dict            # configs/<config>.json
    traffic: Dict           # workloads/<traffic>.json
    checks: Dict            # checks/<cell>.json
    end_to_end: List[Dict]  # the manifest's metrics that this cell reports
    per_layer: List[Dict]
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    started: float = 0.0    # perf_counter at the process's start

    @property
    def model(self) -> Dict:
        return self.config["model"]


def load_cell(name: str, seed: int, seconds: float, trace: bool,
              root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    try:
        wl = next(w for w in manifest["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == wl["config"])

    def applies(metric):
        return name in metric.get("workloads", [name])

    bench = root / "benchmark"
    return Cell(
        name=name, chips=wl["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench / "workloads" /
                            f"{wl['traffic']}.json").read_text()),
        checks=json.loads((bench / "checks" / f"{name}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
        per_layer=[m for m in manifest["per_layer"] if applies(m)],
        seed=seed, seconds=seconds, trace=trace)


# ------------------------------------------------------------------ #
# what a run hands back, and the trace it read
# ------------------------------------------------------------------ #

@dataclass
class Trace:
    """The device operations and host runtime calls of a profiled
    stretch, in ns on one clock, and the stretch's bounds."""
    kernels: List[Tuple[str, int, int]]
    copies: List[Tuple[str, int, int]]      # (kind "HtoD"..., start, end)
    host: List[Tuple[str, int, int]]        # CUDA runtime calls
    start: int
    end: int
    units: int                              # batches or steps traced

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9


@dataclass
class Run:
    """What a driver measured: the window's counts and times, the traced
    stretch (``--trace 1``), and the judged numbers."""
    cell: Cell
    attempted: int
    failed: int
    metrics: Dict[str, float]               # end-to-end, by name
    memory_peak_bytes: int
    work: Dict[str, float] = field(default_factory=dict)
    window: Dict[str, float] = field(default_factory=dict)
    trace: Optional[Trace] = None
    numbers: Dict[str, float] = field(default_factory=dict)


def kernel_name(full: str) -> str:
    """The bare function name of a demangled kernel signature: template
    arguments, the argument list, the return type and namespaces
    dropped."""
    full = full.replace("(anonymous namespace)::", "")
    depth, head = 0, []
    for ch in full:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            if ch == "(":
                break
            head.append(ch)
    words = "".join(head).split()
    return words[-1].split("::")[-1] if words else full


def busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals (profile_step.py's
    ``busy_us``)."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def read_trace(prof, start_ns: int, end_ns: int, units: int) -> Trace:
    """The kernels, copies and runtime calls of a ``torch.profiler``
    profile (read from its Kineto results, without building the
    profiler's event tree), clipped to the stretch [start_ns, end_ns] of
    the profiler's clock."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, copies, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.end_ns()
        if b < start_ns or a > end_ns:
            continue
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith("Memcpy"):
                copies.append((name.split()[1], a, b))
            elif not name.startswith("Memset"):
                kernels.append((kernel_name(name), a, b))
        elif name.startswith(("cuda", "cu")):
            host.append((name, a, b))
    return Trace(kernels, copies, host, start_ns, end_ns, units)


def profiled(fn: Callable[[], None], units: int) -> Trace:
    """Runs ``fn`` (``units`` batches or steps, ending in a synchronize)
    under ``torch.profiler`` with CUDA activity only (the CPU activity of
    a train step's ~300k launches takes minutes to post-process) and
    reads its trace. The stretch is the host clock around ``fn``, taken
    on the profiler's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.time_ns()
        fn()
        torch.cuda.synchronize()
        end = time.time_ns()
    # Kineto stamps events on the same wall clock (ns since the epoch)
    return read_trace(prof, start, end, units)


def breakdown(trace: Trace) -> Dict[str, list]:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the device, each named by the runtime call the host was
    in for most of the gap (else "host")."""
    by_name: Dict[str, int] = {}
    for name, a, b in trace.kernels + [(f"Memcpy {k}", a, b)
                                       for k, a, b in trace.copies]:
        by_name[name] = by_name.get(name, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = sorted((a, b) for _, a, b in trace.kernels
                   + [(k, a, b) for k, a, b in trace.copies])
    gaps, cursor = [], trace.start
    for a, b in spans:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if trace.end > cursor:
        gaps.append((cursor, trace.end))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for g0, g1 in gaps:
        cover: Dict[str, int] = {}
        for name, a, b in trace.host:
            o = min(b, g1) - max(a, g0)
            if o > 0:
                cover[name] = cover.get(name, 0) + o
        label = max(cover, key=cover.get) if cover and max(
            cover.values()) * 2 >= g1 - g0 else "host"
        named.append([label, (g1 - g0) / 1e9])
    return {"device_ops": [[n, t / 1e9] for n, t in ops],
            "idle_gaps": named}


# ------------------------------------------------------------------ #
# the run
# ------------------------------------------------------------------ #

def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's nvcc build is ``grounded_video_description_torch/
    _build/``, fixed by the program)."""
    cache = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def look_for_chips(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def judge(run: Run) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    limits = run.cell.checks["numbers"]
    if set(limits) != set(run.numbers):
        raise RuntimeError(f"compared {sorted(run.numbers)}, the cell's "
                           f"checks hold {sorted(limits)}")
    check = {k: {"value": run.numbers[k], "limit": limits[k]["limit"]}
             for k in sorted(limits)}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in check.values())
    return ok, check


def result_of(run: Run) -> Dict:
    """The run's JSON line."""
    import torch
    cell = run.cell
    ok, check = judge(run)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if cell.trace:
        metrics = {}
        for m in cell.per_layer:
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in run.metrics.items()}
    on_card = cell.device == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name() if on_card else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": ok, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if cell.trace and run.trace is not None:
        t = run.trace
        device["busy_s"] = busy_ns(
            [(a, b) for _, a, b in t.kernels + t.copies]) / 1e9
        device["window_s"] = t.window_s
        out["breakdown"] = breakdown(t)
    out["check"] = check
    return out


def run_cell(cell: Cell, *, look: bool = True) -> Dict:
    """Runs the cell's driver and returns the result line (without
    printing). ``look`` False skips the look for a chip (the CPU tests
    drive a run at a small size on the CPU)."""
    if look:
        look_for_chips(cell.chips)
    driver = load_module(BENCH_DIR / "drivers" /
                         f"{cell.traffic['driver']}.py")
    run = driver.run(cell)
    return result_of(run)


def main(argv=None, started: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    cell = load_cell(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    cell.started = started if started is not None else time.perf_counter()
    print(f"card: {power_limit()}", file=sys.stderr, flush=True)
    result = run_cell(cell)
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)}: the benchmark "
              "measures the PyTorch port alone", file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
