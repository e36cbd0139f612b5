"""The program's spans in a traced run: the records that the port's
``utils/logging.py::span`` keeps while a ``torch.profiler`` profile is
active (the harness's traced stretch is one), each with its name, its
host interval in ns on the profiler's clock (``t0_ns``, ``t1_ns``), the
bytes it moved (``nbytes``) and, on the card, its device interval
(``device_ms``, from the CUDA events recorded at its ends). A program
without spans has none, and the metrics that read them give None."""

from __future__ import annotations

import importlib
from typing import Callable, List, Optional

PROGRAM_LOG = "grounded_video_description_torch.utils.logging"


def program_records() -> list:
    """Every span record the program holds ([] where it keeps none)."""
    try:
        log = importlib.import_module(PROGRAM_LOG)
    except ImportError:
        return []
    read = getattr(log, "span_records", None)
    return list(read()) if read is not None else []


def records(run, name: str) -> List:
    """The records named ``name`` whose host interval lies within the run's
    traced stretch [start, end]."""
    t = run.trace
    if t is None or not t.units:
        return []
    return [r for r in program_records()
            if r.name == name and t.start <= r.t0_ns and r.t1_ns <= t.end]


def per_unit(run, name: str, value: Callable) -> Optional[float]:
    """The sum of ``value(record)`` over the stretch's records named
    ``name``, per traced batch or step; None without such records or where
    a record has no value."""
    values = [value(r) for r in records(run, name)]
    if not values or any(v is None for v in values):
        return None
    return sum(values) / run.trace.units


def device_ms(run, name: str) -> Optional[float]:
    """Device ms per batch or step between the ends of the spans ``name``."""
    return per_unit(run, name, lambda r: r.device_ms)


def host_ms(run, name: str) -> Optional[float]:
    """Host ms per batch or step inside the spans ``name``."""
    return per_unit(run, name, lambda r: (r.t1_ns - r.t0_ns) / 1e6)


def host_gbps(run, name: str) -> Optional[float]:
    """The bytes the spans ``name`` moved over their host seconds, in GB/s
    (10^9 bytes)."""
    recs = records(run, name)
    if not recs or any(r.nbytes is None for r in recs):
        return None
    ns = sum(r.t1_ns - r.t0_ns for r in recs)
    return sum(r.nbytes for r in recs) / ns if ns > 0 else None
