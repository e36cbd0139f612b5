"""Metrics logging and profiling of the port.

The port's copy of ``grounded_video_description_tpu/utils/logging.py``:
``MetricLogger``, an append-only JSONL sink every run can tail, with an
optional TensorBoard scalar mirror through ``torch.utils.tensorboard``
(imported when first written; if that import fails, the logger says the
sink is unavailable and keeps the JSONL sink, as the JAX package does),
and ``ProfilerHooks``, a ``torch.profiler`` trace of a window of steps
where the JAX package takes ``jax.profiler``.

``span`` names the program's parts inside such a trace: a span is
recorded exactly while a ``torch.profiler`` profile is active in the
process (``ProfilerHooks``' window, or any other profile), and otherwise
costs one test of the profiler's flag.  A recorded span shows in the
profile's Chrome trace as a ``record_function`` annotation and leaves a
``SpanRecord`` (host interval on the profiler's clock, bytes moved, and
on a CUDA device its device interval) that ``span_records()`` returns.
``span_count`` adds to the counts of the innermost span recording: the
bytes a copy moved through the staging ring and the times it waited for
a slot (``data/staging.py``).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

import torch


class MetricLogger:
    """Append-only JSONL metrics sink (timestamps added), with an
    optional TensorBoard scalar mirror."""

    def __init__(self, path: Optional[str] = None, echo: bool = False,
                 tensorboard_dir: Optional[str] = None):
        self.path = path
        self.echo = echo
        self.history = []
        self._tb = None
        self._tb_dir = tensorboard_dir
        self._tb_step = 0

    def _tb_writer(self):
        if self._tb is None and self._tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(self._tb_dir)
            except Exception as e:  # tensorboard not installed: JSONL only
                print(f"[logging] tensorboard sink unavailable: {e}")
                self._tb_dir = None
        return self._tb

    def log(self, metrics: Dict):
        rec = {"ts": time.time(),
               **{k: (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}}
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        tb = self._tb_writer()
        if tb is not None:
            step = int(rec.get("step", self._tb_step))
            self._tb_step = max(self._tb_step, step) + 1
            for k, v in rec.items():
                if k not in ("ts", "step") and isinstance(v, float):
                    tb.add_scalar(k, v, step)
        if self.echo:
            print(json.dumps(rec))

    def close(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()


class ProfilerHooks:
    """A ``torch.profiler`` trace of a window of steps, written as a
    Chrome trace under ``log_dir``.

    Usage:
        prof = ProfilerHooks("/tmp/trace", start_step=10, num_steps=5,
                             device=model_device)
        for step in ...:
            prof.maybe_start(step)
            ... run step ...
            prof.maybe_stop(step)

    ``maybe_start(step)`` opens the window at ``start_step`` and
    ``maybe_stop(step)`` closes it at ``start_step + num_steps``, as the
    JAX package's hooks do.  The trace holds CPU activity, and CUDA
    activity when ``device`` is a CUDA device; a CUDA trace without
    kernel events raises, since a trace that silently lost the device
    says nothing of it.  ``path`` names the file written."""

    def __init__(self, log_dir: str, start_step: int = 10,
                 num_steps: int = 5, device=None):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.device = torch.device(device or "cpu")
        self.path: Optional[str] = None
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def maybe_start(self, step: int):
        if step == self.start_step and not self.active:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def maybe_stop(self, step: int):
        if step == self.stop_step and self.active:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(
                self.log_dir,
                f"trace_steps_{self.start_step}-{self.stop_step - 1}.json")
            prof.export_chrome_trace(path)
            self.path = path
            if self.device.type == "cuda" and not kernel_names(path):
                raise RuntimeError(
                    f"the profile of steps {self.start_step}.."
                    f"{self.stop_step - 1} on {self.device} holds no CUDA "
                    f"kernel (CUPTI tracing unavailable?): {path}")


def trace_events(path: str, cat: str) -> List[Dict]:
    """The events of category ``cat`` in a Chrome trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events if e.get("cat") == cat]


def kernel_names(path: str) -> List[str]:
    """The names of the device kernels a Chrome trace holds, in order of
    first launch."""
    return list(dict.fromkeys(e.get("name", "")
                              for e in trace_events(path, "kernel")))


# --------------------------------------------------------------------- #
# spans
# --------------------------------------------------------------------- #

SPAN_RECORDS = 4096     # the buffer's bound; the oldest records go first

_profiler_enabled = torch.autograd._profiler_enabled
_records: Deque["SpanRecord"] = collections.deque(maxlen=SPAN_RECORDS)
_open: List["SpanRecord"] = []  # the recording spans open, innermost last


class SpanRecord:
    """One recorded span: ``name``, the enclosing span's record
    (``parent``, None at a root), the host interval ``t0_ns`` / ``t1_ns``
    on ``time.time_ns()`` (the clock ``torch.profiler`` stamps its events
    on), the bytes it moved where its caller gives them (``nbytes``), of
    those the bytes that went through the staging ring
    (``staged_nbytes``) and the times the host found a ring slot still in
    flight (``ring_waits``), both summed by ``span_count``, and on a CUDA
    device the pair of events recorded on the current stream at its entry
    and exit.  ``counts``: the other named counts ``span_count`` added,
    each an int (a count given as a device tensor is read at the first
    access, after the span)."""

    __slots__ = ("name", "parent", "t0_ns", "t1_ns", "nbytes",
                 "staged_nbytes", "ring_waits", "_counts", "_events",
                 "_device_ms")

    def __init__(self, name: str, parent: Optional["SpanRecord"]):
        self.name = name
        self.parent = parent
        self.t0_ns = self.t1_ns = 0
        self.nbytes: Optional[int] = None
        self.staged_nbytes = 0
        self.ring_waits = 0
        self._counts: Dict[str, object] = {}
        self._events: Optional[Tuple[torch.cuda.Event, ...]] = None
        self._device_ms: Optional[float] = None

    @property
    def counts(self) -> Dict[str, int]:
        self._counts = {k: int(v) for k, v in self._counts.items()}
        return dict(self._counts)

    @property
    def device_ms(self) -> Optional[float]:
        """The device interval between the span's entry and exit, in ms
        (None off a CUDA device); the first read waits for the exit
        event."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


class span:
    """``with span(name):`` names a part of the program in a profile.

    With no ``torch.profiler`` profile active, entering it tests the
    profiler's flag and does nothing else.  While one is active it enters
    ``torch.profiler.record_function(name)``, so that the span shows in
    the Chrome trace; on a CUDA device it records an event pair on the
    current stream; and at its exit it appends a ``SpanRecord`` to the
    bounded buffer ``span_records()`` reads, its parent the innermost
    recording span open around it.  ``nbytes``: the bytes the span moves,
    or a function of no arguments that gives them, called at a clean exit
    and only while recording."""

    __slots__ = ("name", "nbytes", "_rec", "_annotation")

    def __init__(self, name: str, *,
                 nbytes: Union[None, int, Callable[[], int]] = None):
        self.name = name
        self.nbytes = nbytes
        self._rec: Optional[SpanRecord] = None

    def __enter__(self) -> "span":
        if not _profiler_enabled():
            return self
        rec = SpanRecord(self.name, _open[-1] if _open else None)
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        if torch.cuda.is_initialized():
            rec._events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            rec._events[0].record()
        _open.append(rec)
        self._rec = rec
        rec.t0_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self._rec
        if rec is None:
            return False
        rec.t1_ns = time.time_ns()
        if rec._events is not None:
            rec._events[1].record()
        self._rec = None
        _open.pop()
        if exc_type is None:
            n = self.nbytes
            rec.nbytes = n() if callable(n) else n
        self._annotation.__exit__(exc_type, exc, tb)
        _records.append(rec)
        return False


def span_count(staged_nbytes: int = 0, ring_waits: int = 0, **counts):
    """Adds ``staged_nbytes``, ``ring_waits`` and the named ``counts``
    (ints or 0-d device tensors, read after the span) to the innermost
    span that is recording (nothing where none is)."""
    if _open:
        rec = _open[-1]
        rec.staged_nbytes += staged_nbytes
        rec.ring_waits += ring_waits
        for k, v in counts.items():
            rec._counts[k] = rec._counts[k] + v if k in rec._counts else v


def recording() -> bool:
    """Whether a span is recording: what a count costs is paid only
    then."""
    return bool(_open)


def span_records() -> List[SpanRecord]:
    """The recorded spans still in the buffer, oldest first (the program
    never clears it)."""
    return list(_records)
