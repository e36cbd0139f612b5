"""The per-layer metrics of the program's pinned staging ring
(``staged_share.serve``, ``staged_share.train``): each on a hand-made run
with synthetic span records, records outside the stretch or of another
name left out; None for a program whose spans carry no
``staged_nbytes``, without spans or without a trace; and the port's own
records read through the same path."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness, spans

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
START, END, MS = 10**12, 10**12 + 100 * 10**6, 10**6

# metric: the spans it reads
METRICS = {"staged_share.serve": ("h2d", "d2h"),
           "staged_share.train": ("h2d",)}


def _rec(name, t0, t1, nbytes, staged=None):
    r = SimpleNamespace(name=name, t0_ns=START + t0, t1_ns=START + t1,
                        nbytes=nbytes, device_ms=None)
    if staged is not None:
        r.staged_nbytes = staged
    return r


def _run(trace=True):
    t = harness.Trace([], [], [], START, END, 2) if trace else None
    return harness.Run(cell=None, attempted=2, failed=0, metrics={},
                       memory_peak_bytes=0, trace=t)


def _read(metric, run):
    path = harness.BENCH_DIR / "metrics" / f"{metric}.py"
    return harness.load_module(path).read(run)


def _records(staged=True):
    """In the stretch: an h2d of 600 bytes (450 staged) and a d2h of 400
    (400 staged); across its ends and of another name: left out."""
    s = (lambda n: n) if staged else (lambda n: None)
    return [_rec("h2d", 1 * MS, 5 * MS, 600, s(450)),
            _rec("d2h", 6 * MS, 8 * MS, 400, s(400)),
            _rec("h2d", -1 * MS, 2 * MS, 10**9, s(0)),
            _rec("d2h", 99 * MS, 101 * MS, 10**9, s(0)),
            _rec("encode", 10 * MS, 20 * MS, 10**9, s(0))]


@pytest.mark.parametrize("metric,want", [("staged_share.serve", 85.0),
                                         ("staged_share.train", 75.0)])
def test_a_share_sums_its_spans_in_the_stretch(metric, want, monkeypatch):
    monkeypatch.setattr(spans, "program_records", _records)
    assert _read(metric, _run()) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_a_share_without_the_field_or_spans_gives_none(metric, monkeypatch):
    # a program whose spans have no staged_nbytes (one without the ring)
    monkeypatch.setattr(spans, "program_records",
                        lambda: _records(staged=False))
    assert _read(metric, _run()) is None
    monkeypatch.setattr(spans, "program_records", _records)
    assert _read(metric, _run(trace=False)) is None
    monkeypatch.setattr(spans, "program_records", lambda: _records()[2:])
    assert _read(metric, _run()) is None
    monkeypatch.setattr(spans, "program_records",
                        lambda: [_rec("h2d", 1 * MS, 2 * MS, None, 0)])
    assert _read(metric, _run()) is None
    monkeypatch.undo()
    monkeypatch.setattr(spans, "PROGRAM_LOG", "json")
    assert _read(metric, _run()) is None


def test_the_ports_records_are_read():
    """The port's spans under a CPU profile: a copy to the CPU stages
    nothing (0%), a copy through a ring counted into its span all (100%)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from grounded_video_description_torch.data.staging import StagingRing
    from grounded_video_description_torch.utils.logging import span
    x = torch.arange(1000, dtype=torch.float32)
    ring = StagingRing("cpu", slot_bytes=1024, slots=2)
    run = _run()
    with profile(activities=[ProfilerActivity.CPU]):
        start = time.time_ns()
        with span("h2d", nbytes=x.nbytes):
            x.to("cpu")
        end = time.time_ns()
        with span("h2d", nbytes=x.nbytes):
            ring.to_device([x], [torch.float32])
        with span("d2h", nbytes=x.nbytes):
            ring.to_host([x], [torch.float32])
        last = time.time_ns()
    run.trace = harness.Trace([], [], [], start, end, 1)
    assert _read("staged_share.train", run) == 0.0
    run.trace = harness.Trace([], [], [], end, last, 1)
    assert _read("staged_share.serve", run) == 100.0
    assert _read("staged_share.train", run) == 100.0


def test_the_manifest_holds_the_shares():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    for metric in METRICS:
        m = entries[metric]
        assert (m["source"], m["layer"], m["unit"]) == (
            "program_span", "entry", "%")
        train = metric.endswith(".train")
        assert m["workloads"] == (
            ["topdown-train"] if train else
            ["topdown-greedy", "transformer-greedy", "topdown-beam3"])
        assert m["moves"] == ("train_segments_per_s" if train
                              else "captions_per_s")
