"""The per-layer metrics that read the program's spans
(``benchmark/spans.py``): each on a hand-made run, with a synthetic trace
and synthetic span records; records outside the traced stretch or of
another name left out, the sum divided by the batches or steps traced,
None without spans (a program that keeps none, or no trace), and the
port's own records read through the same path."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness, spans

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

# metric: (the span it reads, what it takes of each record)
METRICS = {
    "h2d_host_gbps.serve": ("h2d", "gbps"),
    "encode_ms.serve": ("encode", "device"),
    "decode_ms.serve": ("decode", "device"),
    "d2h_ms.serve": ("d2h", "device"),
    "h2d_host_gbps.train": ("h2d", "gbps"),
    "fwd_host_ms.train": ("forward", "host"),
    "bwd_host_ms.train": ("backward", "host"),
    "optim_host_ms.train": ("optimizer", "host"),
}
START, END, UNITS = 10**12, 10**12 + 100 * 10**6, 2
MS = 10**6


def _rec(name, t0, t1, nbytes=None, device_ms=None):
    return SimpleNamespace(name=name, t0_ns=START + t0, t1_ns=START + t1,
                           nbytes=nbytes, device_ms=device_ms)


def _run(trace=True, units=UNITS):
    t = harness.Trace([], [], [], START, END, units) if trace else None
    return harness.Run(cell=None, attempted=units, failed=0, metrics={},
                       memory_peak_bytes=0, trace=t)


def _read(metric, run):
    path = harness.BENCH_DIR / "metrics" / f"{metric}.py"
    return harness.load_module(path).read(run)


def _records(name):
    """Two records of ``name`` in the stretch (4 ms and 8 ms of host time,
    3 and 5 ms of device time, 8 MB and 16 MB), one across each end of it,
    and one of another name inside it."""
    return [_rec(name, 1 * MS, 5 * MS, 8 * 10**6, 3.0),
            _rec(name, 20 * MS, 28 * MS, 16 * 10**6, 5.0),
            _rec(name, -1 * MS, 2 * MS, 10**9, 100.0),
            _rec(name, 99 * MS, 101 * MS, 10**9, 100.0),
            _rec("other", 30 * MS, 90 * MS, 10**9, 100.0)]


# host: (4 + 8) ms / 2 units; device: (3 + 5) ms / 2; GB/s: 24 MB / 12 ms
EXPECTED = {"host": 6.0, "device": 4.0, "gbps": 2.0}


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_a_reader_sums_its_spans_in_the_stretch_per_unit(metric,
                                                         monkeypatch):
    name, kind = METRICS[metric]
    monkeypatch.setattr(spans, "program_records", lambda: _records(name))
    assert _read(metric, _run()) == pytest.approx(EXPECTED[kind])
    if kind != "gbps":      # a rate does not depend on the units
        assert _read(metric, _run(units=4)) == pytest.approx(
            EXPECTED[kind] / 2)


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_a_reader_without_spans_gives_none(metric, monkeypatch):
    name, kind = METRICS[metric]
    monkeypatch.setattr(spans, "program_records", lambda: _records(name))
    assert _read(metric, _run(trace=False)) is None
    assert _read(metric, _run(units=0)) is None
    monkeypatch.setattr(spans, "program_records",
                        lambda: _records(name)[2:])
    assert _read(metric, _run()) is None
    # a program that keeps no spans (no span_records to read)
    monkeypatch.undo()
    monkeypatch.setattr(spans, "PROGRAM_LOG", "json")
    assert spans.program_records() == []
    assert _read(metric, _run()) is None


def test_a_record_without_its_value_gives_none(monkeypatch):
    """Off the card a span has no device interval; a span the program gave
    no bytes has no rate."""
    recs = [_rec("encode", 1 * MS, 2 * MS), _rec("h2d", 1 * MS, 2 * MS)]
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    assert _read("encode_ms.serve", _run()) is None
    assert _read("h2d_host_gbps.serve", _run()) is None
    assert _read("fwd_host_ms.train", _run()) is None


def test_the_ports_records_are_read():
    """The port's ``span`` under a CPU profile: its records reach the
    readers through ``program_records``, clipped to the stretch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from grounded_video_description_torch.utils.logging import span
    with profile(activities=[ProfilerActivity.CPU]):
        start = time.time_ns()
        with span("forward"):
            time.sleep(0.002)
        with span("h2d", nbytes=3 * 10**6):
            time.sleep(0.002)
        end = time.time_ns()
        with span("forward"):
            pass
    run = _run()
    run.trace = harness.Trace([], [], [], start, end, 1)
    assert 2.0 <= _read("fwd_host_ms.train", run) < (end - start) / 1e6
    gbps = _read("h2d_host_gbps.train", run)
    assert 0 < gbps <= 3 * 10**6 / 2e6
    assert _read("encode_ms.serve", run) is None     # none in the stretch
    assert torch.autograd._profiler_enabled() is False


def test_the_manifest_holds_the_span_metrics():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    serve = ["topdown-greedy", "transformer-greedy", "topdown-beam3"]
    for metric in METRICS:
        m = entries[metric]
        assert m["source"] == "program_span"
        train = metric.endswith(".train")
        assert m["workloads"] == (["topdown-train"] if train else serve)
        assert m["moves"] == ("train_segments_per_s" if train
                              else "captions_per_s")
        assert (harness.BENCH_DIR / "metrics" / f"{metric}.py").is_file()
