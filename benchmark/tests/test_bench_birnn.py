"""The per-layer metrics of K2's training route (``birnn_kernel_share.train``,
``birnn_ms.train``): each on a hand-made run with synthetic span records,
records outside the stretch or of another name left out; None for a
program whose spans carry no ``kernel`` count, without spans or without a
trace; the manifest's entries; and the port's own records of a BiGRU
trained on the CPU (the plain twin: ``kernel`` 0) read through the same
path."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness, spans

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
START, END, MS = 10**12, 10**12 + 100 * 10**6, 10**6
METRICS = ("birnn_kernel_share.train", "birnn_ms.train")


def _rec(name, t0, t1, device_ms=None, kernel=None):
    return SimpleNamespace(
        name=name, t0_ns=START + t0, t1_ns=START + t1, nbytes=None,
        device_ms=device_ms,
        counts={} if kernel is None else {"kernel": kernel})


def _run(trace=True, units=2):
    t = harness.Trace([], [], [], START, END, units) if trace else None
    return harness.Run(cell=None, attempted=units, failed=0, metrics={},
                       memory_peak_bytes=0, trace=t)


def _read(metric, run):
    path = harness.BENCH_DIR / "metrics" / f"{metric}.py"
    return harness.load_module(path).read(run)


def _records(kernel=(1, 1, 1, 0)):
    """In the stretch: four layers' ``birnn`` spans (2, 2, 3, 3 ms of
    device time), three ``birnn_bwd`` (4 ms each); across its ends, or of
    another name: left out."""
    recs = [_rec("birnn", (10 + 10 * i) * MS, (15 + 10 * i) * MS, d, k)
            for i, (d, k) in enumerate(zip((2.0, 2.0, 3.0, 3.0), kernel))]
    recs += [_rec("birnn_bwd", (60 + 5 * i) * MS, (62 + 5 * i) * MS, 4.0)
             for i in range(3)]
    recs += [_rec("birnn", -1 * MS, 2 * MS, 100.0, 0),
             _rec("birnn_bwd", 99 * MS, 101 * MS, 100.0),
             _rec("forward", 5 * MS, 90 * MS, 100.0, 0)]
    return recs


def test_the_share_and_the_time_sum_their_spans(monkeypatch):
    monkeypatch.setattr(spans, "program_records", _records)
    assert _read("birnn_kernel_share.train", _run()) == pytest.approx(75.0)
    # (2 + 2 + 3 + 3 + 3 x 4) ms over 2 steps
    assert _read("birnn_ms.train", _run()) == pytest.approx(11.0)
    assert _read("birnn_ms.train", _run(units=4)) == pytest.approx(5.5)
    monkeypatch.setattr(spans, "program_records",
                        lambda: [r for r in _records((1, 1, 1, 1))
                                 if r.name != "birnn_bwd"])
    assert _read("birnn_kernel_share.train", _run()) == pytest.approx(100.0)
    assert _read("birnn_ms.train", _run()) == pytest.approx(5.0)


@pytest.mark.parametrize("metric", METRICS)
def test_without_the_spans_or_their_count_a_reader_gives_none(metric,
                                                               monkeypatch):
    monkeypatch.setattr(spans, "program_records", _records)
    assert _read(metric, _run(trace=False)) is None
    assert _read(metric, _run(units=0)) is None
    monkeypatch.setattr(spans, "program_records",
                        lambda: [r for r in _records()
                                 if r.name != "birnn"])
    assert _read(metric, _run()) is None
    monkeypatch.undo()
    monkeypatch.setattr(spans, "PROGRAM_LOG", "json")
    assert _read(metric, _run()) is None


def test_a_birnn_span_without_its_count_gives_no_share(monkeypatch):
    monkeypatch.setattr(spans, "program_records",
                        lambda: [_rec("birnn", 10 * MS, 20 * MS, 1.0)])
    assert _read("birnn_kernel_share.train", _run()) is None


def test_the_manifest_holds_the_route_metrics():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    for metric in METRICS:
        m = entries[metric]
        assert m["workloads"] == ["topdown-train", "topdown-train-dp4"]
        assert m["moves"] == "train_segments_per_s"
        assert m["layer"] == "kernels"
        assert (harness.BENCH_DIR / "metrics" / f"{metric}.py").is_file()
    assert entries["birnn_kernel_share.train"]["source"] == "program_counter"
    assert entries["birnn_ms.train"]["source"] == "program_span"


def test_the_ports_records_are_read():
    """A BiGRU trained on the CPU under a CPU profile: its two layers are
    ``birnn`` spans with ``kernel`` 0 (the plain twin), so the share reads
    0; off the card they have no device interval."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from grounded_video_description_torch.nn import core
    rnn = core.BiRNNParams(6, 4, 2, "bigru")
    rnn.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 6, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]):
        start = time.time_ns()
        core.birnn(rnn, x, use_kernel=True, train=True).sum().backward()
        end = time.time_ns()
    run = _run()
    run.trace = harness.Trace([], [], [], start, end, 1)
    assert _read("birnn_kernel_share.train", run) == 0.0
    assert _read("birnn_ms.train", run) is None
