"""The benchmark's pieces for the "lm" configuration and the four-card
training cell, on the CPU: ``work_lm.py``'s counts against hand counts
at a tiny size, the six new readers on synthetic span records, the
manifest's new entries, and both new drivers run end to end at small
sizes (``kimivl-greedy`` correct, its control and fault read above the
program; ``topdown-train-dp4`` on gloo ranks correct)."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
from conftest import TINY, small_cell

from benchmark import harness, spans, work_lm

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
BLOCK = dict(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
             num_hidden_layers=3, first_k_dense_replace=1,
             intermediate_size=96, n_routed_experts=8, num_experts_per_tok=2,
             n_shared_experts=1, moe_intermediate_size=24, vocab_size=256,
             rms_norm_eps=1e-5, rope_theta=800000,
             routed_scaling_factor=2.446, projector_hidden_size=32,
             start_id=1, torch_dtype="float32")
NEW = {"lm_prefill_ms.serve", "lm_step_ms.serve", "moe_roofline.serve",
       "mla_roofline.serve", "expert_skew.serve", "allreduce_ms.train"}
START, END, MS = 10**12, 10**12 + 100 * 10**6, 10**6


def test_mla_work_by_hand():
    # q 64 -> 96, kv_a 64 -> 40, o 64 -> 64; kv_b 32 -> 128
    proj = 2 * 10 * (64 * 96 + 64 * 40 + 64 * 64)
    f, b = work_lm.mla_work(BLOCK, 10, 55, False, "bfloat16")
    assert f == proj + 2 * 10 * 32 * 128 + 2 * 55 * 4 * (24 + 16)
    weights = 64 * 96 + 64 * 40 + 32 * 128 + 64 * 64
    assert b == 2 * weights + 2 * 2 * 10 * 64 + 2 * 10 * 40
    f, b = work_lm.mla_work(BLOCK, 3, 30, True, "bfloat16")
    assert f == (2 * 3 * (64 * 96 + 64 * 40 + 64 * 64)
                 + 2 * 3 * 4 * 32 * 32 + 2 * 30 * 4 * (40 + 32))
    assert b == 2 * weights + 2 * 2 * 3 * 64 + 2 * 30 * 40


def test_moe_work_by_hand():
    f, b = work_lm.moe_work(BLOCK, 10, 20, 5, "bfloat16")
    assert f == 2 * 10 * 64 * 8 + 20 * 6 * 64 * 24 + 10 * 6 * 64 * 24
    assert b == 2 * (5 * 3 * 64 * 24 + 3 * 64 * 24 + 8 * 64) + 2 * 2 * 10 * 64
    assert work_lm.least(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert work_lm.least(0, 3.35e12, "bfloat16") == pytest.approx(1.0)


def test_lm_flops_sum_the_passes():
    S, L, B = 5, 3, 2
    dense = 2 * 64 * 192 + 2 * 96 * 64

    def layers(rows, keys, decode):
        return (3 * work_lm.mla_work(BLOCK, rows, keys, decode,
                                     "bfloat16")[0]
                + rows * dense
                + 2 * work_lm.moe_work(BLOCK, rows, 2 * rows, 0,
                                       "bfloat16")[0])
    want = (2 * B * (S - 1) * (20 * 32 + 32 * 64) + layers(B * S, B * 15,
                                                            False)
            + layers(B, B * 6, True) + layers(B, B * 7, True)
            + 2 * B * L * 64 * 256)
    assert work_lm.lm_flops(BLOCK, 20, B, S, L) == want


def _rec(name, t0, t1, device_ms, parent=None, **counts):
    return SimpleNamespace(name=name, t0_ns=START + t0, t1_ns=START + t1,
                           device_ms=device_ms, nbytes=None, parent=parent,
                           counts=counts)


def _run(units=2):
    cell = SimpleNamespace(config={"lm": BLOCK},
                           model={"seq_length": 6})
    return harness.Run(cell=cell, attempted=units, failed=0, metrics={},
                       memory_peak_bytes=0, work={"dtype": "bfloat16"},
                       trace=harness.Trace([], [], [], START, END, units))


def _read(metric, run):
    return harness.load_module(harness.BENCH_DIR / "metrics" /
                               f"{metric}.py").read(run)


def test_the_readers_on_synthetic_spans(monkeypatch):
    pre, dec = _rec("lm_prefill", 1 * MS, 40 * MS, 30.0), \
        _rec("lm_decode", 41 * MS, 60 * MS, 10.0)
    recs = [pre, dec, _rec("lm_prefill", -5 * MS, 2 * MS, 99.0),
            _rec("mla", 2 * MS, 3 * MS, 2.0, pre, rows=10, key_rows=55),
            _rec("mla", 42 * MS, 43 * MS, 1.0, dec, rows=3, key_rows=30),
            _rec("moe", 4 * MS, 5 * MS, 4.0, pre, routed_rows=20,
                 experts_active=5, max_expert_rows=6),
            _rec("moe", 44 * MS, 45 * MS, 1.0, dec, routed_rows=6,
                 experts_active=4, max_expert_rows=3),
            _rec("allreduce", 50 * MS, 51 * MS, 3.0)]
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    run = _run()
    assert _read("lm_prefill_ms.serve", run) == pytest.approx(15.0)
    assert _read("lm_step_ms.serve", run) == pytest.approx(5.0 / 5)
    assert _read("allreduce_ms.train", run) == pytest.approx(1.5)
    assert _read("expert_skew.serve", run) == pytest.approx(
        (6 / (20 / 8) + 3 / (6 / 8)) / 2)
    least = (work_lm.least(*work_lm.moe_work(BLOCK, 10, 20, 5, "bfloat16"),
                           "bfloat16")
             + work_lm.least(*work_lm.moe_work(BLOCK, 3, 6, 4, "bfloat16"),
                             "bfloat16"))
    assert _read("moe_roofline.serve", run) == pytest.approx(
        100 * least / 5e-3)
    least = (work_lm.least(*work_lm.mla_work(BLOCK, 10, 55, False,
                                             "bfloat16"), "bfloat16")
             + work_lm.least(*work_lm.mla_work(BLOCK, 3, 30, True,
                                               "bfloat16"), "bfloat16"))
    assert _read("mla_roofline.serve", run) == pytest.approx(
        100 * least / 3e-3)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_a_reader_without_spans_or_counts_gives_none(metric, monkeypatch):
    """The parent program keeps none of these spans or counts."""
    monkeypatch.setattr(spans, "program_records", lambda: [])
    assert _read(metric, _run()) is None
    bare = [SimpleNamespace(name=n, t0_ns=START + MS, t1_ns=START + 2 * MS,
                            device_ms=1.0, nbytes=None, parent=None)
            for n in ("moe", "mla")]
    monkeypatch.setattr(spans, "program_records", lambda: bare)
    if metric in ("moe_roofline.serve", "mla_roofline.serve",
                  "expert_skew.serve"):
        assert _read(metric, _run()) is None


def test_the_manifest_holds_the_new_entries():
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    assert cells["kimivl-greedy"]["chips"] == 1
    assert cells["topdown-train-dp4"]["chips"] == 4
    assert sum(w["chips"] == 4 for w in cells.values()) <= 1
    metrics = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in NEW:
        m = metrics[name]
        assert set(m["workloads"]) <= set(cells)
        assert (harness.BENCH_DIR / "metrics" / f"{name}.py").is_file()
    for name in ("encode_ms.serve", "decode_ms.serve", "idle_share.serve",
                 "mfu.serve"):
        assert "kimivl-greedy" in metrics[name]["workloads"]
    assert "kimivl-greedy" not in metrics["k1_roofline"]["workloads"]
    conf = next(c for c in MANIFEST["configs"]
                if c["name"] == "gvd-kimivl-a3b-anet")
    assert conf["reduced"] == []
    data = json.loads((ROOT / conf["file"]).read_text())
    # the published config.json's keys at the top level and in the lm
    # block alike
    for key, value in data["lm"].items():
        if key not in ("projector_hidden_size", "start_id", "torch_dtype"):
            assert data[key] == value, key
    assert data["model"]["vocab_size"] == data["lm"]["vocab_size"]


def test_kimivl_cell_runs_and_its_control_and_fault_read_higher():
    cell = small_cell("kimivl-greedy", sizes={**TINY, "vocab_size": 256})
    cell.config["lm"] = BLOCK
    cell.traffic["judged_segments"] = 2
    result = harness.run_cell(cell, look=False)
    assert result["correct"], result["check"]
    driver = harness.load_module(harness.BENCH_DIR / "drivers" /
                                 "serve_closed_lm.py")
    read = driver.readings(cell)
    for mode in ("control", "fault"):
        assert read[mode]["max"]["logprob_err"] > \
            100 * read["program"]["max"]["logprob_err"]


def test_dp_cell_runs_on_gloo_ranks():
    cell = small_cell("topdown-train-dp4", batch=8)
    cell.traffic.update(grad_accum=2, ranks=2)
    cell.seconds = 0.5
    t = time.perf_counter()
    result = harness.run_cell(cell, look=False)
    assert result["correct"], result["check"]
    assert time.perf_counter() - t < 300
