"""The yardstick's arithmetic on the CPU: the traffic's shapes and
determinism, the operation and byte counts against hand counts and
against a FLOP counter run over the reference, the busy-interval union
and the per-layer readers on a made-up trace."""

import math

import numpy as np
import pytest
import torch
from conftest import TINY, small_cell

from benchmark import harness, traffic, work
from benchmark.reference.gvd import GVDReference, Ops, tf32_round
from benchmark.weights import draw_weights

FLAGSHIP = harness.load_cell("topdown-greedy", 1, 1.0, False).model


def test_traffic_shapes_at_the_published_sizes():
    g = torch.Generator().manual_seed(3)
    m = dict(FLAGSHIP, t_attn_size=8)     # the frame axis cut for memory
    b = traffic.draw_batch(m, 2, g, "cpu")
    R, K, L = 1000, m["max_gt_box"], 20
    want = {"seg_feat": (2, 8, 3072), "input_seq": (2, 1, L + 1, 4),
            "gt_seq": (2, 10, L), "num": (2, 7), "ppls": (2, R, 7),
            "gt_boxes": (2, K, 6), "mask_boxes": (2, 1, K, L + 1),
            "ppls_feat": (2, R, 2048), "frm_mask": (2, R, K),
            "sample_idx": (2, 2), "pnt_mask": (2, R + 1)}
    assert {k: tuple(v.shape) for k, v in b.items()} == want
    assert b["input_seq"].dtype == torch.long
    assert b["frm_mask"].dtype == b["pnt_mask"].dtype == torch.bool
    words = b["gt_seq"][:, 0]
    assert int(words.max()) <= m["vocab_size"] - 2   # no UNK
    n_box = b["num"][:, 2].long()
    for i in range(2):
        k = min(int(n_box[i]), int((words[i] > 0).sum()))
        vis = b["input_seq"][i, 0, :, 1]
        assert int(vis.sum()) == k                   # one word per box
        assert not b["mask_boxes"][i, 0, :k].all(-1).any()


def test_traffic_is_the_seeds():
    cell = small_cell("topdown-greedy")
    a = traffic.host_batches(cell.model, cell.traffic, 2**31 + 11, "cpu")
    b = traffic.host_batches(cell.model, cell.traffic, 2**31 + 11, "cpu")
    c = traffic.host_batches(cell.model, cell.traffic, 2**31 + 12, "cpu")
    assert len(a) == cell.traffic["distinct_batches"]
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a[0]["seg_feat"], c[0]["seg_feat"])
    assert not np.array_equal(a[0]["seg_feat"], a[1]["seg_feat"])


def test_weights_are_the_seeds():
    cell = small_cell("transformer-greedy")
    w1 = draw_weights(cell.config, 5, "cpu")
    w2 = draw_weights(cell.config, 5, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    lin = w1["ctx2pool.weight"]
    assert float(lin.abs().max()) <= 1 / math.sqrt(lin.shape[1])
    assert torch.equal(w1["core.att_lstm.bias_hh"],
                       torch.zeros_like(w1["core.att_lstm.bias_hh"]))
    scaled = w1["cap_model.decoder.layers.0.selfattn.layer.wq.weight"]
    assert float(scaled.abs().max()) > 1 / math.sqrt(scaled.shape[1])


def test_encoder_layer_flops_by_hand():
    # (B, R, D, F) = (1, 2, 4, 2): QKV and Wo 4 x 2 rows x 16 MACs, FFN
    # 2 x 2 x 8 MACs, QK^T and PV 2 x 2 x 2 x 4 MACs, 2 ops a MAC
    assert work.encoder_layer_flops(1, 2, 4, 2) == 2 * (128 + 32 + 32)
    assert work.encoder_layer_bytes(1, 2, 4, 2, "float32") == \
        2 * 8 * 4 + 4 * (64 + 16 + 2 + 4 + 16)


def test_k1_work_at_the_flagship():
    flops, n_bytes = work.k1_work(FLAGSHIP, 100, "float32")
    assert flops == 2 * (2 * 100 * 1000 * (4 * 1024 ** 2 + 2 * 1024 * 512)
                         + 4 * 100 * 1000 ** 2 * 1024)
    # the encoder is bound by its operations: ~5.9 ms at 495 TFLOP/s
    least = work.least_seconds(flops, n_bytes, "float32")
    assert least == pytest.approx(flops / 495e12)
    assert 5.8e-3 < least < 6.0e-3


def test_encode_flops_count_the_references_products():
    from torch.utils.flop_counter import FlopCounterMode
    cell = small_cell("topdown-greedy")
    ref = GVDReference(cell.model)
    ref.load_state_dict(draw_weights(cell.config, 1, "cpu"))
    batch = traffic.draw_batch(cell.model, 3, torch.Generator().manual_seed(
        1), "cpu")
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        ref.encode(Ops(), batch)
    assert counter.get_total_flops() == work.encode_flops(cell.model, 3)


def test_decode_flops_by_hand():
    m = dict(TINY, att_model="topdown")
    E, H, A, T, R, V = 32, 64, 32, 16, 20, 50
    step = (2 * 2 * (E + H) * 4 * H + 2 * 2 * 2 * H * 4 * H
            + 2 * 2 * 2 * H * A + 2 * (T + R) * (3 * A + 2 * H)
            + 2 * 2 * H * V)
    assert work.topdown_decode_flops(m, 2, 2, 3) == \
        3 * step + 2 * 2 * H * 4 * H
    # transformer: keys 16 then 20, d 64, steps 2, batch 1
    d, keys = 64, (16, 20)
    want = sum(2 * 2 * k * d * d + sum(
        6 * 2 * d * d + 4 * (t + 1) * d + 4 * k * d + 2 * 2 * d * (d // 2)
        for t in range(2)) for k in keys) + 2 * 2 * d * V
    assert work.transformer_decode_flops(m, 1, 2) == want


def test_busy_union():
    assert harness.busy_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert harness.busy_ns([]) == 0


def _trace():
    kernels = [("gemm_tf32x3_kernel", 100, 300), ("birnn_cluster_kernel",
                                                  300, 400),
               ("fwd_kernel", 500, 600), ("decode_kernel", 700, 900)]
    copies = [("HtoD", 0, 100), ("DtoH", 900, 950)]
    host = [("cudaMemcpyAsync", 0, 120), ("cudaStreamSynchronize", 590, 700)]
    return harness.Trace(kernels, copies, host, 0, 1000, 2)


def _run(trace):
    cell = small_cell("topdown-greedy")
    cell.trace = True
    return harness.Run(cell=cell, attempted=4, failed=0,
                       metrics={}, memory_peak_bytes=0, trace=trace,
                       window={"seconds": 2.0, "units": 4, "p90_ms": 500.0},
                       work={"flops_per_unit": 1e12, "dtype": "float32",
                             "batch": 100})


def _reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py")


def test_readers_on_a_made_up_trace():
    run = _run(_trace())
    # kernels busy 600 of 1000 ns
    assert _reader("idle_share.serve").read(run) == pytest.approx(40.0)
    assert _reader("h2d_ms.serve").read(run) == pytest.approx(100 / 1e6 / 2)
    assert _reader("launches_per_batch.serve").read(run) == 2.0
    assert _reader("batch_p90_ms.serve").read(run) == 500.0
    assert _reader("mfu.serve").read(run) == pytest.approx(
        100 * 4e12 / (2.0 * 495e12))
    flops, n_bytes = work.k1_work(run.cell.model, 100, "float32")
    assert _reader("k1_roofline").read(run) == pytest.approx(
        100 * work.least_seconds(flops, n_bytes, "float32") / (300e-9 / 2))


def test_readers_find_nothing_in_an_empty_trace():
    run = _run(harness.Trace([], [], [], 0, 1000, 2))
    for name in ("idle_share.serve", "h2d_ms.serve",
                 "launches_per_batch.serve", "k1_roofline"):
        assert _reader(name).read(run) is None


def test_breakdown_names_gaps_by_the_host_call():
    b = harness.breakdown(_trace())
    assert b["device_ops"][0] == ["gemm_tf32x3_kernel", 200e-9]
    # idle 400 .. 500 (no runtime call), 600 .. 700 (in a synchronize),
    # 950 .. 1000
    assert sorted((round(t * 1e9), n) for n, t in b["idle_gaps"]) == [
        (50, "host"), (100, "cudaStreamSynchronize"), (100, "host")]
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12,
                      1 + 3 * 2 ** -11, -(1 + 2 ** -12)])
    assert tf32_round(x).tolist() == [1.0, 1 + 2 ** -10, 1.0, 1.0,
                                      1 + 2 ** -9, -1.0]
