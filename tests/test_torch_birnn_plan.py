"""PyTorch port, K2's launch plan (ops/kernels/birnn.py::birnn_plan), on
the CPU: the clusters, batch tiles, hidden-unit shares, resident rows of
W_hh and shared memory that csrc/birnn.cu is launched with.  The kernel
itself runs only on the card (tests/test_torch_cuda.py); here the plan is
held to what the kernel needs, and a plain emulation of the kernel's
partition of the work (units per block, K-splits, resident and streamed
rows, staged chunks of h) is held against the plain twin."""

import numpy as np
import pytest
import torch

from grounded_video_description_torch.ops.kernels import birnn as kb
from grounded_video_description_torch.ops.kernels.birnn import (
    birnn_plan, birnn_recurrence_plain)

DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("max_clusters", [4, 7, 8])
@pytest.mark.parametrize("H", [40, 512, 520])
@pytest.mark.parametrize("B", [7, 100])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["bigru", "bilstm"])
def test_plan_covers_fits_and_is_resident(mode, dtype, B, H, max_clusters):
    p = birnn_plan(B, H, mode, dtype, max_clusters)
    # every hidden unit in exactly one block, every row in exactly one tile
    units = [j for c in range(p.C) for j in p.units(c)]
    assert units == list(range(H))
    rows = [b for t in range(p.n_tiles) for b in p.rows(t)]
    assert rows == list(range(B))
    assert all(len(p.rows(t)) > 0 for t in range(p.n_tiles))
    # the kernel's own constraints (csrc/birnn.cu prepare)
    assert p.C in (1, 2, 4, 8, 16) and p.Up % 4 == 0 and p.Up <= 64
    assert p.C * p.Up >= H
    if p.route == "mma":
        # bf16 on the tensor cores: W_hh and the tile's h whole
        assert dtype == torch.bfloat16 and p.streamed_rows == 0
        assert p.KW == p.KR == -(-p.C * p.Up // 64) * 64
        assert p.rpt == -(-p.tile // 16) <= 4
        assert p.tile * p.Up <= kb.THREADS * kb.MAX_PAIRS
        hp = p.KW + 8
    else:
        assert p.route == "simt"
        assert p.KS * p.KW >= p.C * p.Up
        assert p.KW % 4 == 0 and p.KR % 4 == 0 and 0 <= p.KR <= p.KW
        assert p.KS * 2 * -(-p.Up // 32) == 8        # warps of a block
        assert p.rpt in kb.ROWS_PER_THREAD and p.rpt >= -(-p.tile // 2)
        hp = p.KS * p.KW
    # resident W_hh plus the tile's h and the new slice (and c, gi, the
    # partials or pre) within one block's limit
    buffers = p.smem - p.resident_bytes
    assert buffers >= p.tile * hp * 4 + p.tile * p.Up * 4
    if p.route == "simt":      # h's zero rows cover every row group's reads
        assert buffers >= (-(-p.tile // 2) + p.rpt) * hp * 4
    assert p.smem <= 232448
    # every cluster resident at once
    assert p.clusters <= max_clusters and p.waves == 1
    # the share of W_hh streamed from L2 at every step
    if p.route == "simt":
        assert p.streamed_rows == sum(
            max(0, min(s * p.KW + p.KW, H) - (s * p.KW + p.KR))
            for s in range(p.KS))
    if mode == "bilstm" and dtype == torch.float32 and H >= 512:
        assert 0.0 < p.stream_share < 1.0
    if dtype == torch.bfloat16 and H <= 512 and p.tile <= 34:
        assert p.route == "mma" and p.stream_share == 0.0


@pytest.mark.parametrize("max_clusters,tile,streamed", [
    (7, 34, {"bigru": 192, "bilstm": 288}),
    (8, 25, {"bigru": 112, "bilstm": 240})])
def test_flagship_plan(max_clusters, tile, streamed):
    """(B, H) = (100, 512) on a card that holds 7 (an H100 80GB HBM3) or 8
    clusters of 16: tiles of 34 or 25 rows, 96 or 128 blocks; bf16 on the
    tensor cores, W_hh wholly resident; in f32 (SIMT) the tile's h and
    W_hh do not both fit, and the rows past KR of each K-split stream from
    L2."""
    for mode in ("bigru", "bilstm"):
        for dtype in DTYPES:
            p = birnn_plan(100, 512, mode, dtype, max_clusters)
            assert (p.C, p.tile, p.Up) == (16, tile, 32)
            assert p.clusters * p.C == 16 * 2 * -(-100 // tile)
            bf16 = dtype == torch.bfloat16
            assert p.route == ("mma" if bf16 else "simt")
            assert p.streamed_rows == (0 if bf16 else streamed[mode])


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        birnn_plan(4, 41, "bigru", torch.bfloat16, 8)     # odd H in bf16
    with pytest.raises(ValueError):
        birnn_plan(4, 1100, "bigru", torch.float32, 8)    # > 64 units/block
    with pytest.raises(TypeError):
        birnn_plan(4, 40, "bigru", torch.float16, 8)
    with pytest.raises(ValueError):
        birnn_plan(4, 40, "gru", torch.float32, 8)


def _emulate(p, gi, wh, bh, mode):
    """The kernel's dataflow in plain PyTorch (f64): per cluster and
    block, each K-split's partial product over its rows of W_hh (resident
    or streamed alike: the same values) in groups of 4 rows, from the
    tile's whole h that every block pushed its slice into, the partials
    summed, then the gate math."""
    T, _, B, G = gi.shape
    H, NG = p.H, p.n_gates
    out = torch.zeros(T, 2, B, H, dtype=torch.float64)
    for k in range(2):
        for tile in range(p.n_tiles):
            rows = list(p.rows(tile))
            h = torch.zeros(len(rows), p.C * p.Up, dtype=torch.float64)
            c = torch.zeros_like(h)
            for t in range(T):
                h_new = torch.zeros_like(h)
                for blk in range(p.C):
                    us = list(p.units(blk))
                    if not us:
                        continue
                    acc = torch.zeros(len(rows), NG, len(us),
                                      dtype=torch.float64)
                    for s in range(p.KS):
                        for r in range(0, p.KW, 4):
                            kk = [s * p.KW + r + i for i in range(4)]
                            kk = [x for x in kk if x < H]
                            if not kk:
                                continue
                            w = wh[k][kk].double().view(len(kk), NG, H)
                            acc += torch.einsum("bk,kgu->bgu", h[:, kk],
                                                w[..., us])
                    g_in = gi[t, k, rows].double().view(len(rows), NG, H)
                    g_in = g_in[..., us]
                    if mode == "bigru":
                        bk = bh[k].double().view(NG, H)[:, us]
                        rg = torch.sigmoid(g_in[:, 0] + acc[:, 0] + bk[0])
                        z = torch.sigmoid(g_in[:, 1] + acc[:, 1] + bk[1])
                        n = torch.tanh(g_in[:, 2] + rg * (acc[:, 2] + bk[2]))
                        hn = (1 - z) * n + z * h[:, us]
                    else:
                        i_, f_, g_, o_ = (g_in + acc).unbind(1)
                        c[:, us] = (torch.sigmoid(f_) * c[:, us]
                                    + torch.sigmoid(i_) * torch.tanh(g_))
                        hn = torch.sigmoid(o_) * torch.tanh(c[:, us])
                    h_new[:, us] = hn
                h = h_new
                out[t, k, rows] = h[:, :H]
    return out


@pytest.mark.parametrize("mode", ["bigru", "bilstm"])
@pytest.mark.parametrize("B,H,max_clusters", [(7, 40, 8), (5, 72, 4),
                                              (3, 520, 16)])
def test_plan_dataflow_matches_plain_twin(mode, B, H, max_clusters):
    T = 4
    NG = 3 if mode == "bigru" else 4
    rng = np.random.RandomState(H + B)
    gi = torch.from_numpy(rng.randn(T, 2, B, NG * H).astype(np.float32))
    wh = torch.from_numpy(((rng.rand(2, H, NG * H) * 2 - 1)
                           / np.sqrt(H)).astype(np.float32))
    bh = (torch.from_numpy(((rng.rand(2, NG * H) * 2 - 1)
                            / np.sqrt(H)).astype(np.float32))
          if mode == "bigru" else None)
    p = birnn_plan(B, H, mode, torch.float32, max_clusters)
    got = _emulate(p, gi, wh, bh, mode)
    ref = birnn_recurrence_plain(gi, wh, bh, mode=mode, hidden=H)
    np.testing.assert_allclose(got.numpy(), ref.double().numpy(), atol=1e-5)


def test_card_plan_asks_each_device(monkeypatch):
    """The occupancy answer is kept per card: a second device index gets
    its own query, not the first card's answer."""
    device = {"index": 0}
    answers = {0: 7, 1: 4}
    asked = []

    class FakeLib:
        @staticmethod
        def gvd_birnn_max_clusters(*args):
            asked.append(device["index"])
            return answers[device["index"]]

    monkeypatch.setattr(kb._build, "lib", lambda: FakeLib)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: device["index"])
    kb._max_clusters.cache_clear()
    try:
        plans = {}
        for index in (0, 1, 0):
            device["index"] = index
            plans[index] = kb.card_plan(100, 512, "bigru", torch.float32)
        assert plans[0].max_clusters == 7 and plans[1].max_clusters == 4
        assert plans[0].clusters <= 7 and plans[1].clusters <= 4
        assert 1 in asked
        # the third plan, on device 0 again, is served from the cache
        n0 = asked.count(0)
        device["index"] = 0
        kb.card_plan(100, 512, "bigru", torch.float32)
        assert asked.count(0) == n0
    finally:
        kb._max_clusters.cache_clear()
