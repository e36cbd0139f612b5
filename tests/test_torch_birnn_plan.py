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
    birnn_backward_plain, birnn_backward_plan, birnn_forward_train_plain,
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
    summed, then the gate math.  The blocks' columns are independent, so
    the C blocks of a cluster run side by side (their units past H padded,
    as the kernel's), and the groups of a K-split at once."""
    T, _, B, G = gi.shape
    H, NG, CU = p.H, p.n_gates, p.C * p.Up
    f64 = torch.float64
    out = torch.zeros(T, 2, B, H, dtype=f64)
    # each K-split's rows of W_hh in groups of 4 (rows past H: none)
    groups = []
    for s in range(p.KS):
        rows = [s * p.KW + r for r in range(p.KW) if s * p.KW + r < H]
        rows += [-1] * (-len(rows) % 4)          # a last group's padding
        groups.append(torch.tensor(rows).view(-1, 4))
    for k in range(2):
        # W (H + 1, NG, C Up): row -1 and units past H are zeros
        w = torch.zeros(H + 1, NG, CU, dtype=f64)
        w[:H, :, :H] = wh[k].double().view(H, NG, H)
        bk = torch.zeros(NG, CU, dtype=f64)
        if mode == "bigru":
            bk[:, :H] = bh[k].double().view(NG, H)
        for tile in range(p.n_tiles):
            rows = list(p.rows(tile))
            h = torch.zeros(len(rows), H + 1, dtype=f64)
            c = torch.zeros(len(rows), CU, dtype=f64)
            for t in range(T):
                acc = torch.zeros(len(rows), NG, CU, dtype=f64)
                for g in groups:                       # the K-splits
                    part = torch.einsum("bnk,nkgu->nbgu", h[:, g],
                                        w[g])          # each group
                    acc += part.sum(0)
                g_in = torch.zeros(len(rows), NG, CU, dtype=f64)
                g_in[..., :H] = gi[t, k, rows].double().view(
                    len(rows), NG, H)
                h_old = torch.zeros(len(rows), CU, dtype=f64)
                h_old[:, :H] = h[:, :H]
                if mode == "bigru":
                    rg = torch.sigmoid(g_in[:, 0] + acc[:, 0] + bk[0])
                    z = torch.sigmoid(g_in[:, 1] + acc[:, 1] + bk[1])
                    n = torch.tanh(g_in[:, 2] + rg * (acc[:, 2] + bk[2]))
                    hn = (1 - z) * n + z * h_old
                else:
                    i_, f_, g_, o_ = (g_in + acc).unbind(1)
                    c = torch.sigmoid(f_) * c + torch.sigmoid(i_) * torch.tanh(g_)
                    hn = torch.sigmoid(o_) * torch.tanh(c)
                h = torch.zeros_like(h)
                h[:, :H] = hn[:, :H]
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


@pytest.mark.parametrize("max_clusters", [4, 7, 8])
@pytest.mark.parametrize("H", [40, 512, 520])
@pytest.mark.parametrize("B", [7, 15, 30, 100])
@pytest.mark.parametrize("mode", ["bigru", "bilstm"])
def test_backward_plan_fits(mode, B, H, max_clusters):
    """The training route's backward runs on the forward's f32 plan: its
    resident rows of W_hh^T, its D, slots and prefetched inputs within a
    block's shared memory; for the GRU every row resident at the cells'
    microbatches (30 rows, 15 a rank of the four-card mesh) and H = 512 on
    a card that holds 7 or more clusters of 16 (an H100 holds 7).  (The
    LSTM's 128 rows of 512 f32 are more than a block holds.)"""
    p = birnn_plan(B, H, mode, torch.float32, max_clusters)
    KB, smem = birnn_backward_plan(p, mode)
    K = p.n_gates * p.Up
    assert KB % 4 == 0 and 0 <= KB <= K and smem <= kb.SMEM_MAX
    assert smem == kb._bwd_smem_bytes(p, mode, KB)
    assert KB == K or kb._bwd_smem_bytes(p, mode, KB + 4) > kb.SMEM_MAX
    if mode == "bigru" and B <= 30 and H == 512 and max_clusters >= 7:
        assert KB == K
    with pytest.raises(ValueError):
        birnn_backward_plan(birnn_plan(B, H, mode, torch.bfloat16, 2), mode)


def _emulate_backward(p, KB, dys, ys, gates, wh, mode):
    """The backward kernel's dataflow in plain PyTorch (f64), in reverse
    time per cluster, the C blocks side by side (units past H padded with
    zeros, as the kernel's): each block forms the gate gradients of its
    own units from dy, its local term (the GRU's dh z; the LSTM's dc) and
    its C slots summed in block order; then its partial dgh W_hh^T over
    its K = NG Up rows (the KB resident ones, then the streamed ones) over
    all C Up units, each owner's columns pushed into that owner's slot for
    this block: the reduce-scatter.  dW_hh and db_hh from h_{t-1} and
    dgh."""
    T, _, B, H = ys.shape
    NG, C, Up = p.n_gates, p.C, p.Up
    CU, f64 = C * Up, torch.float64

    def pad(x):                     # (..., H) -> (..., C, Up)
        x = torch.nn.functional.pad(x.double(), (0, CU - H))
        return x.view(*x.shape[:-1], C, Up)
    dyp, yp, gp = pad(dys), pad(ys), pad(gates)
    whT = wh.double().transpose(1, 2)                        # (2, G, H)
    dgi = torch.zeros(T, 2, B, NG, CU, dtype=f64)
    dgh = torch.zeros(2, T, B, NG, CU, dtype=f64)
    for k in range(2):
        # block c's rows g Up + u of W_hh^T over its C Up columns
        Wt = torch.nn.functional.pad(whT[k].view(NG, H, H),
                                     (0, CU - H, 0, CU - H))
        Wt = Wt.view(NG, C, Up, CU).transpose(0, 1).reshape(C, NG * Up, CU)
        for tile in range(p.n_tiles):
            rows = slice(p.rows(tile)[0], p.rows(tile)[-1] + 1)
            nb = rows.stop - rows.start
            slots = torch.zeros(C, C, nb, Up, dtype=f64)     # owner, from
            loc = torch.zeros(C, nb, Up, dtype=f64)
            for t in range(T - 1, -1, -1):
                carried = (loc.clone() if mode == "bigru"
                           else torch.zeros_like(loc))
                for r in range(C):                           # block order
                    carried = carried + slots[:, r]
                dh = dyp[t, k, rows].transpose(0, 1) + carried  # (C, nb, Up)
                sv = gp[t, k, rows].permute(2, 1, 0, 3)     # (C, NS, nb, Up)
                zero = torch.zeros_like(dh)
                h_old = (yp[t - 1, k, rows].transpose(0, 1) if t > 0
                         else zero)
                if mode == "bigru":
                    r_, z, n, hn = sv.unbind(1)
                    dn = dh * (1 - z) * (1 - n * n)
                    dr = dn * hn * r_ * (1 - r_)
                    dz = dh * (h_old - n) * z * (1 - z)
                    gi_g, gh_g = [dr, dz, dn], [dr, dz, dn * r_]
                    loc = dh * z
                else:
                    i, f, g_, o, cn = sv.unbind(1)
                    c_old = (gp[t - 1, k, rows][:, 4].transpose(0, 1)
                             if t > 0 else zero)
                    tc = torch.tanh(cn)
                    dc = loc + dh * o * (1 - tc * tc)
                    gi_g = gh_g = [dc * g_ * i * (1 - i),
                                   dc * c_old * f * (1 - f),
                                   dc * i * (1 - g_ * g_),
                                   dh * tc * o * (1 - o)]
                    loc = dc * f
                D = torch.stack(gh_g, dim=2)                 # (C, nb, NG, Up)
                dgi[t, k, rows] = torch.stack(gi_g, 2).permute(
                    1, 2, 0, 3).reshape(nb, NG, CU)
                dgh[k, t, rows] = D.permute(1, 2, 0, 3).reshape(nb, NG, CU)
                D = D.reshape(C, nb, NG * Up)
                partial = (D[:, :, :KB] @ Wt[:, :KB]
                           + D[:, :, KB:] @ Wt[:, KB:])      # (C, nb, C Up)
                slots = partial.view(C, nb, C, Up).permute(2, 0, 1, 3)
    dgi = dgi[..., :H].reshape(T, 2, B, NG * H)
    dgh = dgh[..., :H].reshape(2, T, B, NG * H)
    hp = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]]).double()
    dwh = torch.einsum("ktbh,ktbg->khg", hp.transpose(0, 1), dgh)
    return dgi, dwh, dgh.sum(dim=(1, 2))


@pytest.mark.parametrize("mode", ["bigru", "bilstm"])
@pytest.mark.parametrize("B,H,max_clusters", [(7, 40, 8), (5, 72, 4),
                                              (3, 520, 16)])
def test_backward_dataflow_matches_plain_twin(mode, B, H, max_clusters):
    """The backward kernel's partition of the work (units per block, the
    reduce-scatter of dh through the slots in block order, resident and
    streamed rows of W_hh^T) on the three plans above, emulated, against
    the backward twin: at the plan's resident rows and with only 4 of
    them (the rest streamed)."""
    T = 4
    NG = 3 if mode == "bigru" else 4
    rng = np.random.RandomState(H + B + 1)
    gi = torch.from_numpy(rng.randn(T, 2, B, NG * H).astype(np.float32))
    wh = torch.from_numpy(((rng.rand(2, H, NG * H) * 2 - 1)
                           / np.sqrt(H)).astype(np.float32))
    bh = (torch.from_numpy(((rng.rand(2, NG * H) * 2 - 1)
                            / np.sqrt(H)).astype(np.float32))
          if mode == "bigru" else None)
    dys = torch.from_numpy(rng.randn(T, 2, B, H).astype(np.float32))
    ys, gates = birnn_forward_train_plain(gi, wh, bh, mode=mode, hidden=H)
    ref = birnn_backward_plain(dys, ys, gates, wh, mode=mode)
    p = birnn_plan(B, H, mode, torch.float32, max_clusters)
    KB, _ = birnn_backward_plan(p, mode)
    for kb_rows in sorted({KB, 4}):
        got = _emulate_backward(p, kb_rows, dys, ys, gates, wh, mode)
        for name, a, b in zip(("dgi", "dwh", "dbh"), got, ref):
            if b is not None:
                np.testing.assert_allclose(a.numpy(), b.double().numpy(),
                                           atol=1e-5, err_msg=name)


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
