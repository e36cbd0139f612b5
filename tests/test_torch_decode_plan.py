"""K6's launch plan (ops/kernels/decode_scan.py::decode_scan_plan) and its
GEMM phases' arithmetic, on the CPU.  The kernel runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py); here the plan is held to what
csrc/decode_scan.cu needs (every output column, batch row and chunk of K
in exactly one item, so each weight row is read once a step; items that
fill the grid; shared memory within an SM's), and a plain emulation of
the kernel's swapped-operand products in its tiles, split-K runs and
8- or 16-deep steps (f32 in 3xTF32; bf16 weights times the state as the
JAX K6 takes it: the recurrent h whole as bf16 hi + lo, the rest rounded
to bf16 once) is held against the twin's products."""

from __future__ import annotations

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from grounded_video_description_torch.ops.kernels import decode_scan as ks
from grounded_video_description_torch.ops.kernels.attention_train import (
    mm_3xtf32)
from grounded_video_description_torch.ops.kernels.decode_scan import (
    decode_scan_plan)

DTYPES = [torch.float32, torch.bfloat16]
H100_SMS = 132
# (B, T, R, H, A, E, V): the eval flagship, tests/test_torch_cuda.py's tiny
# model and its two-row-tile model, and a vocabulary off the tiles
SHAPES = {"flagship": (100, 480, 1000, 1024, 512, 512, 4905),
          "tiny": (5, 4, 300, 64, 32, 32, 300),
          "rows": (130, 4, 300, 128, 64, 64, 300),
          "vocab": (100, 480, 1000, 1024, 512, 512, 1001)}


def _items(ph):
    return [ph.item(it) for it in range(ph.items)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_items_cover_each_column_row_and_chunk_once(shape, dtype):
    """Every (column tile, row tile, chunk) of a phase in exactly one
    item, each item a non-empty run of chunks: every output element gets
    every term of its sum once, and (one row tile at B <= 128) every
    weight row is read once a step."""
    B, T, R, H, A, E, V = SHAPES[shape]
    plan = decode_scan_plan(B, T, R, H, A, E, V, dtype, H100_SMS)
    want = {"att_lstm": (4 * H, (E, H)), "h2att": (2 * A, (H,)),
            "lang_lstm": (4 * H, (H, H, H)), "logit": (V, (H,))}
    assert [p.name for p in plan.phases] == list(want)
    for ph in plan.phases:
        assert (ph.n, ph.ks) == want[ph.name]
        assert ph.col_tiles * ks.NC >= ph.n > (ph.col_tiles - 1) * ks.NC
        assert ph.row_tiles * ks.RT >= B > (ph.row_tiles - 1) * ks.RT
        assert ph.chunks == sum(math.ceil(k / ks.KC) for k in ph.ks)
        seen = {}
        for n0, r0, z, run in _items(ph):
            assert len(run) > 0 and 0 <= z < ph.splits
            for c in run:
                key = (n0, r0, c)
                assert key not in seen
                seen[key] = z
        assert len(seen) == ph.col_tiles * ph.row_tiles * ph.chunks
        # each chunk lies in one segment, and the chunks tile each segment
        cols = {}
        for c in range(ph.chunks):
            s, k0 = ph.chunk(c)
            assert 0 <= k0 < ph.ks[s]
            cols.setdefault(s, []).append(k0)
        for s, k in enumerate(ph.ks):
            assert cols[s] == list(range(0, k, ks.KC))
        # the split sums buffer holds every split of every row and column
        assert plan.part_floats >= ph.splits * B * ph.n
        if B <= ks.RT:
            weights = sum(min(ks.NC, ph.n - n0) * len(run)
                          for n0, _, _, run in _items(ph))
            assert weights == ph.n * ph.chunks


@pytest.mark.parametrize("dtype", DTYPES)
def test_flagship_phases_fill_the_grid(dtype):
    """At the eval flagship on 132 SMs, two blocks an SM (264): no block
    takes two items, every phase keeps at least 234 blocks busy, and the
    longest item is within one chunk of an even share of the phase's
    chunks over the grid.  h2att has 8 column tiles of 32 chunks: 256
    items of one chunk each, every chunk its own item."""
    plan = decode_scan_plan(*SHAPES["flagship"], dtype, H100_SMS)
    assert plan.grid == 2 * H100_SMS
    for ph in plan.phases:
        units = ph.col_tiles * ph.row_tiles * ph.chunks
        assert ph.items <= plan.grid
        assert ph.items >= min(units, 234)
        assert ph.longest <= math.ceil(units / plan.grid) + 1
    by = {p.name: p for p in plan.phases}
    assert by["h2att"].items == by["h2att"].chunks * by["h2att"].col_tiles
    assert by["h2att"].longest == 1
    # the old kernel's items: 128 (LSTMs, h2att) and ~154 (logits)
    assert min(p.items for p in plan.phases) > 154


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shared_memory_fits_two_blocks_an_sm(shape, dtype):
    """The ring (3 stages of 128 weight rows and 128 f32 state rows, 32
    deep, padded rows) and every other phase's scratch fit one block's
    shared memory, two blocks an SM."""
    B, T, R, H, A, E, V = SHAPES[shape]
    plan = decode_scan_plan(B, T, R, H, A, E, V, dtype, H100_SMS)
    ring = ks.ring_bytes(dtype)
    assert ring == (110592 if dtype == torch.float32 else 92160)
    assert plan.smem >= 4 * ks.HEAD_WORDS + ring
    assert plan.smem >= 4 * (ks.HEAD_WORDS + max(T, R) + ks.NG * ks.DCH)
    assert plan.smem >= 4 * (ks.HEAD_WORDS + max(2 * A, V))
    assert 2 * (plan.smem + ks.BLOCK_RESERVED) <= ks.SM_SMEM
    assert plan.grid == 2 * H100_SMS


def test_state_whole_is_each_lstms_recurrent_h():
    """bf16 keeps the f32 state whole in the last segment of a phase of
    several (csrc ``recurrent``): h_att of the att-LSTM and h_lang of the
    lang-LSTM, the two products the JAX K6 takes in f32; every other
    segment is rounded to bf16."""
    plan = decode_scan_plan(*SHAPES["flagship"], torch.bfloat16, H100_SMS)
    for ph in plan.phases:
        n = len(ph.ks)
        assert ks.STATE_WHOLE[ph.name] == tuple(
            n > 1 and i == n - 1 for i in range(n)), ph.name
    assert sum(map(sum, ks.STATE_WHOLE.values())) == 2


def test_plan_refuses_what_no_sm_holds():
    with pytest.raises(ValueError):
        decode_scan_plan(100, 480, 1000, 1024, 512, 512, 60000,
                         torch.float32, H100_SMS)


# --------------------------------------------------- the products, emulated


def split_bf16(x: torch.Tensor):
    """The f32 state as two bf16 terms: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def emulate_phase(ph, xs, ws, B, dtype):
    """out (B, n) = sum over the segments of x_s w_s^T as the kernel
    computes it: per item its columns and rows, its run of 32-deep chunks
    in order (zero past a segment's K), per 8-deep (f32) or 16-deep
    (bf16) step the step's products added to the running f32 sum: f32 in
    3xTF32; bf16 the weights times the state's lo term, then its hi term,
    where ``STATE_WHOLE`` keeps the segment's state whole, else times the
    state rounded to bf16.  Then each element's split sums in split
    order."""
    part = torch.zeros(ph.splits, B, ph.n)
    step = 8 if dtype == torch.float32 else 16
    for n0, r0, z, run in _items(ph):
        n1, r1 = min(n0 + ks.NC, ph.n), min(r0 + ks.RT, B)
        acc = torch.zeros(n1 - n0, r1 - r0)
        for c in run:
            s, k0 = ph.chunk(c)
            w = ws[s][n0:n1, k0:k0 + ks.KC].float()
            x = xs[s][r0:r1, k0:k0 + ks.KC]
            for kk in range(0, w.shape[1], step):
                wk, xk = w[:, kk:kk + step], x[:, kk:kk + step]
                if dtype == torch.float32:
                    acc = acc + mm_3xtf32(wk, xk.T)
                elif ks.STATE_WHOLE[ph.name][s]:
                    hi, lo = split_bf16(xk)
                    acc = acc + wk @ lo.float().T
                    acc = acc + wk @ hi.float().T
                else:
                    acc = acc + wk @ xk.to(torch.bfloat16).float().T
        part[z, r0:r1, n0:n1] = acc.T
    out = torch.zeros(B, ph.n)
    for z in range(ph.splits):
        out = out + part[z]
    return out


def _phase_operands(ph, B, dtype, seed):
    """The model's scales: the state in (-1, 1) (h, relu(embed) and the
    attention results of the decode), the weights U(-1/sqrt(H), ..)."""
    g = np.random.default_rng(seed)
    xs = [torch.from_numpy(g.uniform(-1, 1, (B, k)).astype(np.float32))
          for k in ph.ks]
    bound = 1.0 / math.sqrt(ph.ks[-1])
    ws = [torch.from_numpy(g.uniform(-bound, bound, (ph.n, k))
                           .astype(np.float32)).to(dtype) for k in ph.ks]
    return xs, ws


@pytest.mark.parametrize("phase", ["att_lstm", "h2att", "lang_lstm",
                                   "logit"])
def test_emulated_f32_phase_products_match_the_twin(phase):
    """f32 at the two-row-tile model on an 8-SM grid (so the phases split
    K 2-6 ways): the emulated kernel's sums within 1e-5 of the twin's
    product (``F.linear`` of the concatenated state and weights, as
    ``lstm_cell`` and ``Linear`` take it) and of float64."""
    B, T, R, H, A, E, V = SHAPES["rows"]
    plan = decode_scan_plan(B, T, R, H, A, E, V, torch.float32, 8)
    ph = {p.name: p for p in plan.phases}[phase]
    assert ph.splits > 1 and ph.row_tiles == 2
    xs, ws = _phase_operands(ph, B, torch.float32, len(phase))
    got = emulate_phase(ph, xs, ws, B, torch.float32)
    twin = F.linear(torch.cat(xs, 1), torch.cat(ws, 1))
    exact = torch.cat(xs, 1).double() @ torch.cat(ws, 1).double().T
    assert float((got - twin).abs().max()) <= 1e-5
    assert float((got.double() - exact).abs().max()) <= 1e-5


@pytest.mark.parametrize("phase", ["att_lstm", "h2att", "lang_lstm",
                                   "logit"])
def test_emulated_bf16_phase_products_keep_the_f32_state(phase):
    """bf16 weights: the emulated sums are the JAX K6's products, each
    segment's state whole where ``STATE_WHOLE`` says (the recurrent h, an
    f32 product there) and rounded to bf16 once elsewhere (its
    ``.astype(xd)``), against float64 and the twin's ``F.linear`` of the
    same operands: within 2^-20 of sum |x| |w| where every segment is
    rounded (f32 summation order), 2^-17 where one is kept whole (hi + lo
    holds the state to 2^-18).  Both under the old bar of 2^-16.  The other
    choice for every segment misses the JAX K6's product by 8 bars and
    more."""
    B, T, R, H, A, E, V = SHAPES["rows"]
    plan = decode_scan_plan(B, T, R, H, A, E, V, torch.bfloat16, 8)
    ph = {p.name: p for p in plan.phases}[phase]
    xs, ws = _phase_operands(ph, B, torch.bfloat16, 7 + len(phase))
    got = emulate_phase(ph, xs, ws, B, torch.bfloat16)
    whole = ks.STATE_WHOLE[phase]

    def operands(keep):
        return torch.cat([x if k else x.to(torch.bfloat16).float()
                          for x, k in zip(xs, keep)], 1)

    x, w = operands(whole), torch.cat(ws, 1)
    exact = x.double() @ w.double().T
    twin = F.linear(x, w.float())
    scale = x.double().abs() @ w.double().abs().T
    bar = 2.0 ** (-17 if any(whole) else -20)
    assert float(((got.double() - exact).abs() / scale).max()) <= bar
    assert float(((got.double() - twin.double()).abs() / scale).max()) <= bar
    other = operands([not k for k in whole]).double() @ w.double().T
    assert float(((other - exact).abs() / scale).max()) > 8 * bar
