"""PyTorch port, K5's launch plan on the CPU (no card needed).

``k5_gemm_plan`` chooses, for each of K5's products, the GEMM route of
the compute dtype (bf16: the tensor cores through TMA; f32: the SIMT
units), the output tiles, the splits of a weight gradient's B * R rows
and the padding of rows that TMA cannot read.  The tests hold the plan
(every output tile covered once per split, the splits tiling K with none
empty, padding only where a bf16 row is not 16 bytes long), and run the
planned sequence of launches of the layer's forward and backward
(``_kernel_forward`` / ``_kernel_backward``) through each kernel's plain
version, the GEMM as its planned blocks, against the twin's autograd at
tests/test_torch_encoder_train.py's shapes (B 3, R 200, D 32, six heads,
FFN 24)."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from grounded_video_description_torch.models.transformer import Encoder
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.ops.kernels import (
    encoder_layer_train as k5)

B, R, D, HEADS, HID = 3, 200, 32, 6, 24
DTYPES = [torch.float32, torch.bfloat16]
# (M, N, K) per layout: the card tests' odd shapes, the flagship layer's
# products (B * R = 30000 rows, D 1024, FFN 512) and the tiny layer's
SHAPES = {
    k5.NT: [(300, 200, 170), (30000, 1024, 1024), (30000, 512, 1024),
            (30000, 1024, 512), (600, 24, 32)],
    k5.NN: [(300, 200, 170), (30000, 1024, 1024), (30000, 512, 1024),
            (30000, 1024, 512), (600, 32, 24)],
    k5.TN: [(300, 200, 170), (1024, 1024, 30000), (512, 1024, 30000),
            (1024, 512, 30000), (24, 32, 600), (1024, 1024, 1100)],
}
CASES = [(layout, shape) for layout, shapes in SHAPES.items()
         for shape in shapes]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("layout,shape", CASES)
def test_plan_covers_every_output_tile_once_per_split(layout, shape, dtype):
    """The grid's blocks cover each output element once in every split,
    and the splits' K ranges tile [0, K) in order, none empty, each a
    whole number of the route's K steps but the last."""
    M, N, K = shape
    plan = k5.k5_gemm_plan(layout, M, N, K, dtype)
    assert plan.route == ("tc" if dtype == torch.bfloat16 else "simt")
    assert plan.k_split % plan.tile_k == 0
    seen = torch.zeros((plan.splits, M, N), dtype=torch.int32)
    ks = {}
    for z, rows, cols, k in plan.blocks():
        seen[z, rows, cols] += 1
        assert ks.setdefault(z, k) == k          # one K range a split
    assert bool((seen == 1).all())
    assert len(list(plan.blocks())) == int(np.prod(plan.grid))
    starts = [ks[z].start for z in range(plan.splits)]
    stops = [ks[z].stop for z in range(plan.splits)]
    assert starts[0] == 0 and stops[-1] == K
    assert starts[1:] == stops[:-1]
    assert all(b > a for a, b in zip(starts, stops))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sms", [132, 114])
def test_weight_gradients_split_their_rows_to_fill_the_card(dtype, sms):
    """A weight gradient over the flagship's 30000 rows has 32-64 output
    tiles: its rows are split so that its blocks fill the card's SMs once
    (two blocks an SM on either route), each split at least
    SPLIT_MIN_ROWS rows; the data products (NT, NN) are not split, nor is
    a TN whose rows are too few."""
    per_sm = k5.GEMM_ROUTES[dtype][4]
    for M, N in ((1024, 1024), (512, 1024), (1024, 512)):
        plan = k5.k5_gemm_plan(k5.TN, M, N, 30000, dtype, sms=sms)
        tiles = plan.grid[0] * plan.grid[1]
        assert plan.splits == max(1, sms * per_sm // tiles)
        assert plan.splits > 1 or sms * per_sm < 2 * tiles
        assert tiles * plan.splits <= max(sms * per_sm, tiles)
        assert plan.k_split >= k5.SPLIT_MIN_ROWS
    for layout in (k5.NT, k5.NN):
        assert k5.k5_gemm_plan(layout, 30000, 1024, 1024, dtype,
                               sms=sms).splits == 1
    assert k5.k5_gemm_plan(k5.TN, 1024, 1024, 1000, dtype,
                           sms=sms).splits == 1
    assert k5.k5_gemm_plan(k5.TN, 300, 200, 170, dtype, splits=3,
                           sms=sms).splits == 3


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("layout,shape", CASES)
def test_plan_pads_only_rows_that_are_not_16_byte_aligned(layout, shape,
                                                          dtype):
    """bf16 rows go to TMA, which reads rows 16 bytes apart: a row length
    that is not a multiple of 8 is padded to the next one, and no other.
    f32 rows go to 4-byte cp.async and are never padded."""
    M, N, K = shape
    plan = k5.k5_gemm_plan(layout, M, N, K, dtype)
    for length, ld in zip(k5.row_lengths(layout, M, N, K),
                          (plan.lda, plan.ldb)):
        if dtype == torch.float32 or length % 8 == 0:
            assert ld == length
        else:
            assert ld == length + (-length % 8) and ld % 8 == 0


def _layer():
    g = torch.Generator().manual_seed(0)
    enc = Encoder(D, HID, 1)
    enc.reset_parameters(g)
    with torch.no_grad():
        for ln in (enc.layers[0].selfattn.layernorm,
                   enc.layers[0].feedforward.layernorm):
            ln.gamma.add_(0.2 * torch.randn(D, generator=g))
            ln.beta.add_(0.2 * torch.randn(D, generator=g))
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(B, R, D).astype(np.float32))
    cot = torch.from_numpy(rng.randn(B, R, D).astype(np.float32))
    return enc.layers[0].weights(), x, cot


@pytest.mark.parametrize("drop", [0.0, 0.3])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_planned_sequence_matches_the_twin(dtype, drop, monkeypatch):
    """The forward's and backward's launches, each through its kernel's
    plain version (the GEMMs as their planned blocks and splits), against
    the twin's output and autograd gradients of x and the 12 layer
    tensors, each relative to its largest magnitude.  f32: 1e-5.  bf16:
    the same rounding points (q, k, v, o, x1c and the FFN activation
    stored in bf16; df, dacc and dz1 entering their products as bf16
    copies, db1, db2 and the LayerNorm gradients summing f32 values), so
    the two differ only where an f32 sum in another order rounds to the
    other bf16 neighbour: 4e-3, about one bf16 ulp at the largest value.
    Every product is planned in the compute dtype with bf16 (or f32)
    operands, six in the forward and twelve in the backward."""
    lw, x0, cot = _layer()
    seed = torch.tensor([0x9E3779B9], dtype=torch.int64)
    x = x0.to(dtype)
    xl = x.clone().requires_grad_(True)
    out = k5.fused_encoder_layer_train_plain(xl, lw, seed, n_heads=HEADS,
                                             drop=drop)
    ref = [out.detach()] + list(torch.autograd.grad(
        out, [xl] + list(lw), cot.to(dtype)))

    calls = []
    real_mm = k5._mm

    def recording(layout, a, b, *args, **kw):
        calls.append((layout, a.dtype, b.dtype))
        return real_mm(layout, a, b, *args, **kw)

    monkeypatch.setattr(k5, "_mm", recording)
    _build.reset_launches()
    with torch.no_grad():
        got, saved = k5._kernel_forward(x, lw, seed, HEADS, drop)
        n_fwd = len(calls)
        dx, dw = k5._kernel_backward(cot.to(dtype), saved, HEADS, drop,
                                     tuple(x.shape))
    assert not _build.launches                 # CPU: no kernel launched
    assert n_fwd == k5.FWD_GEMMS
    assert len(calls) - n_fwd == k5.BWD_GEMMS
    assert [c[0] for c in calls] == list(k5.GEMM_LAYOUTS)
    assert all(a == dtype and b == dtype for _, a, b in calls)
    assert torch.equal(saved.hid, saved[k5.K5Saved._fields.index("hid")])
    bar = 1e-5 if dtype == torch.float32 else 4e-3
    for i, (a, r) in enumerate(zip([got, dx, *dw], ref)):
        assert a.dtype == r.dtype and a.shape == r.shape, i
        err = float((a.float() - r.float()).abs().max())
        assert err <= bar * float(r.float().abs().max()), (i, err)


def test_bf16_sequence_rounds_the_gradient_operands(monkeypatch):
    """In bf16 the GEMM operands df, dz1 and dacc are the bf16 roundings
    of the f32 gradients that db2, db1 and the LayerNorm sums read: the
    plain LayerNorm backward and the dz1 product return both."""
    lw, x0, cot = _layer()
    seed = torch.tensor([7], dtype=torch.int64)
    x = x0.to(torch.bfloat16)
    pairs = []
    real_ln_bwd, real_mm = k5._ln_bwd, k5._mm

    def ln_bwd(*a, **kw):
        dy, dyd, dyd_t = real_ln_bwd(*a, **kw)
        pairs.append((dyd, dyd_t))
        return dy, dyd, dyd_t

    def mm(*a, copy_bf16=False, **kw):
        got = real_mm(*a, copy_bf16=copy_bf16, **kw)
        if copy_bf16:
            pairs.append(got)
        return got

    monkeypatch.setattr(k5, "_ln_bwd", ln_bwd)
    monkeypatch.setattr(k5, "_mm", mm)
    with torch.no_grad():
        _, saved = k5._kernel_forward(x, lw, seed, HEADS, 0.3)
        k5._kernel_backward(cot.to(torch.bfloat16), saved, HEADS, 0.3,
                            tuple(x.shape))
    assert len(pairs) == 3                      # df, dz1, dacc
    for f32, copy in pairs:
        assert f32.dtype == torch.float32 and copy.dtype == torch.bfloat16
        assert torch.equal(copy, f32.to(torch.bfloat16))
