"""PyTorch port, on a CUDA card only: each hand-written kernel against its
plain PyTorch version, at small unaligned shapes, f32 and bf16 (K4 also
its gradients, and at the flagship's uneven heads; K6 on a tiny model of
the flagship's shape, and its bf16 first step against its twin's
rounding); the transformer family's greedy decode through K1 and K2,
greedy decoding over int8 banks, and the pinned staging ring's copies
against the pageable path they replaced.

The machine with the card has no JAX, so this file imports none, and is
run there without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from grounded_video_description_torch.config import tiny_test_config
from grounded_video_description_torch.data import synthetic_batch
from grounded_video_description_torch.models import (
    GVDModel, batch_to_tensors)
from grounded_video_description_torch.models.transformer import Encoder
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.ops.kernels import birnn as kb
from grounded_video_description_torch.ops.kernels.birnn import (
    birnn_recurrence, birnn_recurrence_plain, card_plan)
from grounded_video_description_torch.ops.kernels.encoder_layer import (
    ATTENTION_ROUTES, _attention, _gemm, fused_encoder_layer,
    fused_encoder_layer_plain, pack_qkv, qkv_heads_plain,
    self_attention_plain)
from grounded_video_description_torch.ops.kernels.region_attention import (
    card_plan as region_plan, fused_region_attention,
    fused_region_attention_plain)
from grounded_video_description_torch.ops.kernels.attention_train import (
    MAX_HEAD, MMA_TILE, TF32_ROUTE, mha_probs_dropout,
    mha_probs_dropout_hybrid, mha_probs_dropout_plain, pack_heads,
    pack_heads_plain, packed_width)
from grounded_video_description_torch.ops.kernels.decode_scan import (
    GEMM_ROUTES, PHASES, greedy_decode_fused, greedy_decode_fused_plain,
    greedy_decode_timed)
from grounded_video_description_torch.ops.kernels.mha import (
    flash_self_attention, flash_self_attention_plain)

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.reset_launches()
    return torch.device("cuda")


def _within(got, ref, dtype, f32_atol=1e-4):
    """f32: the same math in another order, within ``f32_atol``.  bf16:
    0.02 + 0.02 |ref| per element; one bf16 ulp is up to 2**-7 of the
    value, and at |ref| <= 4 the bar is at most 0.1, the JAX package's own
    bf16 bar on unit-scale outputs (tests/test_pallas.py)."""
    d = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        return float(d.max()) <= f32_atol
    return bool((d <= 0.02 + 0.02 * ref.float().abs()).all())


# The bf16 attention's (K4, K7) bar on max |got - ref| as a fraction of
# max |ref| (chip_smoke.py ATTN_BF16_TOL; readings: bf16_bars.py)
ATTN_BF16_TOL = 0.02


def _attention_within(got, ref, dtype, f32_atol=1e-4):
    """``_within``, and in bf16 also max |got - ref| <= ATTN_BF16_TOL
    max |ref|: the attention's values are ~0.01-0.2, where 0.02 + 0.02
    |ref| alone would pass a result that is wrong by its own size."""
    if not _within(got, ref, dtype, f32_atol):
        return False
    if dtype == torch.float32:
        return True
    return (float((got.float() - ref.float()).abs().max())
            <= ATTN_BF16_TOL * float(ref.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_region_attention_kernel(dev, dtype):
    rng = np.random.RandomState(0)
    B, R, H, D = 5, 300, 64, 96          # R not a multiple of any tile
    att = rng.rand(B, R) < 0.2
    pnt = att | (rng.rand(B, R) < 0.2)
    att[0] = pnt[0] = True               # a fully masked row

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    args = (t(rng.randn(B, R, H)).to(dtype), t(rng.randn(B, H)).to(dtype),
            t(rng.randn(B, R, D)).to(dtype), t(rng.randn(H) * 0.1),
            t(np.array([0.05])), torch.from_numpy(att).to(dev),
            torch.from_numpy(pnt).to(dev))
    got = fused_region_attention(*args)
    ref = fused_region_attention_plain(*args)
    torch.cuda.synchronize()
    assert _build.launches["region_attention"] == 1
    assert _within(got[0], ref[0], dtype)
    assert _within(got[1], ref[1], dtype, f32_atol=1e-3)  # logits are O(1)
    assert bool((got[1][0].float() <= -1e7).all())


def _argmax_agrees(got, ref, gap=1e-4):
    """Per-row argmax of ``got`` equals ``ref``'s on the rows whose top two
    values of ``ref`` are more than ``gap`` apart; returns (agree, rows)."""
    top2 = ref.float().topk(2, dim=1).values
    rows = (top2[:, 0] - top2[:, 1]) > gap
    same = got.float().argmax(dim=1) == ref.float().argmax(dim=1)
    return bool(same[rows].all()), int(rows.sum())


# (B, R, H, D, what): the flagship; one row (the plan's most splits); a
# fully masked split inside a live row; the masks as the [:, 1:] views the
# model passes; the copy routes at rows that are not whole 16 bytes in bf16
# (H = 36: bf16 takes 8-byte cp.async, f32 the bulk copy)
REGION_CASES = [(100, 1000, 512, 1024, "flagship"), (1, 1000, 512, 1024, "b1"),
                (5, 1000, 64, 96, "masked_split"),
                (7, 333, 512, 1024, "mask_views"),
                (7, 333, 36, 100, "cp_routes")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", REGION_CASES, ids=[c[-1] for c in
                                                    REGION_CASES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_region_attention_split_kernel(dev, dtype, case):
    """The split, streamed kernel against its plain version: outputs, a
    fully masked row's logits, two launches with the same bits, and in f32
    the rows' grounding argmaxes where the top two logits are more than
    1e-4 apart."""
    B, R, H, D, what = case
    rng = np.random.RandomState(4)
    plan = region_plan(B, R, H, D, dtype)
    att = rng.rand(B, R + 1) < 0.2
    pnt = att | (rng.rand(B, R + 1) < 0.2)
    full_row = B > 1          # row 0 fully masked (B = 1 keeps it live)
    if full_row:
        att[0] = pnt[0] = True
    if what == "masked_split":
        lo, hi = plan.ranges()[1]
        assert hi > lo and plan.splits > 2
        att[2, 1 + lo:1 + hi] = pnt[2, 1 + lo:1 + hi] = True
    am, pm = (torch.from_numpy(m).to(dev)[:, 1:] for m in (att, pnt))
    if what != "mask_views":
        am, pm = am.contiguous(), pm.contiguous()
    else:
        assert am.stride(0) == R + 1

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    args = (t(rng.randn(B, R, H)).to(dtype), t(rng.randn(B, H)).to(dtype),
            t(rng.randn(B, R, D)).to(dtype), t(rng.randn(H) * 0.05),
            t(np.array([0.05])), am, pm)
    if what == "cp_routes":
        assert plan.copy == ("cp8" if dtype == torch.bfloat16 else "bulk")
    _build.reset_launches()
    got = fused_region_attention(*args)
    again = fused_region_attention(*args)
    ref = fused_region_attention_plain(*args)
    torch.cuda.synchronize()
    assert _build.launches["region_attention"] == 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert _within(got[0], ref[0], dtype)
    assert _within(got[1], ref[1], dtype, f32_atol=1e-3)
    if full_row:
        assert bool((got[1][0].float() <= -1e7).all())
    if dtype == torch.float32:
        agree, rows = _argmax_agrees(got[1], ref[1])
        assert agree and rows > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(30, 7, 40), (30, 7, 520),
                                   (480, 100, 512)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["bigru", "bilstm"])
def test_birnn_recurrence_kernel(dev, mode, dtype, shape):
    """The cluster kernel against its twin: B = 7 not a multiple of any
    tile, H = 40 and H = 520 (no cluster size divides 520: padded units),
    and the flagship (480, 100, 512), whose f32 runs stream a share of
    W_hh from L2; bf16 on the tensor-core route.  A second call gives the
    same bits."""
    T, B, H = shape
    G = (3 if mode == "bigru" else 4) * H
    g = torch.Generator(device=dev).manual_seed(1)
    gi = (torch.randn(T, 2, B, G, generator=g, device=dev) * 0.5).to(dtype)
    wh = ((torch.rand(2, H, G, generator=g, device=dev) * 2 - 1)
          / H ** 0.5).to(dtype)
    bh = ((torch.rand(2, G, generator=g, device=dev) * 2 - 1)
          / H ** 0.5).to(dtype) if mode == "bigru" else None
    ref = birnn_recurrence_plain(gi, wh, bh, mode=mode, hidden=H)
    got = birnn_recurrence(gi, wh, bh, mode=mode, hidden=H)
    again = birnn_recurrence(gi, wh, bh, mode=mode, hidden=H)
    torch.cuda.synchronize()
    assert _within(got, ref, dtype)
    assert torch.equal(got, again)
    assert _build.launches["birnn_recurrence"] == 2
    plan = card_plan(B, H, mode, dtype)
    assert plan.clusters <= plan.max_clusters and plan.smem <= 232448
    if dtype == torch.bfloat16 and H <= 512:
        assert plan.route == "mma"           # the tensor-core kernel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_layer_kernel(dev, dtype):
    """Six uneven heads (11 x 5 + 9 at D=64), R not a multiple of the
    query or key tiles."""
    enc = Encoder(64, 32, 2)
    enc.reset_parameters(torch.Generator().manual_seed(2))
    enc = enc.to(dev)
    x = torch.randn(3, 70, 64, generator=torch.Generator().manual_seed(3))
    x = x.to(dev).to(dtype)
    with torch.no_grad():
        for w in [lp.weights() for lp in enc.layers]:
            got = fused_encoder_layer(x, w, n_heads=6)
            ref = fused_encoder_layer_plain(x, w, n_heads=6)
            torch.cuda.synchronize()
            # LayerNorm outputs are unit-scale; 1e-3 covers f32 order
            assert _within(got, ref, dtype, f32_atol=1e-3)
            x = ref
    route = "mma" if dtype == torch.bfloat16 else "tf32x3"
    want = {"encoder_layer": 2, ATTENTION_ROUTES[route]: 2}
    if dtype == torch.float32:
        want[TF32_ROUTE] = 2
    assert dict(_build.launches) == want


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 70, 64), (2, 300, 1024)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_layer_attention(dev, dtype, shape):
    """K1's attention alone on a (B, R, 3D) QKV buffer, six uneven heads
    (11 x 5 + 9 at D = 64; the flagship's 171 x 5 + 169 at 1024), R not a
    multiple of the tiles, on the tensor-core forward read in place from
    the buffer: bf16 within ``_attention_within``, f32 (3xTF32) within
    1e-5."""
    B, R, D = shape
    g = torch.Generator(device=dev).manual_seed(12)
    qkv = torch.randn(B, R, 3 * D, generator=g, device=dev).to(dtype)
    got = _attention(qkv, 6)
    q, k, v = qkv.split(D, dim=-1)
    ref = self_attention_plain(q, k, v, 6, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert _attention_within(got, ref, dtype, f32_atol=1e-5)
    route = "mma" if dtype == torch.bfloat16 else "tf32x3"
    assert _build.launches[ATTENTION_ROUTES[route]] == 1
    assert _build.launches[TF32_ROUTE] == (dtype == torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("D,heads", [(1200, 6), (1024, 4), (1157, 6)])
def test_encoder_layer_attention_wide_heads(dev, D, heads):
    """f32 heads past the widest packed width (200 x 6; 256 x 4; 193 x 5
    + 192) take the SIMT route, within 1e-5, and count it alone."""
    g = torch.Generator(device=dev).manual_seed(14)
    qkv = torch.randn(2, 130, 3 * D, generator=g, device=dev)
    got = _attention(qkv, heads)
    q, k, v = qkv.split(D, dim=-1)
    ref = self_attention_plain(q, k, v, heads, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5
    assert dict(_build.launches) == {ATTENTION_ROUTES["simt"]: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 70, 64), (2, 130, 1024)])
def test_pack_qkv_kernel(dev, shape):
    """The bf16 route's repack, reading q, k, v in place from the QKV
    buffer (row stride 3D, columns from 0, D, 2D), equals its plain
    version bit for bit."""
    B, R, D = shape
    g = torch.Generator(device=dev).manual_seed(13)
    qkv = torch.randn(B, R, 3 * D, generator=g, device=dev).to(torch.bfloat16)
    got = pack_qkv(qkv, 6)
    torch.cuda.synchronize()
    assert torch.equal(got, qkv_heads_plain(qkv, 6))
    assert not _build.launches


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 200, 72), (301, 203, 77),
                                   (517, 1031, 1024)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu", [False, True])
def test_encoder_layer_gemm(dev, dtype, relu, shape):
    """K1's GEMM alone at M, N, K that are not multiples of its tiles (odd
    M, N and K too: bf16 zero-pads K to a multiple of 8): f32 within 1e-5
    (1e-4 at K = 1024); bf16 within one bf16 ulp of the f32 product of the
    same rounded operands (values below 2**-6 held to the ulp at 2**-6,
    for the f32 summation order)."""
    g = torch.Generator(device=dev).manual_seed(4)
    M, N, K = shape
    a = torch.randn(M, K, generator=g, device=dev).to(dtype)
    w = (torch.randn(N, K, generator=g, device=dev) * 0.1).to(dtype)
    bias = torch.randn(N, generator=g, device=dev)
    got = _gemm(a, w, bias, relu=relu)
    ref = a.float() @ w.float().t() + bias
    ref = (torch.relu(ref) if relu else ref).to(dtype)
    torch.cuda.synchronize()
    d = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(d.max()) <= (1e-5 if K < 1024 else 1e-4)
    else:
        _, ex = torch.frexp(ref.float().abs().clamp_min(2.0 ** -6))
        assert bool((d <= torch.ldexp(torch.ones_like(d), ex - 8)).all())


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    gi = torch.zeros(4, 2, 3, 12, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        birnn_recurrence(gi, torch.zeros(2, 4, 12, device=dev,
                                         dtype=torch.float16),
                         torch.zeros(2, 12, device=dev,
                                     dtype=torch.float16),
                         mode="bigru", hidden=4)
    p = torch.zeros(2, 5, 6, device=dev)       # H = 6: not a multiple of 4
    with pytest.raises(ValueError):
        fused_region_attention(p, torch.zeros(2, 6, device=dev),
                               torch.zeros(2, 5, 8, device=dev),
                               torch.zeros(6, device=dev),
                               torch.zeros(1, device=dev),
                               torch.zeros(2, 5, dtype=torch.bool,
                                           device=dev),
                               torch.zeros(2, 5, dtype=torch.bool,
                                           device=dev))
    assert not _build.launches


def _k4_inputs(dev, dtype, seed, B, D, R=300):
    """(B, R, D): R = 300 not a multiple of the 64-row tiles (Rp = 384),
    and a random output cotangent."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, w = (torch.randn(B, R, D, generator=g, device=dev)
                  for _ in range(4))
    return [t.to(dtype) for t in (q, k, v)], w.to(dtype)


def _k4_run(fn, qkv, w, seed, drop):
    leaves = [t.detach().clone().requires_grad_(True) for t in qkv]
    out = fn(*leaves, seed, n_heads=6, scale=qkv[0].shape[-1] ** 0.5,
             drop=drop)
    (out.float() * w.float()).sum().backward()
    return [out.detach()] + [t.grad for t in leaves]


# (B, D) in six heads: 16 wide; the flagship's 171 x 5 + 169; 20 wide (a
# width that is no multiple of 16); 192 wide (the widest packed width)
K4_SHAPES = [(3, 96), (2, 1024), (3, 120), (1, 1152)]


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [0.0, 0.3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_attention_train_kernel(dev, shape, dtype, drop):
    """K4 forward and q/k/v gradients against the plain twin's autograd on
    the same seed and masks; f32 within 1e-4 (sums of 300 terms in another
    order; every f32 launch on the 3xTF32 route), bf16 at the bf16
    attention's bars.  The hybrid schedule (plain forward, kernel
    backward) too, and a second call gives the same bits."""
    qkv, w = _k4_inputs(dev, dtype, 5, *shape)
    seed = torch.tensor([0xDEADBEEF], device=dev)
    ref = _k4_run(mha_probs_dropout_plain, qkv, w, seed, drop)
    got = _k4_run(mha_probs_dropout, qkv, w, seed, drop)
    again = _k4_run(mha_probs_dropout, qkv, w, seed, drop)
    hyb = _k4_run(mha_probs_dropout_hybrid, qkv, w, seed, drop)
    torch.cuda.synchronize()
    assert _build.launches["attention_train_fwd"] == 2
    assert _build.launches["attention_train_bwd"] == 3
    assert _build.launches[TF32_ROUTE] == (5 if dtype == torch.float32
                                           else 0)
    for name, a, b, c, r in zip(("out", "dq", "dk", "dv"), got, again, hyb,
                                ref):
        assert torch.equal(a, b), name
        assert _attention_within(a, r, dtype), name
        assert _attention_within(c, r, dtype), name


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [0.0, 0.2])
def test_attention_train_kernel_flagship_depth(dev, drop):
    """f32 K4 at the flagship's heads and depth, (2, 1000, 1024) in six
    heads (171 x 5 + 169): output and q/k/v gradients within 1e-4 of the
    plain twin's autograd (chip_smoke's bar), on the 3xTF32 route, and a
    second call gives the same bits."""
    qkv, w = _k4_inputs(dev, torch.float32, 6, 2, 1024, R=1000)
    seed = torch.tensor([0x9E3779B9], device=dev)
    ref = _k4_run(mha_probs_dropout_plain, qkv, w, seed, drop)
    got = _k4_run(mha_probs_dropout, qkv, w, seed, drop)
    again = _k4_run(mha_probs_dropout, qkv, w, seed, drop)
    torch.cuda.synchronize()
    assert _build.launches[TF32_ROUTE] == 4
    for name, a, b, r in zip(("out", "dq", "dk", "dv"), got, again, ref):
        assert torch.equal(a, b), name
        assert float((a - r).abs().max()) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 300, 96, 6), (2, 300, 1024, 6),
                                   (4, 300, 171, 1)])
def test_pack_heads_kernel(dev, shape, dtype):
    """The attention's repack kernel equals its plain version bit for bit
    in both dtypes (zero pads, up to four tensors), at the library's
    packed width; the repack entry counts no launch (the attention runs
    the repack inside its own)."""
    B, R, D, H = shape
    g = torch.Generator(device=dev).manual_seed(10)
    xs = [torch.randn(B, R, D, generator=g, device=dev).to(dtype)
          for _ in range(4)]
    got = pack_heads(xs, H)
    torch.cuda.synchronize()
    assert not _build.launches
    for x, p in zip(xs, got):
        assert torch.equal(p, pack_heads_plain(x, H))


@pytest.mark.cuda
def test_packed_layout_matches_library(dev):
    """The plain repack's widths and K5's twin's key tile are the
    library's: gvd_packed_width for every head width, and
    gvd_attention_tile."""
    lib = _build.lib()
    assert lib.gvd_attention_tile() == MMA_TILE
    for head in range(1, MAX_HEAD + 1):
        assert lib.gvd_packed_width(head) == packed_width(head), head
    assert lib.gvd_packed_width(MAX_HEAD + 1) == 0


def _k5_setup(dev, dtype):
    """K5 at R = 300 (Rp = 384, not a multiple of the 64-row tiles),
    D = 96 in six heads of 16, FFN 48, B = 3; LayerNorm affines away from
    1 and 0; a random output cotangent."""
    g = torch.Generator().manual_seed(21)
    enc = Encoder(96, 48, 1)
    enc.reset_parameters(g)
    with torch.no_grad():
        for ln in (enc.layers[0].selfattn.layernorm,
                   enc.layers[0].feedforward.layernorm):
            ln.gamma.add_(0.2 * torch.randn(96, generator=g))
            ln.beta.add_(0.2 * torch.randn(96, generator=g))
    enc = enc.to(dev)
    x = torch.randn(3, 300, 96, generator=g).to(dev, dtype)
    w = torch.randn(3, 300, 96, generator=g).to(dev)
    return enc, x, w


def _k5_run(fn, enc, x, w, seed, drop):
    """The output and the gradients of x and of the 12 layer tensors."""
    enc.zero_grad(set_to_none=True)
    xl = x.detach().clone().requires_grad_(True)
    lw = enc.layers[0].weights()
    out = fn(xl, lw, seed, n_heads=6, drop=drop)
    (out.float() * w).sum().backward()
    return [out.detach(), xl.grad] + [t.grad.clone() for t in lw]


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [0.0, 0.2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_layer_train_kernel(dev, dtype, drop):
    """K5 forward and the 13 gradients against the plain twin's autograd
    on the same seed and masks: f32 output within 1e-4 of its largest
    magnitude and each gradient within 1e-3 of its own (sums over 900 rows
    in another order), bf16 at the bf16 bar; a second call gives the same
    bits; one launch count per pass."""
    from grounded_video_description_torch.ops.kernels.encoder_layer_train \
        import fused_encoder_layer_train, fused_encoder_layer_train_plain
    enc, x, w = _k5_setup(dev, dtype)
    seed = torch.tensor([0xDEADBEEF], device=dev)
    ref = _k5_run(fused_encoder_layer_train_plain, enc, x, w, seed, drop)
    got = _k5_run(fused_encoder_layer_train, enc, x, w, seed, drop)
    again = _k5_run(fused_encoder_layer_train, enc, x, w, seed, drop)
    torch.cuda.synchronize()
    assert _build.launches["encoder_layer_train_fwd"] == 2
    assert _build.launches["encoder_layer_train_bwd"] == 2
    assert not _build.launches["attention_train_fwd"]
    # its attention: f32 on the 3xTF32 route, forward and backward
    assert _build.launches[TF32_ROUTE] == (4 if dtype == torch.float32
                                           else 0)
    for i, (a, b, r) in enumerate(zip(got, again, ref)):
        assert torch.equal(a, b), i
        assert a.dtype == r.dtype and a.shape == r.shape, i
        if dtype == torch.float32:
            bar = (1e-4 if i == 0 else 1e-3) * float(r.abs().max())
            assert float((a - r).abs().max()) <= bar, i
        else:
            assert _within(a, r, dtype), i


K5_ROUTES = {torch.float32: ("k5_gemm_simt", "k5_gemm_tc"),
             torch.bfloat16: ("k5_gemm_tc", "k5_gemm_simt")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_layer_train_gemm_route(dev, dtype):
    """One K5 forward and backward runs each of its products on the
    compute dtype's GEMM route (bf16: all on the tensor cores, none on
    SIMT), six forward and twelve backward; in f32 its attention counts
    the 3xTF32 route once each way."""
    from grounded_video_description_torch.ops.kernels import (
        encoder_layer_train as k5)
    enc, x, w = _k5_setup(dev, dtype)
    seed = torch.tensor([0xDEADBEEF], device=dev)
    _k5_run(k5.fused_encoder_layer_train, enc, x, w, seed, 0.2)
    torch.cuda.synchronize()
    route, other = K5_ROUTES[dtype]
    want = {"encoder_layer_train_fwd": 1, "encoder_layer_train_bwd": 1,
            route: k5.FWD_GEMMS + k5.BWD_GEMMS}
    if dtype == torch.float32:
        want[TF32_ROUTE] = 2
    assert dict(_build.launches) == want
    assert not _build.launches[other]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [0, 1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k5_gemm_layouts(dev, dtype, layout):
    """K5's GEMM in its three layouts at odd shapes (M 300, N 200, K 170:
    bf16 rows that are not 16 bytes long are padded for TMA) on its
    dtype's route (bf16: the tensor cores; f32: SIMT), A in the compute
    dtype and in f32 (rounded to the compute dtype first), against f32
    products of the same rounded operands: split over 1 and 3 blocks of
    K; on the x W^T and dY W layouts also the epilogue (bias, ReLU, mask,
    residual) and a residual that is C itself, with C's bf16 copy in
    bf16.  One count of the route a launch, none of the other."""
    from grounded_video_description_torch.ops.kernels import (
        encoder_layer_train as k5)
    M, N, K = 300, 200, 170
    g = torch.Generator(device=dev).manual_seed(4)
    a_shape = (K, M) if layout == 2 else (M, K)
    b_shape = (N, K) if layout == 0 else (K, N)
    route, other = K5_ROUTES[dtype]
    n = 0
    for a_dtype in {dtype, torch.float32}:
        a = torch.randn(a_shape, generator=g, device=dev).to(a_dtype)
        b = torch.randn(b_shape, generator=g, device=dev).to(dtype)
        af, bf = a.to(dtype).float(), b.float()
        op_a = af.t() if layout == 2 else af
        op_b = bf.t() if layout == 0 else bf
        ref = op_a @ op_b
        for splits in (1, 3):
            got = k5._mm(layout, a, b, M, N, K, out_f32=True,
                         splits=splits)
            n += 1
            assert _within(got, ref, torch.float32, 1e-3), splits
        if layout == 2:
            continue
        bias = torch.randn(N, generator=g, device=dev)
        mask = (torch.rand(M, N, generator=g, device=dev) > 0.5).to(dtype)
        resid = torch.randn(M, N, generator=g, device=dev)
        got = k5._mm(layout, a, b, M, N, K, out_f32=False, bias=bias,
                     relu=True, mask=mask, resid=resid)
        want = torch.relu(ref + bias) * (mask.float() > 0) + resid
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert _within(got, want.to(dtype), dtype, 1e-3)
        c = resid.clone()
        lowp = dtype == torch.bfloat16
        got = k5._mm(layout, a, b, M, N, K, out_f32=True, resid=c, out=c,
                     copy_bf16=lowp)
        n += 2
        torch.cuda.synchronize()
        if lowp:
            got, copy = got
            assert torch.equal(copy, c.to(torch.bfloat16))
        assert got is c
        assert _within(c, ref + resid, torch.float32, 1e-3)
    assert _build.launches[route] == n and not _build.launches[other]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [0, 1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k5_gemm_flagship_width(dev, dtype, layout):
    """K5's GEMM at the flagship training layer's width: x W^T and dY W
    at M 30000, N 1024, K 1024, the weight gradient A^T B at M 1024,
    N 1024 over K = 30000 rows (split as planned), f32 out, within 1e-4
    of max |ref| of the f32 product of the same operands (sums of up to
    30000 terms in another order); on the dtype's route only."""
    from grounded_video_description_torch.ops.kernels import (
        encoder_layer_train as k5)
    M, N, K = (1024, 1024, 30000) if layout == 2 else (30000, 1024, 1024)
    g = torch.Generator(device=dev).manual_seed(5)
    a_shape = (K, M) if layout == 2 else (M, K)
    b_shape = (N, K) if layout == 0 else (K, N)
    a = torch.randn(a_shape, generator=g, device=dev).to(dtype)
    b = torch.randn(b_shape, generator=g, device=dev).to(dtype)
    ref = ((a.float().t() if layout == 2 else a.float())
           @ (b.float().t() if layout == 0 else b.float()))
    got = k5._mm(layout, a, b, M, N, K, out_f32=True)
    again = k5._mm(layout, a, b, M, N, K, out_f32=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    route, other = K5_ROUTES[dtype]
    assert _build.launches[route] == 2 and not _build.launches[other]


def _decode_setup(dev, dtype):
    """A tiny model of the flagship's shape (obj_interact, BiGRU, mix,
    att_input_mode both), B = 5 (no multiple of the TPU kernel's tile of
    4), R = 300 with a random fifth under the pnt mask, and its banks
    (encoded on the plain path)."""
    cfg = tiny_test_config(obj_interact=True, num_prop_per_frm=75,
                           vocab_size=300, detect_size=20,
                           use_pallas_rnn=False, use_pallas_encoder=False,
                           dtype=str(dtype).replace("torch.", ""))
    model = GVDModel(cfg).init(torch.Generator().manual_seed(6))
    model = model.to(dev).eval()
    batch = batch_to_tensors(synthetic_batch(cfg, 5, seed=7), dev)
    g = torch.Generator(device=dev).manual_seed(8)
    pnt = batch["pnt_mask"].bool().clone()
    pnt[:, 1:] |= torch.rand(pnt[:, 1:].shape, generator=g, device=dev) < 0.2
    with torch.no_grad():
        enc = model.encode(batch)
    return model, enc, pnt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_scan_kernel(dev, dtype):
    """K6 against the plain step loop: f32 tokens identical, logprobs and
    live grounding logits within 1e-4 (sums of 64- and 96-wide products
    in another order); bf16 at the bf16 bar on step 0, where both start
    from the same state.  Masked grounding logits are MIN_VALUE on both
    sides, and a second launch gives the same bits."""
    model, enc, pnt = _decode_setup(dev, dtype)
    with torch.no_grad():
        ref = greedy_decode_fused_plain(model, enc, pnt)
        got = greedy_decode_fused(model, enc, pnt)
        again = greedy_decode_fused(model, enc, pnt)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"decode_scan": 2,
                                     GEMM_ROUTES[dtype]: 2}
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        assert a.dtype == r.dtype and a.shape == r.shape
    masked = pnt[:, None, 1:].expand_as(got[2])
    assert bool((got[2][masked].float() < -1e7).all())
    assert bool((ref[2][masked].float() < -1e7).all())
    if dtype == torch.float32:
        assert torch.equal(got[0], ref[0])
        assert _within(got[1], ref[1], dtype)
        assert _within(got[2][~masked], ref[2][~masked], dtype)
    else:
        assert _within(got[1][:, 0], ref[1][:, 0], dtype)
        assert _within(got[2][:, 0], ref[2][:, 0], dtype)


def _k6_step0_logprobs(model, enc, pnt):
    """K6's first step in f32 with the kernel's roundings, as the JAX K6
    takes them: bf16 banks and product weights, the state operands that
    it casts before a dot (the embedding, fc, h_att into h2att and the
    lang-LSTM's input, att + att2, h_lang into the logits) rounded to bf16
    once, gate, attention and softmax arithmetic in f32.  The recurrent h,
    which it keeps whole, is zero at the first step.  (B, V)."""
    from grounded_video_description_torch.ops import MIN_VALUE

    def w(t):
        return t.detach().to(torch.bfloat16).float()

    def r(t):
        return t.to(torch.bfloat16).float()

    def cell(gates):
        i, _, g, o = gates.chunk(4, dim=-1)      # c and h start at zero
        c = torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c)

    core, H = model.core, model.cfg.rnn_size
    B = pnt.shape[0]
    att, lang = core.att_lstm, core.lang_lstm
    xt = torch.relu(w(model.embed[0].weight)[0]).expand(B, -1)
    h_att = cell(enc["fc_feats"].float() @ w(att.weight_ih[:, :H]).T
                 + xt @ w(att.weight_ih[:, H:]).T
                 + (att.bias_ih + att.bias_hh).float())
    attended = 0.0
    for p, bank, mask in ((core.attention, "conv_feats", None),
                          (core.attention2, "pool_feats", pnt[:, 1:])):
        ah = r(h_att) @ w(p.h2att.weight).T + p.h2att.bias.float()
        s = (torch.tanh(enc["p_" + bank].float() + ah[:, None])
             @ p.alpha_net.weight.float()[0] + p.alpha_net.bias.float())
        if mask is not None:
            s = s.masked_fill(mask, MIN_VALUE)
        attended = attended + torch.einsum(
            "bn,bnd->bd", torch.softmax(s, dim=1), enc[bank].float())
    h_lang = cell(torch.cat([r(attended), r(h_att)], 1) @ w(lang.weight_ih).T
                  + (lang.bias_ih + lang.bias_hh).float())
    V = model.cfg.vocab_size
    logits = r(h_lang) @ w(model.logit.weight).T + model.logit.bias.float()
    return torch.log_softmax(logits[:, :V], dim=-1)


@pytest.mark.cuda
def test_decode_scan_bf16_rounds_the_state_as_its_twin(dev):
    """bf16 K6's first step is its twin's function, the state operands
    rounded to bf16 as the JAX K6 rounds them (csrc/decode_scan.cu): its
    tokens are the reference's argmaxes where their top two are 1e-3
    apart, and its logprobs within 2e-4 of the reference's (f32 sums in
    another order); a route that kept every state operand whole (hi +
    lo) would miss by the bf16 rounding of h_att and h_lang (~1e-3)."""
    model, enc, pnt = _decode_setup(dev, torch.bfloat16)
    with torch.no_grad():
        seq, lp, _ = greedy_decode_fused(model, enc, pnt)
        ref = _k6_step0_logprobs(model, enc, pnt)
    torch.cuda.synchronize()
    tok = seq[:, 0].long()
    # the UNK-suppressed pick is the argmax over the other words
    picks = ref.clone()
    picks[:, model.unk_idx] = float("-inf")
    top2 = picks.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(tok[clear], picks.argmax(dim=1)[clear])
    got_lp = lp[:, 0]
    want_lp = ref.gather(1, tok[:, None])[:, 0]
    assert float((got_lp - want_lp).abs().max()) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_scan_two_row_tiles(dev, dtype):
    """K6 at B = 130 (two 128-row tiles of the GEMM phases) and rnn 128,
    att_hid 64, input encoding 64 (several chunks per split): f32 tokens
    identical and logprobs within 1e-4 of the plain loop; bf16 at the bf16
    bar on step 0."""
    cfg = tiny_test_config(obj_interact=True, num_prop_per_frm=75,
                           vocab_size=300, detect_size=20, rnn_size=128,
                           att_hid_size=64, input_encoding_size=64,
                           use_pallas_rnn=False, use_pallas_encoder=False,
                           dtype=str(dtype).replace("torch.", ""))
    model = GVDModel(cfg).init(torch.Generator().manual_seed(16)).to(dev)
    model.eval()
    batch = batch_to_tensors(synthetic_batch(cfg, 130, seed=17), dev)
    pnt = batch["pnt_mask"].bool()
    with torch.no_grad():
        enc = model.encode(batch)
        ref = greedy_decode_fused_plain(model, enc, pnt)
        got = greedy_decode_fused(model, enc, pnt)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert torch.equal(got[0], ref[0])
        assert _within(got[1], ref[1], dtype)
    else:
        assert _within(got[1][:, 0], ref[1][:, 0], dtype)
        assert _within(got[2][:, 0], ref[2][:, 0], dtype)


@pytest.mark.cuda
def test_decode_scan_timed_stamps(dev):
    """The timing entry: one stamp at the start and one after each of the
    10 barriers of every step, non-decreasing, with and without the
    phases' work, and no launch counted."""
    model, enc, pnt = _decode_setup(dev, torch.float32)
    for barriers_only in (False, True):
        stamps = greedy_decode_timed(model, enc, pnt,
                                     barriers_only=barriers_only)
        torch.cuda.synchronize()
        assert stamps.shape == (1 + PHASES * model.cfg.seq_length,)
        assert bool((stamps[1:] >= stamps[:-1]).all())
        assert int(stamps[0]) > 0
    assert not _build.launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_self_attention_kernel(dev, dtype):
    """K7 at R = 300 (no multiple of the 64-key tiles) and d = 171 (an odd
    row stride): f32 within 1e-5 (on the 3xTF32 route), bf16 at the bf16
    attention's bars; a second launch gives the same bits."""
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(4, 300, 171, generator=g, device=dev).to(dtype)
               for _ in range(3))
    q = q / 32.0
    ref = flash_self_attention_plain(q, k, v)
    got = flash_self_attention(q, k, v)
    again = flash_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.launches["flash_self_attention"] == 2
    assert _build.launches[TF32_ROUTE] == (2 if dtype == torch.float32
                                           else 0)
    assert got.dtype == dtype and got.shape == (4, 300, 171)
    assert torch.equal(got, again)
    assert _attention_within(got, ref, dtype, f32_atol=1e-5)


@pytest.mark.cuda
def test_inference_wrappers_reject_device_mixes_and_grad(dev):
    """K6 and K7 raise on inputs split between the CPU and the card, and
    on inputs that need grad under grad mode, before any launch."""
    q = torch.zeros(2, 5, 3, device=dev)
    with pytest.raises(ValueError):
        flash_self_attention(q, q.cpu(), q)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_self_attention(q.clone().requires_grad_(True), q, q)
    model, enc, pnt = _decode_setup(dev, torch.float32)
    with torch.no_grad():
        with pytest.raises(ValueError):
            greedy_decode_fused(model.cpu(), enc, pnt)
        model.to(dev)
        with pytest.raises(ValueError):
            greedy_decode_fused(model, {k: v.cpu() if torch.is_tensor(v)
                                        else v for k, v in enc.items()}, pnt)
    with pytest.raises(RuntimeError, match="no backward"):
        greedy_decode_fused(model, enc, pnt)
    assert not _build.launches


def _peaked_beam_model(cfg, dev):
    """A tiny model of the flagship's shape whose vocab head, word
    embedding and EOS logit are scaled up, so that beams fork and some
    stop on EOS (as tests/test_torch_beam.py's weights do)."""
    model = GVDModel(cfg).init(torch.Generator().manual_seed(6))
    with torch.no_grad():
        model.logit.weight.mul_(8.0)
        model.logit.bias[0] += 0.5
        model.embed[0].weight.mul_(3.0)
    return model.to(dev).eval()


@pytest.mark.cuda
def test_sample_beam_through_k1_and_k2(dev):
    """sample_beam at B = 4, W = 3 through K1 and K2 against the plain
    path, f32: tokens and both grounding indices equal, logprobs within
    1e-4; one encode's launches (K2: two BiGRU layers, K1: two layers on
    the 3xTF32 route)."""
    cfg = tiny_test_config(obj_interact=True)
    batch = batch_to_tensors(synthetic_batch(cfg, 4, seed=7), dev)
    outs = {}
    for kernels in (True, False):
        model = _peaked_beam_model(cfg.replace(
            use_pallas_rnn=kernels, use_pallas_encoder=kernels), dev)
        _build.reset_launches()
        outs[kernels] = model.sample_beam(batch, beam_size=3)
        torch.cuda.synchronize()
        want = ({"birnn_recurrence": 2, "encoder_layer": 2,
                 ATTENTION_ROUTES["tf32x3"]: 2, TF32_ROUTE: 2}
                if kernels else {})
        assert dict(_build.launches) == want
    (seq, lp, att2, att2f), (rseq, rlp, ratt2, ratt2f) = (outs[True],
                                                          outs[False])
    assert (rseq > 0).any() and (rseq == 0).any()
    assert torch.equal(seq, rseq)
    assert torch.equal(att2, ratt2) and torch.equal(att2f, ratt2f)
    assert _within(lp, rlp, torch.float32)


def _transformer_model(cfg, dev):
    """A tiny transformer-family model with its decoder's attention
    projections and FFN outputs times 6 (chip_smoke.py's
    ``sharpen_decoder``), so that its captions hold words."""
    from chip_smoke import sharpen_decoder
    model = GVDModel(cfg).init(torch.Generator().manual_seed(9))
    model.load_state_dict(sharpen_decoder(model.state_dict()))
    return model.to(dev).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_transformer_greedy_through_k1_and_k2(dev, dtype):
    """att_model transformer: sample_greedy at B = 4, R = 300 with K1 and
    K2 in its encode against the plain path (the decoder is plain
    PyTorch): 2 + 2 launches, no decode or region kernel; f32 tokens
    identical; zero logprobs and att2 of the JAX shapes."""
    cfg = tiny_test_config(att_model="transformer", obj_interact=True,
                           num_prop_per_frm=75,
                           dtype=str(dtype).replace("torch.", ""))
    batch = batch_to_tensors(synthetic_batch(cfg, 4, seed=5), dev)
    outs = {}
    for kernels in (True, False):
        model = _transformer_model(cfg.replace(
            use_pallas=kernels, use_pallas_rnn=kernels,
            use_pallas_encoder=kernels, use_pallas_decode=kernels), dev)
        _build.reset_launches()
        outs[kernels] = model.sample_greedy(batch)
        torch.cuda.synchronize()
        got = dict(_build.launches)
        if kernels:
            assert got["birnn_recurrence"] == 2 and got["encoder_layer"] == 2
            assert not {"decode_scan", "region_attention"} & set(got)
        else:
            assert not got
    (seq, lp, att2, sim), (rseq, _, _, rsim) = outs[True], outs[False]
    assert seq.dtype == torch.int32 and seq.shape == (4, cfg.seq_length)
    assert att2.shape == (4, cfg.seq_length, cfg.max_proposal)
    assert not lp.any() and not att2.any()
    assert bool(torch.isfinite(sim).all())
    if dtype == torch.float32:
        assert torch.equal(seq, rseq) and (rseq > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_banks_greedy_takes_the_step_loop(dev, dtype):
    """quantize_banks with every kernel flag on: the step loop over int8
    banks dequantized once (K3 each step, no K6 launch), finite outputs;
    f32 tokens equal to the same decode on the CPU."""
    cfg = tiny_test_config(obj_interact=True, num_prop_per_frm=75,
                           quantize_banks=True, use_pallas=True,
                           use_pallas_decode=True,
                           dtype=str(dtype).replace("torch.", ""))
    model = GVDModel(cfg).init(torch.Generator().manual_seed(4)).eval()
    arrays = synthetic_batch(cfg, 5, seed=6)
    _build.reset_launches()
    out = model.to(dev).sample_greedy(batch_to_tensors(arrays, dev))
    torch.cuda.synchronize()
    got = dict(_build.launches)
    assert "decode_scan" not in got
    assert got["region_attention"] == cfg.seq_length
    for t in out:
        assert bool(torch.isfinite(t.float()).all())
    if dtype == torch.float32:
        ref = model.cpu().sample_greedy(batch_to_tensors(arrays, "cpu"))
        assert torch.equal(out[0].cpu(), ref[0])


@pytest.mark.cuda
def test_birnn_plan_is_asked_per_device(dev):
    """K2's occupancy answer read on device 0 is not served to device 1:
    the plan there makes its own query, and its launch is right."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    kb._max_clusters.cache_clear()
    with torch.cuda.device(0):
        card_plan(100, 512, "bigru", torch.float32)
    misses = kb._max_clusters.cache_info().misses
    with torch.cuda.device(1):
        card_plan(100, 512, "bigru", torch.float32)
        assert kb._max_clusters.cache_info().misses > misses
        d1 = torch.device("cuda", 1)
        g = torch.Generator(device=d1).manual_seed(1)
        gi = torch.randn(30, 2, 7, 120, generator=g, device=d1) * 0.5
        wh = (torch.rand(2, 40, 120, generator=g, device=d1) * 2 - 1) / 40**.5
        bh = (torch.rand(2, 120, generator=g, device=d1) * 2 - 1) / 40**.5
        got = birnn_recurrence(gi, wh, bh, mode="bigru", hidden=40)
        ref = birnn_recurrence_plain(gi, wh, bh, mode="bigru", hidden=40)
        torch.cuda.synchronize(d1)
    assert _within(got, ref, torch.float32)


# ------------------------------------------------------------------ #
# the pinned staging ring (data/staging.py)
# ------------------------------------------------------------------ #

def _pageable_generate(ev, arrays):
    """``Evaluator._generate`` as it was before the ring: pageable copies
    in, ``.cpu()`` back (bf16 as f32)."""
    dev = ev._device()
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in arrays.items() if k != "seg_id"}
    if ev.cfg.beam_size > 1:
        names = ("seq", "logprobs", "att2_ind", "att2_frm_ind")
        out = ev.decoder.sample_beam(batch, beam_size=ev.cfg.beam_size)
    else:
        names = ("seq", "logprobs", "att2_weights", "sim_mat")
        out = ev.decoder.sample_greedy(batch)
    return {k: (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
            for k, t in zip(names, out)}


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [1, 3])
def test_generate_through_the_ring_equals_the_pageable_path(dev, beam):
    """``Evaluator.generate`` at B = 5 (greedy with every kernel, beam 3
    on the peaked weights): every array bitwise the pageable path's, with
    its dtype and shape, and the caller's (a second call changes none)."""
    from grounded_video_description_torch.engine.evaluator import Evaluator
    cfg = tiny_test_config(obj_interact=True, num_prop_per_frm=75,
                           use_pallas=True, use_pallas_decode=True,
                           beam_size=beam)
    model = (_peaked_beam_model(cfg, dev) if beam > 1 else
             GVDModel(cfg).init(torch.Generator().manual_seed(4))
             .to(dev).eval())
    ev = Evaluator(cfg, model, vocab=None)
    arrays = synthetic_batch(cfg, 5, seed=8)
    got = ev.generate(arrays)
    want = _pageable_generate(ev, arrays)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    keep = {k: v.copy() for k, v in got.items()}
    ev.generate(synthetic_batch(cfg, 5, seed=9))
    assert all(np.array_equal(got[k], keep[k]) for k in keep)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_to_device_through_the_ring_equals_the_pageable_path(dev,
                                                                  dtype):
    """``batch_to_device`` (bf16: the banks cast in the staging copy)
    against the host cast and pageable copy it replaced, bitwise; and a
    batch of several slots, cut inside rows and across arrays."""
    from grounded_video_description_torch.data import staging
    from grounded_video_description_torch.engine.trainer import (
        batch_to_device)
    cfg = tiny_test_config(dtype=str(dtype).replace("torch.", ""))
    batch = synthetic_batch(cfg, 6, seed=3)
    got = batch_to_device(cfg, batch, dev)
    for k, v in batch.items():
        if k == "seg_id":
            continue
        want = torch.from_numpy(v)
        if k in ("seg_feat", "ppls_feat"):
            want = want.to(dtype)
        assert got[k].device.type == "cuda" and got[k].dtype == want.dtype
        assert got[k].shape == want.shape, k
        assert torch.equal(got[k].cpu().view(torch.uint8),
                           want.view(torch.uint8)), k
    ring = staging.ring(dev)
    rng = np.random.default_rng(5)
    n = ring.slot_bytes // 4
    big = {"a": rng.standard_normal((3, n // 3 + 7), dtype=np.float32),
           "b": rng.integers(-9, 9, (n // 5 + 3, 2)),
           "c": rng.random((7, n // 7 + 1)) > 0.5,
           "d": rng.standard_normal(n + 5, dtype=np.float32)}
    moved = batch_to_tensors(big, dev, {"d": dtype})
    for k, v in big.items():
        want = torch.from_numpy(v).to(moved[k].dtype)
        assert torch.equal(moved[k].cpu(), want), k


@pytest.mark.cuda
def test_the_ring_copies_are_pinned_dmas(dev):
    """A profiled ``generate``: its copies in are ``Memcpy HtoD (Pinned ->
    Device)`` and its copies back ``Memcpy DtoH (Device -> Pinned)``, and
    the ``h2d`` and ``d2h`` spans staged every byte."""
    from torch.profiler import ProfilerActivity, profile

    from grounded_video_description_torch.engine.evaluator import Evaluator
    from grounded_video_description_torch.utils.logging import span_records
    cfg = tiny_test_config()
    model = GVDModel(cfg).init(torch.Generator().manual_seed(4)).to(dev)
    ev = Evaluator(cfg, model.eval(), vocab=None)
    arrays = synthetic_batch(cfg, 4, seed=2)
    ev.generate(arrays)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev.generate(arrays)
        torch.cuda.synchronize()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "Memcpy HtoD (Pinned -> Device)" in names
    assert "Memcpy DtoH (Device -> Pinned)" in names
    recs = {r.name: r for r in span_records()[-6:]}
    for name in ("h2d", "d2h"):
        assert recs[name].nbytes > 0
        assert recs[name].staged_nbytes == recs[name].nbytes
