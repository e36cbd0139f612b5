"""PyTorch port, kernels: each kernel's plain PyTorch version against the
Pallas kernel it replaces (interpret mode on the CPU), and the CPU
dispatch of each wrapper.  The CUDA kernels themselves are tested on the
card by tests/test_torch_cuda.py."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_description_tpu.models import transformer as jxf
from grounded_video_description_tpu.nn import birnn_init
from grounded_video_description_tpu.ops.pallas.birnn import (
    birnn_recurrence as pallas_birnn)
from grounded_video_description_tpu.ops.pallas.encoder_layer import (
    encoder_apply_fused as pallas_encoder, pack_layer_params)
from grounded_video_description_tpu.ops.pallas.region_attention import (
    fused_region_attention as pallas_region_attention)
from grounded_video_description_torch.models import transformer as txf
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.ops.kernels.birnn import (
    birnn_backward_plain, birnn_forward_train_plain, birnn_recurrence,
    birnn_recurrence_plain, birnn_recurrence_train)
from grounded_video_description_torch.ops.kernels.encoder_layer import (
    fused_encoder_layer, fused_encoder_layer_plain, pack_qkv,
    qkv_heads_plain)
from grounded_video_description_torch.ops.kernels.region_attention import (
    fused_region_attention, fused_region_attention_plain)
from grounded_video_description_torch.weights import encoder_state_dict


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _region_inputs(B, R, H, D, seed, full_row):
    rng = np.random.RandomState(seed)
    x = dict(p_pool=rng.randn(B, R, H), att_h=rng.randn(B, H),
             pool=rng.randn(B, R, D), alpha_w=rng.randn(H, 1) * 0.1,
             alpha_b=np.array([0.05]))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    att = rng.rand(B, R) < 0.2
    pnt = att | (rng.rand(B, R) < 0.2)
    if full_row:
        att[0] = pnt[0] = True
    return x, att, pnt


# R=40 exercises the Pallas kernel's ROI padding; R=128 is tile-aligned,
# so a fully masked row is uniform over the real ROIs in both versions
@pytest.mark.parametrize("R,full_row", [(40, False), (128, True)])
def test_region_attention_plain_matches_pallas(R, full_row):
    B, H, D = 3, 32, 64
    x, att, pnt = _region_inputs(B, R, H, D, 0, full_row)
    ref_res, ref_grd = pallas_region_attention(
        jnp.asarray(x["p_pool"]), jnp.asarray(x["att_h"]),
        jnp.asarray(x["pool"]), jnp.asarray(x["alpha_w"]),
        jnp.asarray(x["alpha_b"]), jnp.asarray(att), jnp.asarray(pnt),
        interpret=True)
    args = (_t(x["p_pool"]), _t(x["att_h"]), _t(x["pool"]),
            _t(x["alpha_w"]), _t(x["alpha_b"]), torch.from_numpy(att),
            torch.from_numpy(pnt))
    res, grd = fused_region_attention_plain(*args)
    np.testing.assert_allclose(_np(res), np.asarray(ref_res), atol=1e-5)
    np.testing.assert_allclose(_np(grd), np.asarray(ref_grd), atol=1e-3)
    if full_row:
        assert np.all(np.isfinite(_np(res)))
        assert np.all(_np(grd)[0] <= -1e7)
    # a CPU tensor takes the plain version and launches nothing
    _build.reset_launches()
    res2, grd2 = fused_region_attention(*args)
    assert torch.equal(res, res2) and torch.equal(grd, grd2)
    assert not _build.launches


def test_region_attention_plain_returns_input_dtype():
    x, att, pnt = _region_inputs(2, 16, 8, 8, 1, False)
    res, grd = fused_region_attention_plain(
        _t(x["p_pool"], torch.bfloat16), _t(x["att_h"], torch.bfloat16),
        _t(x["pool"], torch.bfloat16), _t(x["alpha_w"]), _t(x["alpha_b"]),
        torch.from_numpy(att), torch.from_numpy(pnt))
    assert res.dtype == grd.dtype == torch.bfloat16


def _gi_inputs(mode, T, B, D, H, seed):
    p = birnn_init(jax.random.PRNGKey(seed), D, H, 1, mode)["layers"][0]
    xs = np.random.RandomState(seed).randn(B, T, D).astype(np.float32)
    fwd, bwd = p["fwd"], p["bwd"]
    wi = jnp.stack([fwd["wi"], bwd["wi"]])
    wh = jnp.stack([fwd["wh"], bwd["wh"]])
    if mode == "bigru":
        bi = jnp.stack([fwd["bi"], bwd["bi"]])
        bh = jnp.stack([fwd["bh"], bwd["bh"]])
    else:
        bi, bh = jnp.stack([fwd["b"], bwd["b"]]), None
    gi = jnp.einsum("btd,kdg->tkbg", jnp.asarray(xs), wi) \
        + bi[None, :, None, :]
    gi = gi.at[:, 1].set(gi[::-1, 1])
    return gi, wh, bh


@pytest.mark.parametrize("mode", ["bigru", "bilstm"])
def test_birnn_recurrence_plain_matches_pallas(mode):
    T, B, D, H = 12, 4, 24, 16
    gi, wh, bh = _gi_inputs(mode, T, B, D, H, 0)
    ref = pallas_birnn(gi, wh, bh, mode=mode, hidden=H, interpret=True)
    args = (_t(gi), _t(wh), None if bh is None else _t(bh))
    out = birnn_recurrence_plain(*args, mode=mode, hidden=H)
    assert out.shape == (T, 2, B, H)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
    _build.reset_launches()
    assert torch.equal(out, birnn_recurrence(*args, mode=mode, hidden=H))
    assert not _build.launches


def _jax_recurrence(gi, wh, bh, mode):
    """K2's recurrence as the JAX package's own steps under a scan, both
    lanes vmapped: what ``jax.grad`` differentiates below."""
    from grounded_video_description_tpu.ops.pallas.birnn import (
        _gru_step, _lstm_step)
    h0 = jnp.zeros((gi.shape[2], wh.shape[1]), jnp.float32)

    def lane(g, w, b):
        if mode == "bigru":
            def step(h, x):
                h = _gru_step(h, x, w, b)
                return h, h
            return jax.lax.scan(step, h0, g)[1]

        def step(hc, x):
            hc = _lstm_step(*hc, x, w)
            return hc, hc[0]
        return jax.lax.scan(step, (h0, h0), g)[1]
    return jax.vmap(lane, in_axes=(1, 0, 0 if mode == "bigru" else None),
                    out_axes=1)(gi, wh, bh)


@pytest.mark.parametrize("mode", ["bigru", "bilstm"])
def test_birnn_train_twins_match_autograd_and_jax(mode):
    """K2's training route on the CPU: the forward twin's ys are the plain
    recurrence's and its saved gates give them back; the backward twin
    (the reverse recurrence, dW_hh as one product) gives the gradients of
    gi, W_hh and b_hh that autograd through the plain recurrence and
    ``jax.grad`` through the JAX package's steps give, within 1e-5; the
    route's Function gives the twins' gradients, and counts no launch."""
    T, B, D, H = 12, 5, 24, 16
    gi, wh, bh = _gi_inputs(mode, T, B, D, H, 1)
    w = np.random.RandomState(5).randn(T, 2, B, H).astype(np.float32)
    args = [_t(gi), _t(wh), None if bh is None else _t(bh)]
    ys, gates = birnn_forward_train_plain(*args, mode=mode, hidden=H)
    np.testing.assert_allclose(
        _np(ys), _np(birnn_recurrence_plain(*args, mode=mode, hidden=H)),
        atol=1e-6)
    hp = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    if mode == "bigru":
        r, z, n, hn = gates.unbind(3)
        back = (1 - z) * n + z * hp
    else:
        i, f, g, o, c = gates.unbind(3)
        back = o * torch.tanh(c)
        c_old = torch.cat([torch.zeros_like(c[:1]), c[:-1]])
        np.testing.assert_allclose(_np(c), _np(f * c_old + i * g), atol=1e-6)
    np.testing.assert_allclose(_np(back), _np(ys), atol=1e-6)

    n_args = 3 if mode == "bigru" else 2
    dgi, dwh, dbh = birnn_backward_plain(_t(w), ys, gates, args[1],
                                         mode=mode)
    got = [dgi, dwh, dbh][:n_args]
    leaves = [a.clone().requires_grad_(True) for a in args[:n_args]]
    out = birnn_recurrence_plain(*(leaves + [None] * (3 - n_args)),
                                 mode=mode, hidden=H)
    auto = torch.autograd.grad((out * _t(w)).sum(), leaves)
    jax_grads = jax.grad(
        lambda *a: jnp.sum(_jax_recurrence(*a, mode) * w),
        argnums=tuple(range(n_args)))(gi, wh, bh)
    _build.reset_launches()
    leaves = [a.clone().requires_grad_(True) for a in args[:n_args]]
    out = birnn_recurrence_train(*(leaves + [None] * (3 - n_args)),
                                 mode=mode, hidden=H)
    route = torch.autograd.grad((out * _t(w)).sum(), leaves)
    assert not _build.launches
    for name, a, b, j, r in zip(("gi", "wh", "bh"), got, auto, jax_grads,
                                route):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, err_msg=name)
        np.testing.assert_allclose(_np(a), np.asarray(j), atol=1e-5,
                                   err_msg=name)
        assert torch.equal(a, r), name


def _encoder_pair(D, HID, layers, seed):
    params = jxf.encoder_init(jax.random.PRNGKey(seed), D, HID, layers)
    enc = txf.Encoder(D, HID, layers)
    enc.load_state_dict(encoder_state_dict(params))
    return params, enc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_layer_plain_matches_pallas(dtype):
    """Six uneven heads (11 x 5 + 9 at D=64) at an unaligned B=5, R=150
    in f32; the bf16 case holds the JAX package's own bf16 bar."""
    D, HEADS, HID = 64, 6, 32
    B, R = (5, 150) if dtype == "float32" else (4, 128)
    params, enc = _encoder_pair(D, HID, 2, 0)
    x = np.random.RandomState(1).randn(B, R, D).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = pallas_encoder(params, jnp.asarray(x, jdt), n_heads=HEADS, bt=2,
                         interpret=True)
    weights = [lp.weights() for lp in enc.layers]
    with torch.no_grad():
        got, h = [], _t(x, tdt)
        for w in weights:
            h = fused_encoder_layer_plain(h, w, n_heads=HEADS)
            got.append(h)
        _build.reset_launches()
        via_wrapper = txf.encoder_apply(enc, _t(x, tdt), n_heads=HEADS,
                                        use_kernel=True)
    assert not _build.launches
    assert len(got) == len(ref) == 2
    for g, r, w in zip(got, ref, via_wrapper):
        assert g.dtype == tdt and torch.equal(g, w)
        diff = np.abs(_np(g) - np.asarray(r, np.float32)).max()
        assert diff < (2e-5 if dtype == "float32" else 0.1), diff


@pytest.mark.parametrize("D,R", [(64, 70), (1024, 9)])
def test_qkv_repack_matches_jax_head_slots(D, R):
    """K1's bf16 attention reads q, k and v from the (B, R, 3D) QKV buffer
    at column offsets 0, D, 2D, rows 3D apart, into one zero-padded slot
    per head, rows padded to the tile.  Its plain version puts the same
    values in the same slots as the JAX kernel's ``pack_layer_params``
    (q = x cols(wq), head h in columns [h dp, h dp + |h|)), up to the
    JAX slot width (16 at D = 64, 176 at the flagship's 171 x 5 + 169),
    and zeros past it.  On a CPU tensor ``pack_qkv`` is that plain
    version."""
    HEADS, B = 6, 2
    params, enc = _encoder_pair(D, D // 2, 1, 4)
    lp = params["layers"][0]
    x = np.random.RandomState(5).randn(B, R, D).astype(np.float32)
    w = enc.layers[0].weights()
    with torch.no_grad():
        qkv = torch.nn.functional.linear(
            _t(x), torch.cat([w.wq, w.wk, w.wv]))
        got = qkv_heads_plain(qkv, HEADS)
        assert torch.equal(pack_qkv(qkv, HEADS), got)
    assert got.shape[:4] == (3, B, HEADS, -(-R // 64) * 64)
    packed = pack_layer_params(lp, HEADS, jnp.float32)
    for i in range(3):                       # q, k, v
        ref = np.asarray(jnp.asarray(x) @ packed[i])     # (B, R, h * dp)
        dpj = ref.shape[-1] // HEADS
        ref = ref.reshape(B, R, HEADS, dpj).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(_np(got[i, :, :, :R, :dpj]), ref,
                                   atol=1e-5)
        assert not got[i, :, :, :R, dpj:].any()
        assert not got[i, :, :, R:].any()


def test_encoder_kernel_twin_matches_head_sequential_encoder():
    """The model's encoder, with and without the kernel flag (K1's plain
    twin on CPU tensors either way), against the JAX package's
    head-sequential XLA encoder at f32."""
    params, enc = _encoder_pair(64, 32, 2, 3)
    x = np.random.RandomState(0).randn(3, 40, 64).astype(np.float32)
    ref = jxf.encoder_apply(params, jnp.asarray(x), n_heads=6, drop=0.0)
    with torch.no_grad():
        a = txf.encoder_apply(enc, _t(x), n_heads=6)
        b = txf.encoder_apply(enc, _t(x), n_heads=6, use_kernel=True)
    assert len(a) == len(b) == len(ref) == 2
    for u, v, r in zip(a, b, ref):
        assert torch.equal(u, v)
        np.testing.assert_allclose(_np(u), np.asarray(r), atol=2e-5)


def test_inference_kernels_refuse_inputs_that_need_grad():
    """K1, K2 and K3 have no backward: their outputs are written through
    raw pointers and would carry no grad_fn.  Each wrapper raises under
    grad mode when an input requires grad, on CPU tensors too (the check
    comes before the device branch), and runs under no_grad."""
    x, att, pnt = _region_inputs(2, 16, 8, 8, 1, False)
    region = [_t(x["p_pool"]), _t(x["att_h"]), _t(x["pool"]),
              _t(x["alpha_w"]), _t(x["alpha_b"])]
    region[3].requires_grad_(True)
    masks = (torch.from_numpy(att), torch.from_numpy(pnt))
    gi, wh, bh = (None if a is None else _t(a)
                  for a in _gi_inputs("bigru", 5, 2, 6, 4, 0))
    gi.requires_grad_(True)
    _, enc = _encoder_pair(12, 8, 1, 0)
    w = enc.layers[0].weights()
    calls = [
        lambda: fused_region_attention(*region, *masks),
        lambda: birnn_recurrence(gi, wh, bh, mode="bigru", hidden=4),
        lambda: fused_encoder_layer(torch.zeros(1, 3, 12), w, n_heads=6)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
