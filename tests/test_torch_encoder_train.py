"""PyTorch port, K5: the whole obj_interact encoder layer in training.

K5's plain twin (``fused_encoder_layer_train_plain``, the version CPU
tensors take) against the JAX package's Pallas kernel in interpret mode
at tests/test_pallas_train.py's shapes (B = 3, R = 200 so Rp = 256,
D = 32, six heads, FFN 24): the hash masks bit for bit, the forward, and
dx with all twelve weight gradients against ``jax.grad`` through the
kernel's custom VJP (its hand-written ``_bwd_kernel``), differentiated
through ``pack_layer_params`` with respect to the layer's own params.
Then the dispatch: the seeds per layer, and the flag that routes the
encoder and the model through K5."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_description_tpu.config import (
    tiny_test_config as jax_tiny_config)
from grounded_video_description_tpu.models import transformer as jxf
from grounded_video_description_tpu.ops.pallas.encoder_layer import (
    pack_layer_params)
from grounded_video_description_tpu.ops.pallas.encoder_layer_train import (
    _SITE_PROBS, _SITE_RESID1, _SITE_RESID2, fused_encoder_layer_train as
    jax_fused_encoder_layer_train, uniform_hash as jax_uniform_hash)
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.data import synthetic_batch
from grounded_video_description_torch.models import GVDModel
from grounded_video_description_torch.models import transformer as txf
from grounded_video_description_torch.models.gvd import batch_to_tensors
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.ops.kernels import (
    encoder_layer_train as k5)
from grounded_video_description_torch.ops.kernels.attention_train import (
    draw_seed, uniform_hash)
from grounded_video_description_torch.weights import encoder_state_dict

B, R, D, HEADS, HID = 3, 200, 32, 6, 24
RP = 256
JAX_SEED = -1234567                         # int32, as the JAX tests use
NAMES = ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2", "g1", "be1", "g2",
         "be2")
# port parameter name of each EncoderLayerWeights field
PORT_NAMES = dict(zip(NAMES, (
    "selfattn.layer.wq.weight", "selfattn.layer.wk.weight",
    "selfattn.layer.wv.weight", "selfattn.layer.wo.weight",
    "feedforward.layer.linear1.weight", "feedforward.layer.linear1.bias",
    "feedforward.layer.linear2.weight", "feedforward.layer.linear2.bias",
    "selfattn.layernorm.gamma", "selfattn.layernorm.beta",
    "feedforward.layernorm.gamma", "feedforward.layernorm.beta")))


def _seed():
    """The JAX int32 seed as the port's int64 (its uint32 value)."""
    return torch.tensor([JAX_SEED & 0xFFFFFFFF], dtype=torch.int64)


def _layer(key=0):
    """One JAX layer's params, with LayerNorm affines away from 1 and 0,
    and the same layer as a port encoder."""
    p = jxf.encoder_init(jax.random.PRNGKey(key), D, HID, 1)
    rng = np.random.RandomState(key + 10)
    for ln in ("ln1", "ln2"):
        p["layers"][0][ln] = {
            "gamma": jnp.asarray(1 + 0.2 * rng.randn(D), jnp.float32),
            "beta": jnp.asarray(0.2 * rng.randn(D), jnp.float32)}
    enc = txf.Encoder(D, HID, 1)
    enc.load_state_dict(encoder_state_dict(p))
    return p["layers"][0], enc


def _inputs():
    rng = np.random.RandomState(1)
    return (rng.randn(B, R, D).astype(np.float32),
            rng.randn(B, R, D).astype(np.float32))


@pytest.fixture(scope="module", params=[0.0, 0.3], ids=lambda d: f"drop{d}")
def jax_ref(request):
    """The interpret-mode kernel's output, and its VJP for the cotangent w
    with respect to x and the layer's own (unpacked) params."""
    drop = request.param
    lp, _ = _layer()
    x, w = _inputs()

    def layer(lp, x):
        packed = pack_layer_params(lp, HEADS, jnp.float32)
        return jax_fused_encoder_layer_train(
            x, packed, jnp.int32(JAX_SEED), drop, HEADS, 2, 1, True)

    out, vjp = jax.vjp(jax.jit(layer), lp, jnp.asarray(x))
    g_lp, g_x = vjp(jnp.asarray(w))
    grads = encoder_state_dict({"layers": [g_lp]}, prefix="")
    return dict(drop=drop, out=np.asarray(out), dx=np.asarray(g_x),
                grads={k: grads[f"layers.0.{v}"].numpy()
                       for k, v in PORT_NAMES.items()})


def test_uniform_hash_matches_jax_at_k5_sites():
    """The port's hash equals JAX's bit for bit at the prob site (an
    (Rp, Rp) counter, salt 0x10000000 + b * 8 + h) and both residual sites
    (an (Rp, D) counter, salt site + b), for a negative int32 seed."""
    seed = _seed()
    for b, h in ((0, 0), (2, 5)):
        salt = int(_SITE_PROBS) + b * k5.SALT_MUL + h
        assert salt == k5.SITE_PROBS + b * 8 + h
        ref = jax_uniform_hash((RP, RP), jnp.int32(JAX_SEED),
                               np.uint32(salt))
        got = uniform_hash((RP, RP), seed, torch.tensor(salt))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for site, jsite in ((k5.SITE_RESID1, _SITE_RESID1),
                        (k5.SITE_RESID2, _SITE_RESID2)):
        assert site == int(jsite)
        ref = jax_uniform_hash((RP, D), jnp.int32(JAX_SEED),
                               jsite + np.uint32(2))
        got = uniform_hash((R, D), seed, torch.tensor(site + 2))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[:R])


def test_twin_forward_matches_jax_kernel(jax_ref):
    """f32 on both sides, sums in another order: within 2e-5 (the JAX
    kernel's own bar against its oracle)."""
    _, enc = _layer()
    x, _ = _inputs()
    with torch.no_grad():
        got = k5.fused_encoder_layer_train_plain(
            torch.from_numpy(x), enc.layers[0].weights(), _seed(),
            n_heads=HEADS, drop=jax_ref["drop"])
    np.testing.assert_allclose(got.numpy(), jax_ref["out"], rtol=2e-5,
                               atol=2e-5)


def test_twin_gradients_match_jax_custom_vjp(jax_ref):
    """dx and the twelve weight gradients against the JAX kernel's
    hand-written backward, scaled by each tensor's largest magnitude:
    rtol 5e-4, atol 5e-5 (tests/test_pallas_train.py's bar)."""
    _, enc = _layer()
    x, w = _inputs()
    xt = torch.from_numpy(x).requires_grad_(True)
    lw = enc.layers[0].weights()
    out = k5.fused_encoder_layer_train(xt, lw, _seed(), n_heads=HEADS,
                                       drop=jax_ref["drop"])
    (out * torch.from_numpy(w)).sum().backward()
    pairs = [("x", xt.grad, jax_ref["dx"])] + [
        (n, getattr(lw, n).grad, jax_ref["grads"][n]) for n in NAMES]
    for name, a, b in pairs:
        scale = max(float(np.abs(b).max()), 1e-3)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=5e-4,
                                   atol=5e-5, err_msg=name)


def test_twin_at_drop0_is_the_ports_training_layer():
    """At drop 0 the twin is the port's own differentiable layer
    (``_encoder_layer_train``, plain attention) within 1e-5."""
    _, enc = _layer(3)
    x, _ = _inputs()
    lw = enc.layers[0].weights()
    with torch.no_grad():
        got = k5.fused_encoder_layer_train_plain(
            torch.from_numpy(x), lw, _seed(), n_heads=HEADS, drop=0.0)
        ref = txf._encoder_layer_train(lw, torch.from_numpy(x),
                                       n_heads=HEADS, drop=0.0,
                                       generator=None, attn_train_impl="xla")
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_encoder_apply_fused_train_draws_one_seed_per_layer():
    """Each layer call gets its own seed from the generator (draw_seed),
    so two layers of the same weights apply different masks; without a
    generator, or at drop 0, the rate is 0 and the seeds are zero."""
    enc = txf.Encoder(D, HID, 2)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    enc.layers[1].load_state_dict(enc.layers[0].state_dict())
    x = torch.randn(2, 130, D, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        outs = txf.encoder_apply_fused_train(
            enc, x, n_heads=HEADS, drop=0.3,
            generator=torch.Generator().manual_seed(9))
        g = torch.Generator().manual_seed(9)
        s1, s2 = draw_seed(g), draw_seed(g)
        assert int(s1) != int(s2)
        lw = enc.layers[0].weights()
        y1 = k5.fused_encoder_layer_train_plain(x, lw, s1, n_heads=HEADS,
                                                drop=0.3)
        y2 = k5.fused_encoder_layer_train_plain(y1, lw, s2, n_heads=HEADS,
                                                drop=0.3)
        assert torch.equal(outs[0], y1) and torch.equal(outs[1], y2)
        same_seed = k5.fused_encoder_layer_train_plain(
            y1, lw, s1, n_heads=HEADS, drop=0.3)
        assert not torch.allclose(same_seed, y2, atol=1e-3)
        for kw in (dict(drop=0.3, generator=None),
                   dict(drop=0.0, generator=torch.Generator())):
            plain = txf.encoder_apply_fused_train(enc, x, n_heads=HEADS,
                                                  **kw)
            zero = torch.zeros(1, dtype=torch.int64)
            y = k5.fused_encoder_layer_train_plain(x, lw, zero,
                                                   n_heads=HEADS, drop=0.0)
            assert torch.equal(plain[0], y)


def test_flag_routes_encoder_and_model_through_k5(monkeypatch):
    """``encoder_apply(train=True, fused_train=True)`` and
    ``GVDModel.encode`` under ``use_pallas_encoder_train`` call K5's
    wrapper once per layer (before ``attn_train_impl`` is looked at); it
    is not called without the flag or at inference."""
    calls = []
    real = txf.fused_encoder_layer_train

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(txf, "fused_encoder_layer_train", counting)
    enc = txf.Encoder(D, HID, 2)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 20, D)
    for kw, n in ((dict(train=True, fused_train=True,
                        attn_train_impl="pallas"), 2),
                  (dict(train=True, fused_train=False), 0),
                  (dict(train=False, fused_train=True), 0)):
        calls.clear()
        with torch.no_grad():
            txf.encoder_apply(enc, x, n_heads=HEADS, **kw)
        assert len(calls) == n, kw

    jcfg = jax_tiny_config(obj_interact=True, enc_drop=0.2)
    for flag, n in ((True, 2), (False, 0)):
        cfg = tconfig.GVDConfig(**{
            f: getattr(jcfg, f) for f in tconfig.GVDConfig.__dataclass_fields__
            if f != "use_pallas_encoder_train"},
            use_pallas_encoder_train=flag).validate()
        model = GVDModel(cfg).init(torch.Generator().manual_seed(0))
        batch = batch_to_tensors(synthetic_batch(cfg, 2, seed=0), "cpu")
        calls.clear()
        with torch.no_grad():
            model.encode(batch, train=True,
                         generator=torch.Generator().manual_seed(1))
        assert len(calls) == n, flag


def test_cpu_tensors_never_reach_the_kernel_library(monkeypatch):
    """On CPU tensors the wrapper runs the twin, forward and backward,
    and loads no kernel library."""
    def no_lib():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "lib", no_lib)
    _build.reset_launches()
    _, enc = _layer()
    x = torch.randn(2, 40, D, requires_grad=True)
    out = k5.fused_encoder_layer_train(x, enc.layers[0].weights(), _seed(),
                                       n_heads=HEADS, drop=0.3)
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert not _build.launches


def _flash_loop(z, v, keep, dt):
    """The bf16 forward kernel's loop, written out: 64-key tiles, a running
    row max, the f32 normaliser over the undropped probs, and each tile's
    dropped probs rounded to ``dt`` before their product with v."""
    B, R, _ = z.shape
    m = torch.full((B, R), -float("inf"))
    norm = torch.zeros(B, R)
    acc = torch.zeros(B, R, v.shape[-1])
    for k0 in range(0, R, k5.MMA_TILE):
        zt = z[..., k0:k0 + k5.MMA_TILE]
        m_new = torch.maximum(m, zt.amax(-1))
        corr = torch.exp(m - m_new)
        e = torch.exp(zt - m_new[..., None])
        norm = norm * corr + e.sum(-1)
        pt = (e * keep[..., k0:k0 + k5.MMA_TILE]).to(dt).float()
        acc = acc * corr[..., None] + pt @ v[:, k0:k0 + k5.MMA_TILE]
        m = m_new
    return acc / norm[..., None]


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_bf16_twin_rounds_probs_as_the_flash_kernel(drop, monkeypatch):
    """In bf16 the twin's P~ V equals the tensor-core forward's tiled
    online softmax with P~ rounded per tile (within f32 summation order,
    1e-5), and its gradients are the backward kernels': dv from P~ rounded
    to bf16, dp = dO v^T unrounded.  In f32 the twin takes neither
    rounding (its parity with the JAX kernel is tested above)."""
    rng = np.random.RandomState(4)
    z = torch.from_numpy(rng.randn(2, R, R).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, R, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, R, 8).astype(np.float32))
    u = uniform_hash((RP, RP), _seed(), torch.tensor([7, 8]))[:, :R, :R]
    keep = (torch.where(u >= drop, 1.0 / (1.0 - drop), 0.0) if drop > 0.0
            else torch.ones_like(z))
    p = torch.softmax(z, dim=-1)
    if drop > 0.0:
        p = k5._dropped(p, u, drop)
    rho = k5.flash_rounding(z, u if drop > 0.0 else None, drop,
                            torch.bfloat16)
    assert not torch.equal(rho, torch.ones_like(rho))
    pl = p.clone().requires_grad_(True)
    vl = v.clone().requires_grad_(True)
    out = k5._FlashPV.apply(pl, rho, vl, torch.bfloat16)
    torch.testing.assert_close(out, _flash_loop(z, v, keep, torch.bfloat16),
                               rtol=1e-5, atol=1e-5)
    out.backward(g)
    torch.testing.assert_close(pl.grad, g @ v.transpose(1, 2), rtol=0,
                               atol=0)
    torch.testing.assert_close(
        vl.grad, p.to(torch.bfloat16).float().transpose(1, 2) @ g, rtol=0,
        atol=0)
    # f32: the twin's attention is P~ V, with no rounding factor
    _, enc = _layer()
    x, _ = _inputs()
    calls = []
    orig = k5.flash_rounding
    monkeypatch.setattr(k5, "flash_rounding",
                        lambda *a: calls.append(a) or orig(*a))
    with torch.no_grad():
        k5.attention_sublayer_plain(torch.from_numpy(x),
                                    enc.layers[0].weights(), _seed(),
                                    n_heads=HEADS, drop=drop)
        assert not calls
        k5.attention_sublayer_plain(
            torch.from_numpy(x).to(torch.bfloat16), enc.layers[0].weights(),
            _seed(), n_heads=HEADS, drop=drop)
    assert len(calls) == HEADS
