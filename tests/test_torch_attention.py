"""PyTorch port, attention ops: region attention in all five modes,
temporal attention and the grounder against the JAX ops, f32 on the
CPU, from seeded numpy inputs."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from grounded_video_description_tpu.ops import attention as jatt
from grounded_video_description_torch.ops import attention as tatt

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _pair(rng, rnn, hid, alpha_in):
    """JAX params dict and the port module holding the same weights."""
    jp = {"h2att": {"w": rng.randn(rnn, hid).astype(np.float32) * 0.3,
                    "b": rng.randn(hid).astype(np.float32) * 0.1}}
    m = nn.Module()
    m.h2att = nn.Linear(rnn, hid)
    if alpha_in:
        jp["alpha_net"] = {"w": rng.randn(alpha_in, 1).astype(np.float32),
                           "b": rng.randn(1).astype(np.float32)}
        m.alpha_net = nn.Linear(alpha_in, 1)
    with torch.no_grad():
        for name, d in jp.items():
            getattr(m, name).weight.copy_(_t(d["w"].T))
            getattr(m, name).bias.copy_(_t(d["b"]))
    return jp, m


@pytest.mark.parametrize("mode", ["add", "mix", "mix_mul", "cat", "dp"])
def test_region_attention_modes_match_jax(mode):
    rng = np.random.RandomState(0)
    B, R, rnn, hid = 3, 17, 20, 12
    alpha_in = {"cat": 2 * hid, "dp": 0}.get(mode, hid)
    jp, m = _pair(rng, rnn, hid, alpha_in)
    h = rng.randn(B, rnn).astype(np.float32)
    pool = rng.randn(B, R, rnn).astype(np.float32)
    p_pool = rng.randn(B, R, hid).astype(np.float32)
    att = rng.rand(B, R) < 0.3
    pnt = att | (rng.rand(B, R) < 0.3)
    att[1] = pnt[1] = True                  # fully masked row: uniform
    ref = jatt.region_attention(jp, jnp.asarray(h), jnp.asarray(pool),
                                jnp.asarray(p_pool), jnp.asarray(att),
                                jnp.asarray(pnt), mode=mode)
    with torch.no_grad():
        got = tatt.region_attention(m, _t(h), _t(pool), _t(p_pool),
                                    torch.from_numpy(att),
                                    torch.from_numpy(pnt), mode=mode)
        if mode in ("add", "mix"):          # K3's CPU dispatch: its twin
            via_kernel = tatt.region_attention(
                m, _t(h), _t(pool), _t(p_pool), torch.from_numpy(att),
                torch.from_numpy(pnt), mode=mode, use_kernel=True)
            for a, b in zip(got, via_kernel):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(np.asarray(r), g.numpy(), atol=ATOL)
    assert np.all(got[1].numpy()[pnt] == -1e8)


def test_region_attention_rejects_unknown_mode():
    _, m = _pair(np.random.RandomState(1), 4, 4, 4)
    with pytest.raises(ValueError):
        tatt.region_attention(m, torch.zeros(1, 4), torch.zeros(1, 2, 4),
                              torch.zeros(1, 2, 4),
                              torch.zeros(1, 2, dtype=torch.bool),
                              torch.zeros(1, 2, dtype=torch.bool),
                              mode="nope")


def test_temporal_attention_matches_jax():
    rng = np.random.RandomState(2)
    B, T, rnn, hid = 3, 9, 16, 10
    jp, m = _pair(rng, rnn, hid, hid)
    h = rng.randn(B, rnn).astype(np.float32)
    feats = rng.randn(B, T, rnn).astype(np.float32)
    p_feats = rng.randn(B, T, hid).astype(np.float32)
    ref = jatt.temporal_attention(jp, jnp.asarray(h), jnp.asarray(feats),
                                  jnp.asarray(p_feats))
    with torch.no_grad():
        got = tatt.temporal_attention(m, _t(h), _t(feats), _t(p_feats))
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=ATOL)


@pytest.mark.parametrize("kind", ["dot", "add", "cat"])
@pytest.mark.parametrize("mask_ndim", [2, 3])
def test_grounder_matches_jax(kind, mask_ndim):
    rng = np.random.RandomState(3)
    B, S, R, E = 2, 5, 7, 6
    xt = rng.randn(B, S, E).astype(np.float32)
    feats = rng.randn(B, R, E).astype(np.float32)
    mask = rng.rand(*((B, R) if mask_ndim == 2 else (B, S, R))) < 0.3
    bias = rng.randn(B, S, R).astype(np.float32)
    jalpha, talpha = None, None
    if kind != "dot":
        width = 2 * E if kind == "cat" else E
        w, b = rng.randn(width, 1).astype(np.float32), np.float32([0.2])
        jalpha = {"w": w, "b": b}
        talpha = nn.Linear(width, 1)
        with torch.no_grad():
            talpha.weight.copy_(_t(w.T))
            talpha.bias.copy_(_t(b))
    ref = jatt.grounder(jnp.asarray(xt), jnp.asarray(feats),
                        jnp.asarray(mask), jnp.asarray(bias),
                        alpha_params=jalpha, additive_cat=kind == "cat")
    with torch.no_grad():
        got = tatt.grounder(_t(xt), _t(feats), torch.from_numpy(mask),
                            _t(bias), alpha_net=talpha,
                            additive_cat=kind == "cat")
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=ATOL)
