"""PyTorch port, nn/core ops: the same inputs (numpy, seeded) through the
JAX function and its port, float32 on the CPU."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_description_tpu.nn import core as jcore
from grounded_video_description_torch.nn import core as tcore
from grounded_video_description_torch.weights import birnn_state_dict

ATOL = 1e-5     # f32, same math, different summation order


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), atol=atol,
                               rtol=0)


def test_linear_and_embedding():
    rng = np.random.RandomState(0)
    p = jcore.linear_init(jax.random.PRNGKey(0), 12, 7)
    x = rng.randn(3, 5, 12).astype(np.float32)
    _close(jcore.linear(p, jnp.asarray(x)),
           tcore.linear(_t(x), _t(np.asarray(p["w"]).T), _t(p["b"])))
    emb = jcore.embedding_init(jax.random.PRNGKey(1), 9, 4)
    ids = rng.randint(0, 9, (2, 6))
    _close(jcore.embedding(emb, jnp.asarray(ids)),
           tcore.embedding(_t(emb["w"]), torch.from_numpy(ids)))


def test_lstm_cell_fused_bias_goes_to_bias_ih():
    rng = np.random.RandomState(1)
    p = jcore.lstm_cell_init(jax.random.PRNGKey(2), 10, 8)
    cell = tcore.LSTMCellParams(10, 8)
    cell.load_state_dict({"weight_ih": _t(np.asarray(p["wi"]).T),
                          "weight_hh": _t(np.asarray(p["wh"]).T),
                          "bias_ih": _t(p["b"]),
                          "bias_hh": torch.zeros(32)})
    x, h, c = (rng.randn(4, d).astype(np.float32) for d in (10, 8, 8))
    jh, (_, jc) = jcore.lstm_cell(p, jnp.asarray(x),
                                  (jnp.asarray(h), jnp.asarray(c)))
    th, (_, tc) = tcore.lstm_cell(cell, _t(x), (_t(h), _t(c)))
    _close(jh, th)
    _close(jc, tc)


def test_gru_cell_keeps_both_biases():
    rng = np.random.RandomState(2)
    p = jcore._gru_cell_init(jax.random.PRNGKey(3), 10, 8)
    x, h = rng.randn(4, 10).astype(np.float32), rng.randn(4, 8).astype(
        np.float32)
    out = tcore._gru_cell(_t(x), _t(h), _t(np.asarray(p["wi"]).T),
                          _t(np.asarray(p["wh"]).T), _t(p["bi"]),
                          _t(p["bh"]))
    _close(jcore._gru_cell(p, jnp.asarray(x), jnp.asarray(h)), out)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode", ["bigru", "bilstm"])
def test_birnn_two_layers_matches_jax(mode, use_kernel):
    """Hoisted input projection, lane 1 time-reversed; with use_kernel
    a CPU tensor takes the kernel's plain version."""
    B, T, D, H = 3, 11, 12, 8
    p = jcore.birnn_init(jax.random.PRNGKey(4), D, H, 2, mode)
    x = np.random.RandomState(3).randn(B, T, D).astype(np.float32)
    ref = jcore.birnn(p, jnp.asarray(x), mode=mode, hidden=H)
    rnn = tcore.BiRNNParams(D, H, 2, mode)
    rnn.load_state_dict(birnn_state_dict(p))
    with torch.no_grad():
        out = tcore.birnn(rnn, _t(x), use_kernel=use_kernel)
    assert out.shape == (B, T, 2 * H)
    _close(ref, out)


def test_layer_norms():
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 5, 16) * 3 + 1).astype(np.float32)
    _close(jcore.layer_norm(jnp.asarray(x)), tcore.layer_norm(_t(x)))
    g, b = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    for use_std in (False, True):
        ref = jcore.layer_norm_affine({"gamma": g, "beta": b},
                                      jnp.asarray(x), use_std=use_std)
        _close(ref, tcore.layer_norm_affine(_t(g), _t(b), _t(x),
                                            use_std=use_std))
    # the unbiased-std variant is not torch.nn.LayerNorm
    ln = torch.nn.functional.layer_norm(_t(x), (16,), _t(g), _t(b), 1e-6)
    std = tcore.layer_norm_affine(_t(g), _t(b), _t(x), use_std=True)
    assert float((ln - std).abs().max()) > 1e-3


def test_batch_norm_eval_uses_running_statistics():
    rng = np.random.RandomState(5)
    C = 6
    params = {"gamma": rng.randn(C).astype(np.float32),
              "beta": rng.randn(C).astype(np.float32)}
    state = {"mean": rng.randn(C).astype(np.float32),
             "var": rng.rand(C).astype(np.float32) + 0.5,
             "count": np.float32(3)}
    x = rng.randn(2, 4, C).astype(np.float32)
    ref, new_state = jcore.batch_norm(params, state, jnp.asarray(x),
                                      train=False)
    bn = torch.nn.BatchNorm1d(C)
    bn.load_state_dict({"weight": _t(params["gamma"]),
                        "bias": _t(params["beta"]),
                        "running_mean": _t(state["mean"]),
                        "running_var": _t(state["var"]),
                        "num_batches_tracked": torch.tensor(3)})
    _close(ref, tcore.batch_norm(bn, _t(x)))


def test_dropout_is_identity_at_eval():
    """The identity at eval, and in training at rate 0 or without a
    generator (the JAX package's dropout without an rng)."""
    x = torch.randn(4, 5)
    g = torch.Generator().manual_seed(0)
    assert tcore.dropout(x, 0.5, train=False, generator=g) is x
    assert tcore.dropout(x, 0.0, train=True, generator=g) is x
    assert tcore.dropout(x, 0.5, train=True) is x
