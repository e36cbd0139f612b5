"""PyTorch port, the evaluation slice's kernels on the CPU: K6's plain twin
(the port's greedy step loop) against the interpret-mode Pallas
``greedy_decode_fused``, K7's plain twin against the interpret-mode
Pallas ``flash_self_attention``, and the obj_interact encoder and
``sample_greedy`` with the K6/K7 flags on against the JAX model (f32).
The CUDA kernels are tested on the card by tests/test_torch_cuda.py."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_description_tpu.config import tiny_test_config
from grounded_video_description_tpu.data.synthetic import (
    synthetic_batch as jax_synthetic_batch)
from grounded_video_description_tpu.models import GVDModel as JaxModel
from grounded_video_description_tpu.ops.pallas.decode_scan import (
    greedy_decode_fused as pallas_decode)
from grounded_video_description_tpu.ops.pallas.mha import (
    flash_self_attention as pallas_mha)
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.data import synthetic_batch
from grounded_video_description_torch.models import (
    GVDModel, batch_to_tensors)
from grounded_video_description_torch.models import transformer as txf
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.ops.kernels.decode_scan import (
    greedy_decode_fused, greedy_decode_fused_plain)
from grounded_video_description_torch.ops.kernels.mha import (
    flash_self_attention, flash_self_attention_plain)
from grounded_video_description_torch.weights import from_jax_variables

BANKS = ("fc_feats", "conv_feats", "p_conv_feats", "pool_feats",
         "p_pool_feats")


def _tcfg(jcfg, **kw):
    import dataclasses
    return tconfig.GVDConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tconfig.GVDConfig)}).replace(**kw)


def _port(jcfg, params, state, **kw):
    m = GVDModel(_tcfg(jcfg, **kw))
    m.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, {"params": params, "state": state})))
    return m.eval()


@pytest.fixture(scope="module")
def decode_setup():
    """tests/test_pallas_decode.py's setup: tiny config, batch 4."""
    cfg = tiny_test_config(batch_size=4, obj_interact=True)
    model = JaxModel(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v)
             for k, v in jax_synthetic_batch(cfg, 4, seed=1).items()
             if k != "seg_id"}
    return cfg, model, variables, batch


def _run_both(cfg, model, params, state, batch):
    enc, _ = model.encode(params, state, batch, train=False, rng=None)
    ref = pallas_decode(params, enc, enc["pnt_mask"],
                        seq_length=cfg.seq_length, vocab_size=cfg.vocab_size,
                        unk_idx=model.unk_idx, bt=2, interpret=True)
    port = _port(cfg, params, state)
    tenc = {k: torch.from_numpy(np.array(enc[k])) for k in BANKS}
    pnt = torch.from_numpy(np.array(enc["pnt_mask"]))
    with torch.no_grad():
        got = greedy_decode_fused_plain(port, tenc, pnt)
        _build.reset_launches()
        via_wrapper = greedy_decode_fused(port, tenc, pnt)
    assert not _build.launches            # CPU tensors: the plain twin
    for a, b in zip(got, via_wrapper):
        assert torch.equal(a, b)
    return [np.asarray(r) for r in ref], [t.numpy() for t in got], port


def test_decode_plain_matches_pallas(decode_setup):
    """Tokens identical, logprobs within 1e-5, live grounding logits
    within 1e-4 and masked ones below -1e7 on both sides
    (tests/test_pallas_decode.py:29-48's bars)."""
    cfg, model, variables, batch = decode_setup
    (rseq, rlp, ratt2), (seq, lp, att2), _ = _run_both(
        cfg, model, variables["params"], variables["state"], batch)
    assert seq.dtype == np.int32 and seq.shape == rseq.shape
    np.testing.assert_array_equal(seq, rseq)
    np.testing.assert_allclose(lp, rlp, rtol=1e-5, atol=1e-5)
    live = ratt2 > -1e7
    assert live.any()
    np.testing.assert_allclose(att2[live], ratt2[live], rtol=1e-4, atol=1e-4)
    assert np.all(att2[~live] < -1e7)


def test_decode_plain_unk_suppression_matches_pallas(decode_setup):
    """UNK forced onto the argmax by a biased logit head: both emit the
    runner-up (tests/test_pallas_decode.py:51-77)."""
    cfg, model, variables, batch = decode_setup
    params = dict(jax.tree.map(jnp.asarray, variables["params"]))
    b = np.zeros(np.shape(params["logit"]["b"]), np.float32)
    b[model.unk_idx] = 50.0
    params["logit"] = {"w": params["logit"]["w"] * 0.01,
                       "b": jnp.asarray(b)}
    (rseq, rlp, _), (seq, lp, _), port = _run_both(
        cfg, model, params, variables["state"], batch)
    assert not np.any(rseq == model.unk_idx)
    assert port.unk_idx == model.unk_idx
    np.testing.assert_array_equal(seq, rseq)
    np.testing.assert_allclose(lp, rlp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,R,d", [(3, 200, 171), (2, 130, 9)])
def test_flash_self_attention_plain_matches_pallas(N, R, d):
    """R not a multiple of 128 (the Pallas kernel pads and masks the
    keys), odd head widths; f32 within 1e-5."""
    rng = np.random.RandomState(R)
    q, k, v = (rng.randn(N, R, d).astype(np.float32) for _ in range(3))
    q *= 1.0 / np.sqrt(6 * d)                       # pre-scaled, as called
    ref = np.asarray(pallas_mha(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_self_attention_plain(tq, tk, tv)
    assert got.shape == (N, R, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    _build.reset_launches()
    assert torch.equal(flash_self_attention(tq, tk, tv), got)
    assert not _build.launches
    assert flash_self_attention_plain(
        tq.bfloat16(), tk.bfloat16(), tv.bfloat16()).dtype == torch.bfloat16


def test_new_wrappers_refuse_inputs_that_need_grad(decode_setup):
    """K6 and K7 have no backward; under grad mode an input that requires
    grad raises before the device branch, on CPU tensors too."""
    q = torch.zeros(2, 5, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_self_attention(q, q, q)
    cfg, model, variables, batch = decode_setup
    port = _port(cfg, variables["params"], variables["state"])
    enc = {k: torch.zeros(1) for k in BANKS}
    with pytest.raises(RuntimeError, match="no backward"):
        greedy_decode_fused(port, enc, torch.zeros(1, 2, dtype=torch.bool))


# R = 300 > 256: the obj_interact encoder takes K7's dispatch
R300 = dict(obj_interact=True, num_prop_per_frm=75)


@pytest.fixture(scope="module")
def r300_setup():
    cfg = tiny_test_config(use_pallas=False, **R300)
    model = JaxModel(cfg)
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3)))
    jb = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(
        cfg, 3, seed=2).items() if k != "seg_id"}
    enc, _ = jax.jit(lambda v, b: model.encode(
        v["params"], v["state"], b, train=False))(variables, jb)
    out = jax.jit(model.sample_greedy)(variables, jb)
    return dict(cfg=cfg, variables=variables,
                batch=synthetic_batch(_tcfg(cfg), 3, seed=2),
                enc=jax.tree.map(np.asarray, enc),
                out=[np.asarray(o) for o in out])


def _counting(monkeypatch):
    calls = []

    def counted(q, k, v):
        calls.append(tuple(q.shape))
        return flash_self_attention(q, k, v)

    monkeypatch.setattr(txf, "flash_self_attention", counted)
    return calls


def test_encode_through_flash_attention_matches_jax(r300_setup,
                                                    monkeypatch):
    """The port's encode with K1 off and K7 on (its plain twin on CPU
    tensors), heads padded 64 -> 6 x 11, against the JAX encoder's
    head-sequential attention at f32."""
    ref = r300_setup
    port = _port(ref["cfg"], ref["variables"]["params"],
                 ref["variables"]["state"], use_pallas_encoder=False,
                 use_pallas_mha=True)
    calls = _counting(monkeypatch)
    with torch.no_grad():
        enc = port.encode(batch_to_tensors(ref["batch"], "cpu"))
    assert calls == [(3 * 6, 300, 11)] * 2     # one call per layer
    for key in BANKS + ("g_pool_feats", "sim_mat_static"):
        np.testing.assert_allclose(enc[key].numpy(), ref["enc"][key],
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize("kernels", [False, True])
def test_sample_greedy_with_decode_and_mha_flags_matches_jax(r300_setup,
                                                            monkeypatch,
                                                            kernels):
    """sample_greedy at R = 300 with the evaluator's kernel flags (K6, K7,
    K3, K2 on, K1 off) and with every flag off: on CPU tensors each flag
    takes its plain twin, and the outputs equal the JAX model's (tokens
    identical, logprobs and att2 logits within 1e-4)."""
    ref = r300_setup
    port = _port(ref["cfg"], ref["variables"]["params"],
                 ref["variables"]["state"], use_pallas_encoder=False,
                 use_pallas_mha=kernels, use_pallas_decode=kernels,
                 use_pallas=kernels, use_pallas_rnn=kernels)
    calls = _counting(monkeypatch)
    _build.reset_launches()
    seq, lp, att2, sim = port.sample_greedy(
        batch_to_tensors(ref["batch"], "cpu"))
    assert not _build.launches
    assert len(calls) == (2 if kernels else 0)
    jseq, jlp, jatt2, jsim = ref["out"]
    assert seq.dtype == torch.int32 and lp.dtype == torch.float32
    np.testing.assert_array_equal(seq.numpy(), jseq)
    np.testing.assert_allclose(lp.numpy(), jlp, atol=1e-4)
    np.testing.assert_allclose(att2.numpy(), jatt2, atol=1e-4)
    np.testing.assert_allclose(sim.numpy(), jsim, atol=1e-4)
