"""PyTorch port, int8 attention banks (``--quantize_banks``) against the
JAX package on the CPU: ``quantize_rows`` (per 128-column group, the
per-row fallbacks, round half to even on exact .5 ties), ``dequantize``,
the temporal and region attentions over a ``QuantBank``, and greedy
decoding over quantized banks, which takes the step loop and not K6."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_description_tpu import config as jconfig
from grounded_video_description_tpu.data.synthetic import (
    synthetic_batch as jax_synthetic_batch)
from grounded_video_description_tpu.models import GVDModel as JaxModel
from grounded_video_description_tpu.ops import attention as jatt
from grounded_video_description_tpu.ops import quantize as jq
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.data import synthetic_batch
from grounded_video_description_torch.models import (
    GVDModel, batch_to_tensors)
from grounded_video_description_torch.models import gvd as tgvd
from grounded_video_description_torch.ops import attention as tatt
from grounded_video_description_torch.ops import quantize as tq
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.weights import from_jax_variables

B = 3


def _ties(shape, group):
    """Values k + 0.5 with one 127 per scale group, so that every scale is
    exactly 1 and every other value an exact tie."""
    g = np.random.default_rng(4)
    x = (g.integers(-60, 60, shape) + 0.5).astype(np.float32)
    x[..., ::group] = 127.0
    return x


# name: (x, group_size)
_CASES = {
    "groups": (np.random.default_rng(0).standard_normal((3, 5, 1024))
               .astype(np.float32) * 3, 128),
    "outlier": (np.random.default_rng(1).standard_normal((2, 4, 512))
                .astype(np.float32) * np.where(np.arange(512) == 7, 50.0,
                                               1.0).astype(np.float32), 128),
    "per-row": (np.random.default_rng(2).standard_normal((2, 4, 256))
                .astype(np.float32), 0),
    "width-not-divisible": (np.random.default_rng(3).standard_normal(
        (2, 4, 100)).astype(np.float32), 128),
    "width-equals-group": (np.random.default_rng(5).standard_normal(
        (2, 4, 128)).astype(np.float32), 128),
    "ties-groups": (_ties((2, 3, 256), 128), 128),
    "ties-per-row": (_ties((2, 3, 64), 64), 0),
    "zero-row": (np.zeros((2, 3, 256), np.float32), 128),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_quantize_rows_matches_jax(case):
    """int8 values equal, scales within 1e-7, the JAX package's scale
    shape (groups, or one a row), and dequantize equal in f32 and bf16."""
    x, group = _CASES[case]
    got = tq.quantize_rows(torch.from_numpy(x), group)
    want = jq.quantize_rows(jnp.asarray(x), group_size=group or None)
    assert got.values.dtype == torch.int8
    assert got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    assert got.scale.shape == want.scale.shape
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=0, atol=1e-7)
    if case.startswith("ties"):
        # round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0
        q = got.values.numpy().astype(np.float32)
        np.testing.assert_array_equal(q, np.round(np.clip(x, -127, 127)))
        assert np.any(np.abs(x - np.trunc(x)) == 0.5)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        deq = tq.dequantize(got, tdt)
        assert deq.dtype == tdt
        np.testing.assert_array_equal(
            deq.float().numpy(),
            np.asarray(jq.dequantize(want, jdt).astype(jnp.float32)))
    t = torch.from_numpy(x)
    assert tq.dequantize(t) is t


def _models(**kw):
    cfg = jconfig.tiny_test_config(obj_interact=True, use_pallas=False,
                                   quantize_banks=True, **kw)
    jm = JaxModel(cfg)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    tcfg = tconfig.GVDConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(tconfig.GVDConfig)}).validate()
    port = GVDModel(tcfg)
    port.load_state_dict(from_jax_variables(variables))
    return cfg, jm, variables, tcfg, port.eval()


@pytest.mark.parametrize("group", [16, 0])
def test_attentions_take_a_quantbank(group):
    """temporal_attention and region_attention (mix, through the plain
    twin and with the K3 flag on a CPU tensor) over QuantBanks give the
    JAX attentions' outputs over the same QuantBanks (1e-5)."""
    _, _, variables, _, port = _models(quantize_group_size=group)
    g = np.random.default_rng(7)
    h = g.standard_normal((B, 64)).astype(np.float32)
    feats = g.standard_normal((B, 20, 64)).astype(np.float32)
    pfeats = g.standard_normal((B, 20, 32)).astype(np.float32)
    mask = g.random((B, 20)) < 0.3
    core = variables["params"]["core"]
    jbanks = [jq.quantize_rows(jnp.asarray(a), group_size=group or None)
              for a in (feats, pfeats)]
    tbanks = [tq.quantize_rows(torch.from_numpy(a), group)
              for a in (feats, pfeats)]
    want = jatt.temporal_attention(core["attn"], jnp.asarray(h), *jbanks)
    got = tatt.temporal_attention(port.core.attention, torch.from_numpy(h),
                                  *tbanks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    jm = jnp.asarray(mask)
    want = jatt.region_attention(core["attn2"], jnp.asarray(h), *jbanks, jm,
                                 jm, mode="mix")
    for use_kernel in (False, True):
        with torch.no_grad():
            got = tatt.region_attention(
                port.core.attention2, torch.from_numpy(h), *tbanks,
                torch.from_numpy(mask), torch.from_numpy(mask), mode="mix",
                use_kernel=use_kernel)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("group", [16, 0])
def test_quantized_greedy_matches_jax(group, monkeypatch):
    """sample_greedy with quantize_banks (16-column groups, and one scale
    a row): tokens identical to the JAX package's, logprobs and att2
    within 1e-4.  With the K6 and K3 flags on, CPU tensors take the step
    loop (K6 is not called at all) and launch nothing."""
    cfg, jm, variables, tcfg, port = _models(quantize_group_size=group)
    jb = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(
        cfg, B, seed=2).items() if k != "seg_id"}
    want = [np.asarray(o) for o in jax.jit(jm.sample_greedy)(variables, jb)]
    batch = batch_to_tensors(synthetic_batch(tcfg, B, seed=2), "cpu")

    def no_k6(*a, **k):
        raise AssertionError("quantize_banks decodes with the step loop")

    monkeypatch.setattr(tgvd, "greedy_decode_fused", no_k6)
    for flags in (False, True):
        port.cfg = tcfg.replace(use_pallas=flags, use_pallas_decode=flags)
        _build.reset_launches()
        seq, lp, att2, sim = port.sample_greedy(batch)
        assert not _build.launches
        np.testing.assert_array_equal(seq.numpy(), want[0])
        np.testing.assert_allclose(lp.numpy(), want[1], atol=1e-4)
        np.testing.assert_allclose(att2.numpy(), want[2], atol=1e-4)
        np.testing.assert_allclose(sim.numpy(), want[3], atol=1e-4)
