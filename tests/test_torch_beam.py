"""PyTorch port, beam search against the JAX package on the CPU, f32, the
same weights through the weights bridge: ``sample_beam`` at W = 2, 3 and
5 (tokens, att2_ind and att2_frm_ind identical, logprobs within 1e-4),
the shared-bank beam attentions in every region mode (1e-5), ``_top_w``'s
order on rows with planted ties, and the evaluator at beam 3 writing the
JAX evaluator's densecap and attn-gen JSONs byte for byte."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from grounded_video_description_tpu import config as jconfig
from grounded_video_description_tpu.data.dataset import AnetDataset, Loader
from grounded_video_description_tpu.data.synthetic import (
    synthetic_batch as jax_synthetic_batch)
from grounded_video_description_tpu.engine.evaluator import (
    Evaluator as JaxEvaluator)
from grounded_video_description_tpu.models import GVDModel as JaxModel
from grounded_video_description_tpu.models import beam as jbeam
from grounded_video_description_tpu.ops import attention as jattn
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.data.synthetic_files import (
    write_synthetic_dataset)
from grounded_video_description_torch.data.vocab import VocabTables
from grounded_video_description_torch.engine.evaluator import Evaluator
from grounded_video_description_torch.models import (
    GVDModel, batch_to_tensors)
from grounded_video_description_torch.models import beam as tbeam
from grounded_video_description_torch.ops import attention as tattn
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.weights import from_jax_variables

# f32 on both sides, summation orders differ
ATOL = 1e-4
ATTN_ATOL = 1e-5
B = 3
WIDTHS = [2, 3, 5]
MODES = ["add", "mix", "mix_mul", "cat", "dp"]


def _tcfg(jcfg, **kw):
    return tconfig.GVDConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tconfig.GVDConfig)}).replace(**kw)


def _peaked(variables):
    """Init weights with the vocab head and the word embedding scaled up
    and EOS's logit raised: at plain init the tiny model's distribution is
    near uniform and every width decodes the same caption.  With these,
    the widths disagree: W = 2 ends every caption at the last step, W = 3
    and W = 5 harvest captions that stop at once on EOS."""
    p = dict(variables["params"])
    p["logit"] = {"w": p["logit"]["w"] * 8.0,
                  "b": p["logit"]["b"].at[0].add(0.8)}
    p["embed"] = {"w": p["embed"]["w"] * 3.0}
    return {"params": p, "state": variables["state"]}


@pytest.fixture(scope="module")
def jax_beams():
    """The JAX package's sample_beam on the tiny flagship-shaped config
    (BiGRU, mix, obj_interact) at each width, on one batch."""
    cfg = jconfig.tiny_test_config(obj_interact=True)
    model = JaxModel(cfg)
    variables = _peaked(model.init(jax.random.PRNGKey(0)))
    batch = jax_synthetic_batch(cfg, B, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "seg_id"}
    outs = {w: [np.asarray(o) for o in jax.jit(partial(
        model.sample_beam, beam_size=w))(variables, jb)] for w in WIDTHS}
    return dict(cfg=cfg, variables=jax.tree.map(np.asarray, variables),
                batch=batch, outs=outs)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
def test_sample_beam_matches_jax(jax_beams, width, kernels):
    """With the kernel flags on, CPU tensors take the plain versions and
    no kernel is launched."""
    cfg = _tcfg(jax_beams["cfg"], use_pallas=kernels, use_pallas_rnn=kernels,
                use_pallas_encoder=kernels, use_pallas_decode=kernels)
    model = GVDModel(cfg)
    model.load_state_dict(from_jax_variables(jax_beams["variables"]))
    _build.reset_launches()
    out = model.eval().sample_beam(batch_to_tensors(jax_beams["batch"],
                                                    "cpu"), beam_size=width)
    assert not _build.launches
    jseq, jlp, jatt2, jatt2f = jax_beams["outs"][width]
    seq, lp, att2, att2f = out
    L, F = cfg.seq_length, cfg.num_sampled_frm
    assert [tuple(t.shape) for t in out] == [(B, L), (B, L), (B, L),
                                             (B, L, F)]
    assert all(t.dtype == torch.int32 for t in (seq, att2, att2f))
    np.testing.assert_array_equal(seq.numpy(), jseq)
    np.testing.assert_array_equal(att2.numpy(), jatt2)
    np.testing.assert_array_equal(att2f.numpy(), jatt2f)
    np.testing.assert_allclose(lp.numpy(), jlp, atol=ATOL)


def test_the_reference_beams_fork_and_harvest(jax_beams):
    """What the comparison above covers: the widths decode different
    captions, and both harvests occur (a caption that ran to the last step
    with no EOS, one that stopped on EOS)."""
    seqs = {w: jax_beams["outs"][w][0] for w in WIDTHS}
    assert not np.array_equal(seqs[2], seqs[3])
    assert not np.array_equal(seqs[3], seqs[5])
    assert (seqs[2] > 0).all()
    assert (seqs[5] == 0).any() and (seqs[5] > 0).any()


def _attention_params(rng, rnn, hid, alpha_in):
    """A port attention module and the JAX dict of the same weights."""
    p = nn.Module()
    p.h2att = nn.Linear(rnn, hid)
    jp = {}
    if alpha_in:
        p.alpha_net = nn.Linear(alpha_in, 1)
    for name, lin in p.named_children():
        w = rng.randn(*lin.weight.shape).astype(np.float32) * 0.3
        b = rng.randn(*lin.bias.shape).astype(np.float32) * 0.3
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
            lin.bias.copy_(torch.from_numpy(b))
        jp[name] = {"w": jnp.asarray(w.T), "b": jnp.asarray(b)}
    return p, jp


@pytest.mark.parametrize("mode", MODES)
def test_region_attention_beam_matches_jax(mode):
    """Shared banks (B, R, *), h (B, W, rnn), a mask that covers some ROIs
    and a pnt mask that covers more; att_res, the grounding logits and
    att_h."""
    rng = np.random.RandomState(MODES.index(mode))
    Bn, W, R, rnn, hid = 2, 3, 7, 8, 6
    alpha_in = {"cat": 2 * hid, "dp": 0}.get(mode, hid)
    p, jp = _attention_params(rng, rnn, hid, alpha_in)
    h = rng.randn(Bn, W, rnn).astype(np.float32)
    pool = rng.randn(Bn, R, rnn).astype(np.float32)
    p_pool = rng.randn(Bn, R, hid).astype(np.float32)
    att_mask = rng.rand(Bn, R) < 0.3
    att_mask[:, 0] = False
    pnt_mask = att_mask | (rng.rand(Bn, R) < 0.3)
    ref = jattn.region_attention_beam(
        jp, jnp.asarray(h), jnp.asarray(pool), jnp.asarray(p_pool),
        jnp.asarray(att_mask), jnp.asarray(pnt_mask), mode=mode)
    with torch.no_grad():
        got = tattn.region_attention_beam(
            p, *(torch.from_numpy(a) for a in (h, pool, p_pool, att_mask,
                                               pnt_mask)), mode=mode)
    for g, r, name in zip(got, ref, ("att_res", "grd_logits", "att_h")):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=ATTN_ATOL, rtol=0, err_msg=name)


def test_region_attention_beam_refuses_an_unknown_mode():
    p, _ = _attention_params(np.random.RandomState(0), 4, 4, 4)
    z = torch.zeros
    with pytest.raises(ValueError, match="region_attn_mode"):
        tattn.region_attention_beam(
            p, z(1, 2, 4), z(1, 3, 4), z(1, 3, 4), z(1, 3, dtype=torch.bool),
            z(1, 3, dtype=torch.bool), mode="nope")


def test_temporal_attention_beam_matches_jax():
    rng = np.random.RandomState(9)
    Bn, W, T, rnn, hid = 2, 4, 9, 8, 6
    p, jp = _attention_params(rng, rnn, hid, hid)
    h = rng.randn(Bn, W, rnn).astype(np.float32)
    feats = rng.randn(Bn, T, rnn).astype(np.float32)
    p_feats = rng.randn(Bn, T, hid).astype(np.float32)
    ref = jattn.temporal_attention_beam(jp, jnp.asarray(h),
                                        jnp.asarray(feats),
                                        jnp.asarray(p_feats))
    with torch.no_grad():
        got = tattn.temporal_attention_beam(
            p, *(torch.from_numpy(a) for a in (h, feats, p_feats)))
    assert tuple(got.shape) == (Bn, W, rnn)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("w", [1, 3, 5])
def test_top_w_holds_the_jax_tie_order(w):
    """Rows with planted ties (a tie at the top, ties among the picks, a
    run of equal values, NEG_INF entries): values and indices equal the
    JAX package's ``_top_w`` (first index first on a tie)."""
    rng = np.random.RandomState(w)
    flat = rng.randint(-4, 4, size=(6, 12)).astype(np.float32)
    flat[0, [2, 9]] = 10.0                  # a tie at the top
    flat[1] = 1.0                           # every entry tied
    flat[2, :6] = tbeam.NEG_INF             # masked rows' share
    flat[3, [0, 5, 11]] = 7.5               # three-way tie
    ref_v, ref_i = jbeam._top_w(jnp.asarray(flat), w)
    got_v, got_i = tbeam._top_w(torch.from_numpy(flat), w)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert got_i[1].tolist() == list(range(w))
    if w >= 2:
        assert got_i[0, :2].tolist() == [2, 9]


@pytest.fixture(scope="module")
def jax_beam_eval(tmp_path_factory):
    """A synthetic dataset of 4 validation segments with 300 proposals
    each, in batches of 3 (the last one padded), and the JAX evaluator's
    files and stats at beam 3."""
    root = tmp_path_factory.mktemp("beam_eval")
    cfg = jconfig.tiny_test_config(obj_interact=True, num_prop_per_frm=75,
                                   batch_size=3)
    paths = write_synthetic_dataset(str(root / "data"), _tcfg(cfg),
                                    n_train=1, n_val=2, seed=0)
    cfg = cfg.replace(**paths, language_eval=True, eval_obj_grounding=True,
                      id="beam", beam_size=3, data_path=str(root / "data"))
    dataset = AnetDataset(cfg, split=cfg.val_split)
    vocab = dataset.vocab
    cfg = cfg.replace(vocab_size=vocab.vocab_size,
                      detect_size=vocab.detect_size,
                      unk_idx=int(vocab.wtoi.get("UNK",
                                                 vocab.vocab_size - 1)))
    batches = list(Loader(dataset, 3, shuffle=False, drop_last=False,
                          pad_last=True))
    assert [b["n_valid"] for b in batches] == [3, 1]
    model = JaxModel(cfg)
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(5)))
    out = str(root / "jax")
    stats = JaxEvaluator(cfg, model, vocab).evaluate(variables, batches,
                                                     out_dir=out)
    return dict(cfg=cfg, variables=variables, batches=batches, out=out,
                stats=stats, root=root)


def test_evaluator_beam3_json_matches_jax(jax_beam_eval):
    """``Evaluator.evaluate`` at beam_size 3: the densecap and attn-gen
    JSONs byte for byte (the words grounded by the best beam's per-frame
    argmaxes), and every stat but captions_per_sec equal."""
    ref = jax_beam_eval
    cfg = _tcfg(ref["cfg"])
    model = GVDModel(cfg)
    model.load_state_dict(from_jax_variables(ref["variables"]))
    ev = Evaluator(cfg, model.eval(),
                   VocabTables.from_file(ref["cfg"].input_dic))
    out = str(ref["root"] / "port")
    gen = ev.generate({k: v for k, v in ref["batches"][0].items()
                       if k not in ("seg_id", "n_valid")})
    assert sorted(gen) == ["att2_frm_ind", "att2_ind", "logprobs", "seq"]
    stats = ev.evaluate(ref["batches"], out_dir=out)
    tag = f"{cfg.val_split}-{cfg.id}.json"
    for name in (f"densecap_results/densecap-{tag}",
                 f"results/attn-gen-sent-results-{tag}"):
        with open(os.path.join(ref["out"], name), "rb") as f:
            want = f.read()
        with open(os.path.join(out, name), "rb") as f:
            assert f.read() == want, name
    drop = ("captions_per_sec",)
    assert ({k: v for k, v in stats.items() if k not in drop}
            == {k: v for k, v in ref["stats"].items() if k not in drop})
    assert "CIDEr" in stats and "grd_f1_all" in stats
