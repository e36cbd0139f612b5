"""PyTorch port, the Masked-Transformer captioner (att_model
"transformer") against the JAX package on the CPU, f32: the decoder's
teacher-forced pass and loss, its greedy decode (also against a teacher-
forced pass over its own prediction), the MLE forward, one train step at
grad_accum 2 against the JAX Trainer, sample_greedy, the weights bridge
through the JAX importer, and the pairs the port refuses.

R = 4 x 75 = 300 proposals: decoder layer 1 cross-attends more than 256
keys, so the JAX package's head-sequential attention schedule is held as
well as its packed one (layer 0 over the 16 frames).  The decoder's
attention projections and FFN outputs are scaled up, so that the greedy
captions are words and not all EOS, as at random weights."""

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
from grounded_video_description_tpu.engine.checkpoint import (
    import_torch_bn_state, import_torch_checkpoint)
from grounded_video_description_tpu.engine.trainer import (
    Trainer as JaxTrainer)
from grounded_video_description_tpu.models import GVDModel as JaxModel
from grounded_video_description_tpu.models import transformer as jxf
from grounded_video_description_tpu.nn import linear as jlinear
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.data import synthetic_batch
from grounded_video_description_torch.engine.trainer import (
    Trainer, batch_to_device)
from grounded_video_description_torch.models import (
    GVDModel, batch_to_tensors)
from grounded_video_description_torch.models import transformer as txf
from grounded_video_description_torch.nn import dropout
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.weights import from_jax_variables

# f32 on both sides, sums in another order
RTOL = 1e-5
# parameters after one Adam step at lr 5e-4 (tests/test_torch_train.py)
PARAM_ATOL = 1e-6
LR = 5e-4
B = 3


def _jcfg(**kw):
    return jconfig.tiny_test_config(
        att_model="transformer", obj_interact=True, num_prop_per_frm=75,
        use_pallas=False, learning_rate=LR, learning_rate_decay_start=-1,
        **kw)


def _tcfg(jcfg, **kw):
    return tconfig.GVDConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tconfig.GVDConfig)}).replace(
            **kw).validate()


def _sharpen(variables):
    """Every decoder attention projection and FFN output times 6: at
    random weights the input token's own embedding, carried by the
    residuals, wins every argmax (all EOS); scaled sublayers make the
    encodings and the positions decide."""
    for lp in variables["params"]["cap_model"]["layers"]:
        for blk in ("selfattn", "crossattn"):
            for name in ("wq", "wk", "wv", "wo"):
                lp[blk][name]["w"] = lp[blk][name]["w"] * 6.0
        lp["ff"]["l2"]["w"] = lp["ff"]["l2"]["w"] * 6.0
    return variables


def _port(cfg, variables):
    m = GVDModel(cfg)
    m.load_state_dict(from_jax_variables(variables))
    return m.eval()


@pytest.fixture(scope="module")
def ref():
    """The JAX model's encodings, decoder outputs, loss, greedy decode,
    sample_greedy and MLE forward on one batch."""
    cfg = _jcfg()
    jm = JaxModel(cfg)
    variables = _sharpen(jm.init(jax.random.PRNGKey(0)))
    jb = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(
        cfg, B, seed=1).items() if k != "seg_id"}
    enc, _ = jax.jit(lambda v, b: jm.encode(
        v["params"], v["state"], b, train=False))(variables, jb)
    encs = jm._transformer_encodings(variables["params"], enc["conv_feats"],
                                     enc["pool_feats"])
    dec = variables["params"]["cap_model"]
    seq = jnp.concatenate([jnp.zeros((B, 1), jnp.int32),
                           jb["gt_seq"][:, 0].astype(jnp.int32)], axis=1)
    out = jxf.decoder_apply(dec, seq[:, :-1], encs, n_heads=6, drop=0.0)
    loss = jxf.decoder_xe_loss(dec, encs, seq, n_heads=6, drop=0.0,
                               train=False)
    greedy = jax.jit(lambda d, e: jxf.decoder_greedy(
        d, e, cfg.seq_length, n_heads=6))(dec, encs)
    sample = jax.jit(jm.sample_greedy)(variables, jb)
    losses, _ = jax.jit(lambda v, b: jm.forward(
        v, b, mode="MLE", train=True))(variables, jb)
    np_ = lambda t: jax.tree.map(np.asarray, t)    # noqa: E731
    return dict(jcfg=cfg, cfg=_tcfg(cfg), variables=np_(variables),
                encs=np_(encs), seq=np.asarray(seq), out=np.asarray(out),
                loss=float(loss), greedy=np.asarray(greedy),
                sample=np_(sample), losses=np_(losses),
                batch=synthetic_batch(_tcfg(cfg), B, seed=1))


def _encs(ref):
    return [torch.from_numpy(e.copy()) for e in ref["encs"]]


def test_positional_encodings_match_jax():
    for T, D in ((8, 64), (20, 1024), (5, 7)):
        np.testing.assert_array_equal(
            txf.positional_encodings(T, D).numpy(),
            np.asarray(jxf.positional_encodings(T, D)))


def test_decoder_apply_and_xe_loss_match_jax(ref):
    """The teacher-forced hidden states and the masked cross-entropy
    within 1e-5 relative, on the JAX encodings and weights."""
    dec = _port(ref["cfg"], ref["variables"]).cap_model.decoder
    seq = torch.from_numpy(ref["seq"].copy()).long()
    with torch.no_grad():
        out = txf.decoder_apply(dec, seq[:, :-1], _encs(ref), n_heads=6,
                                drop=0.0)
        loss = txf.decoder_xe_loss(dec, _encs(ref), seq, n_heads=6,
                                   drop=0.0, train=False)
    np.testing.assert_allclose(out.numpy(), ref["out"], rtol=RTOL,
                               atol=RTOL * np.abs(ref["out"]).max())
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=RTOL)


def test_decoder_greedy_matches_jax_and_teacher_forcing(ref):
    """Greedy tokens identical to the JAX scan's; each step's token is the
    argmax of a teacher-forced pass over the decode's own prefix
    (tests/test_transformer.py:36), and the captions hold several words."""
    dec = _port(ref["cfg"], ref["variables"]).cap_model.decoder
    L = ref["cfg"].seq_length
    with torch.no_grad():
        pred = txf.decoder_greedy(dec, _encs(ref), L, n_heads=6)
        tokens = torch.cat([torch.zeros(B, 1, dtype=torch.long),
                            pred[:, :-1].long()], dim=1)
        out = txf.decoder_apply(dec, tokens, _encs(ref), n_heads=6,
                                drop=0.0)
        logits = torch.nn.functional.linear(out, dec.out.weight,
                                            dec.out.bias)
    assert pred.dtype == torch.int32 and pred.shape == (B, L)
    np.testing.assert_array_equal(pred.numpy(), ref["greedy"])
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), pred.numpy())
    assert len(np.unique(ref["greedy"])) > 3


def test_forward_mle_matches_jax(ref):
    """lm_loss within 1e-5 relative, the auxiliary losses exactly 0, the
    counts equal (txt_count the non-pad targets), and they are the
    supervision's counts, which gradient accumulation divides by."""
    model = _port(ref["cfg"], ref["variables"])
    batch = batch_to_device(ref["cfg"], ref["batch"], "cpu")
    losses, bn = model(batch, mode="MLE", train=True)
    np.testing.assert_allclose(float(losses["lm_loss"].detach()),
                               float(ref["losses"]["lm_loss"]), rtol=RTOL)
    for k in ("att2_loss", "ground_loss", "cls_loss"):
        assert float(losses[k]) == float(ref["losses"][k]) == 0.0, k
    counts = model.batch_loss_counts(batch)
    for k in ("txt_count", "roi_count", "cls_count"):
        assert float(losses[k]) == float(ref["losses"][k]) \
            == float(counts[k]) > 0, k
    assert bn is not None


def test_sample_greedy_matches_jax(ref):
    """Tokens identical, zero f32 logprobs and att2 of the JAX shapes,
    sim_mat_static within 1e-4; with the kernel flags on, CPU tensors take
    the plain versions and no kernel is launched."""
    model = _port(ref["cfg"].replace(use_pallas=True, use_pallas_rnn=True,
                                     use_pallas_encoder=True,
                                     use_pallas_decode=True), ref["variables"])
    _build.reset_launches()
    out = model.sample_greedy(batch_to_tensors(ref["batch"], "cpu"))
    assert not _build.launches
    seq, lp, att2, sim = out
    jseq, jlp, jatt2, jsim = ref["sample"]
    assert seq.dtype == torch.int32
    np.testing.assert_array_equal(seq.numpy(), jseq)
    for got, want in ((lp, jlp), (att2, jatt2)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert not got.any() and not want.any()
    np.testing.assert_allclose(sim.numpy(), jsim, atol=1e-4)


def test_decoder_dropout_keeps_its_rate():
    """At enc_drop 0.2 the decoder's training pass drops: two generators
    give two losses, one generator state gives the same loss, and the
    embedding site keeps 0.8 of its elements (3 sigma)."""
    cfg = tconfig.tiny_test_config(att_model="transformer", enc_drop=0.2)
    dec = txf.Decoder(64, 32, 50, 2)
    for m in dec.modules():
        if isinstance(m, torch.nn.Linear):
            torch.nn.init.uniform_(m.weight, -0.1, 0.1)
    g = np.random.default_rng(0)
    encs = [torch.from_numpy(g.standard_normal((4, n, 64)).astype(
        np.float32)) for n in (16, 300)]
    seq = torch.from_numpy(g.integers(1, 50, (4, 9)))
    seq[:, 0] = 0

    def loss(seed):
        return float(txf.decoder_xe_loss(
            dec, encs, seq, n_heads=6, drop=cfg.enc_drop, train=True,
            generator=torch.Generator().manual_seed(seed)).detach())

    assert loss(1) == loss(1) != loss(2)
    x = torch.ones(400, 500)
    kept = dropout(x, cfg.enc_drop, train=True,
                       generator=torch.Generator().manual_seed(3)) != 0
    assert abs(float(kept.float().mean()) - 0.8) < 3 * (0.16 / 2e5) ** 0.5


def test_train_step_grad_accum_2_matches_jax_trainer():
    """One Adam step at grad_accum 2 from the same weights and batch: the
    loss within 1e-5 relative and every parameter within 1e-6 of the JAX
    Trainer's (the decoder, the encode and the untouched TopDown core)."""
    cfg = _jcfg(batch_size=4, grad_accum=2)
    trainer = JaxTrainer(cfg)
    st = trainer.init_state(rng=jax.random.PRNGKey(7))
    tcfg = _tcfg(cfg)
    batch = synthetic_batch(tcfg, 4, seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "seg_id"}
    p, ms, _, m = trainer.make_train_step(donate=False)(
        st.params, st.model_state, st.opt_state, jb, jax.random.PRNGKey(3),
        LR)
    init = jax.tree.map(np.asarray, {"params": st.params,
                                     "state": st.model_state})
    after = from_jax_variables(jax.tree.map(np.asarray, {"params": p,
                                                         "state": ms}))
    model = GVDModel(tcfg)
    model.load_state_dict(from_jax_variables(init))
    got = Trainer(tcfg, model).train_step(
        batch_to_device(tcfg, batch, "cpu"), LR)
    for k in ("loss", "lm_loss"):
        np.testing.assert_allclose(float(got[k]), float(m[k]), rtol=RTOL,
                                   err_msg=k)
    sd = model.state_dict()
    assert sd.keys() == after.keys()
    for k, want in after.items():
        if k.endswith("num_batches_tracked"):
            assert int(sd[k]) == int(want)
            continue
        diff = float((sd[k].float() - want.float()).abs().max())
        assert diff <= PARAM_ATOL, (k, diff)


def test_weights_roundtrip_through_importer_is_identity(ref):
    """JAX -> port state_dict -> import_torch_checkpoint -> JAX gives back
    every leaf exactly, cap_model included, and the importer reads every
    cap_model key."""
    variables = ref["variables"]
    port = GVDModel(ref["cfg"])
    port.load_state_dict(from_jax_variables(variables))       # strict
    sd = port.state_dict()
    read = set()

    class Recording(dict):
        def get(self, key, default=None):
            if key in self:
                read.add(key)
            return super().get(key, default)

        def __getitem__(self, key):
            read.add(key)
            return super().__getitem__(key)

    nan = jax.tree.map(lambda a: np.full_like(a, np.nan), variables)
    rec = Recording(sd)
    params = import_torch_checkpoint(rec, nan["params"])
    state = import_torch_bn_state(rec, nan["state"])
    cap = {k for k in sd if k.startswith("cap_model.")}
    assert cap and cap <= read, sorted(cap - read)
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(variables),
            jax.tree.leaves({"params": params, "state": state})):
        np.testing.assert_array_equal(np.asarray(b, a.dtype), a,
                                      err_msg=jax.tree_util.keystr(path))


def test_seeded_init_reaches_jax_through_the_importer(ref):
    """The port's own init of the family, imported into JAX, decodes the
    same greedy tokens there."""
    cfg = ref["jcfg"]
    a = GVDModel(ref["cfg"]).init(torch.Generator().manual_seed(0))
    jm = JaxModel(cfg)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    sd = a.state_dict()
    jvars = {"params": import_torch_checkpoint(sd, init["params"]),
             "state": import_torch_bn_state(sd, init["state"])}
    jb = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(
        cfg, B, seed=4).items() if k != "seg_id"}
    jseq = np.asarray(jax.jit(jm.sample_greedy)(jvars, jb)[0])
    seq = a.eval().sample_greedy(batch_to_tensors(
        synthetic_batch(ref["cfg"], B, seed=4), "cpu"))[0]
    np.testing.assert_array_equal(seq.numpy(), jseq)
    # the tied head: the port's logits are the JAX linear's
    h = np.random.default_rng(2).standard_normal((2, 64)).astype(np.float32)
    want = np.asarray(jlinear(jvars["params"]["cap_model"]["out"],
                              jnp.asarray(h)))
    got = torch.nn.functional.linear(torch.from_numpy(h),
                                     a.cap_model.decoder.out.weight,
                                     a.cap_model.decoder.out.bias)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pair", ["quantize_banks", "beam"])
def test_transformer_refuses_what_the_reference_mishandles(ref, pair):
    """The JAX package accepts both pairs and then crashes (a quantized
    bank's shape read by its transformer decode) or decodes with the
    untrained TopDown core (beam search); the port refuses them with a
    message, and sample_beam and GRD refuse the family."""
    kw = ({"quantize_banks": True} if pair == "quantize_banks"
          else {"beam_size": 3})
    with pytest.raises(ValueError, match="transformer"):
        tconfig.GVDConfig(att_model="transformer", **kw).validate()
    with pytest.raises(ValueError, match="transformer"):
        tconfig.GVDConfig.from_cli(
            ["--att_model", "transformer"]
            + (["--quantize_banks"] if pair == "quantize_banks"
               else ["--beam_size", "3"]))
    model = _port(ref["cfg"], ref["variables"])
    batch = batch_to_tensors(ref["batch"], "cpu")
    if pair == "beam":
        with pytest.raises(ValueError, match="TopDown"):
            model.sample_beam(batch, beam_size=3)
    else:
        with pytest.raises(ValueError, match="GRD"):
            model(batch, mode="GRD")
