"""PyTorch port, the supervised train step: the training forms of the nn
ops, the obj_interact encoder in training (every attention schedule),
the MLE and GRD forward, and one optimizer step against the JAX
package's Trainer, on the same weights and batch, f32 on the CPU.

R = 4 x 75 = 300 proposals, so the encoder's K4 dispatch (more than 256
keys) is taken; on the CPU K4's wrapper runs its plain twin.  All dropout
is 0 where the JAX package is compared: the two packages draw their masks
from different generators."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_description_tpu import config as jconfig
from grounded_video_description_tpu.data.synthetic import (
    synthetic_batch as jax_synthetic_batch)
from grounded_video_description_tpu.engine.trainer import (
    Trainer as JaxTrainer)
from grounded_video_description_tpu.models import GVDModel as JaxModel
from grounded_video_description_tpu.models import transformer as jxf
from grounded_video_description_tpu.nn import core as jcore
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.data import synthetic_batch
from grounded_video_description_torch.engine.trainer import (
    Trainer, batch_to_device, make_optimizer)
from grounded_video_description_torch.models import GVDModel
from grounded_video_description_torch.models import transformer as txf
from grounded_video_description_torch.nn import core as tcore
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.weights import (
    birnn_state_dict, encoder_state_dict, from_jax_variables)

# losses: f32 on both sides, sums in another order
LOSS_RTOL = 1e-5
# parameters after one Adam step at lr 5e-4, within 1e-6.  Adam's first
# step moves a parameter by lr g / (|g| + 1e-8): where 0 < |g| < 1e-7 it
# amplifies the rounding noise of g (as in the region attention's
# alpha_net bias, whose true gradient is 0 by the softmax's shift
# invariance), so those elements are held to 2 lr, and at most 10
# elements in all may exceed 1e-6 (1 or 2 do)
PARAM_ATOL = 1e-6
TINY_GRAD = 1e-7
LR = 5e-4
LOSS_KEYS = ("loss", "lm_loss", "att2_loss", "ground_loss", "cls_loss")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _tcfg(jcfg):
    return tconfig.GVDConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tconfig.GVDConfig)}).validate()


def _jcfg(t_attn_mode="bigru", **kw):
    base = dict(obj_interact=True, num_prop_per_frm=75, w_att2=0.05,
                w_grd=0.05, w_cls=0.1, batch_size=4,
                learning_rate=LR, learning_rate_decay_start=-1,
                t_attn_mode=t_attn_mode, attn_train_impl="pallas")
    base.update(kw)
    return jconfig.tiny_test_config(**base)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(cfg, variables):
    m = GVDModel(cfg)
    m.load_state_dict(from_jax_variables(variables))
    return m


# --------------------------------------------------------------------- #
# nn ops in training
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keeps_the_rate_and_the_dtype(dtype):
    """keep probability 1 - rate, kept values scaled by 1 / (1 - rate),
    the same mask for the same generator state; 3 sigma bar on the kept
    fraction of 200k draws."""
    x = torch.ones(400, 500, dtype=dtype)
    y = tcore.dropout(x, 0.3, train=True,
                      generator=torch.Generator().manual_seed(1))
    y2 = tcore.dropout(x, 0.3, train=True,
                       generator=torch.Generator().manual_seed(1))
    assert y.dtype == dtype and torch.equal(y, y2)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 3 * (0.21 / 2e5) ** 0.5
    assert torch.all(y[kept] == torch.tensor(1 / 0.7, dtype=dtype))


def test_batch_norm_train_matches_jax():
    """Batch statistics over (B, T) in f32; the running update (momentum
    0.1, unbiased variance, count + 1) is returned, bn left as it was."""
    rng = np.random.RandomState(5)
    C = 6
    params = {"gamma": rng.randn(C).astype(np.float32),
              "beta": rng.randn(C).astype(np.float32)}
    state = {"mean": rng.randn(C).astype(np.float32),
             "var": rng.rand(C).astype(np.float32) + 0.5,
             "count": np.float32(3)}
    x = (rng.randn(2, 4, C) * 2 + 1).astype(np.float32)
    ref, jstate = jcore.batch_norm(params, state, jnp.asarray(x), train=True)
    bn = torch.nn.BatchNorm1d(C)
    bn.load_state_dict({"weight": _t(params["gamma"]),
                        "bias": _t(params["beta"]),
                        "running_mean": _t(state["mean"]),
                        "running_var": _t(state["var"]),
                        "num_batches_tracked": torch.tensor(3)})
    y, new = tcore.batch_norm_train(bn, _t(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    np.testing.assert_allclose(new["running_mean"].numpy(),
                               np.asarray(jstate["mean"]), atol=1e-6)
    np.testing.assert_allclose(new["running_var"].numpy(),
                               np.asarray(jstate["var"]), atol=1e-6)
    assert int(new["num_batches_tracked"]) == int(jstate["count"]) == 4
    assert torch.equal(bn.running_mean, _t(state["mean"]))


@pytest.mark.parametrize("mode", ["bigru", "bilstm"])
def test_birnn_train_matches_jax_and_differentiates(mode):
    """Training with use_kernel on CPU tensors: the recurrence takes K2's
    plain twin under autograd (the training route's kernels run on a CUDA
    tensor alone) and counts no launch; same output as the JAX scan, and
    the input and every trainable weight get a gradient, within 1e-5 of
    JAX's."""
    B, T, D, H = 3, 9, 12, 8
    p = jcore.birnn_init(jax.random.PRNGKey(4), D, H, 2, mode)
    x = np.random.RandomState(3).randn(B, T, D).astype(np.float32)
    w = np.random.RandomState(4).randn(B, T, 2 * H).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jcore.birnn(p, x, mode=mode, hidden=H, train=True)
                       * w)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    rnn = tcore.BiRNNParams(D, H, 2, mode)
    rnn.load_state_dict(birnn_state_dict(p))
    xt = _t(x).requires_grad_(True)
    _build.reset_launches()
    out = tcore.birnn(rnn, xt, use_kernel=True, train=True, drop=0.0)
    (out * _t(w)).sum().backward()
    assert not _build.launches
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), atol=1e-5)
    ref = birnn_state_dict(jg_p)
    for name, prm in rnn.named_parameters():
        if mode == "bilstm" and name.startswith("bias_hh"):
            assert not prm.requires_grad and prm.grad is None
            continue
        np.testing.assert_allclose(prm.grad.numpy(), ref[name].numpy(),
                                   atol=1e-5, err_msg=name)


def test_birnn_training_route_keeps_the_dropout_masks(monkeypatch):
    """Two BiGRU layers in training at drop 0.5, the recurrence taken once
    by the twin under autograd and once by K2's training route (its
    Function with the plain forward and backward, as a CPU tensor runs
    it), from one generator seed: the same output, so the same mask
    between the layers, the generator left in the same state, and the
    same input gradient."""
    from grounded_video_description_torch.ops.kernels import birnn as kb
    D, H = 12, 8
    rnn = tcore.BiRNNParams(D, H, 2, "bigru")
    rnn.reset_parameters(torch.Generator().manual_seed(3))
    x = torch.randn(3, 9, D, generator=torch.Generator().manual_seed(4))
    got = {}
    for route in (False, True):
        if route:
            monkeypatch.setattr(kb, "birnn_recurrence_plain",
                                kb.birnn_recurrence_train)
        g = torch.Generator().manual_seed(5)
        xr = x.clone().requires_grad_(True)
        out = tcore.birnn(rnn, xr, use_kernel=True, train=True, drop=0.5,
                          generator=g)
        out.square().sum().backward()
        got[route] = (out.detach(), g.get_state(), xr.grad)
    assert torch.equal(got[True][1], got[False][1])
    np.testing.assert_allclose(got[True][0].numpy(), got[False][0].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got[True][2].numpy(), got[False][2].numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas", "hybrid"])
def test_encoder_train_matches_jax(impl):
    """Every attention schedule at drop 0 against the JAX encoder in
    training (XLA path), R = 300 > 256 so K4's dispatch is taken:
    encodings and input gradients within 1e-5; weight gradients, sums
    over 600 rows whose rounding scales with the largest of them, within
    1e-5 of the tensor's largest magnitude."""
    D, HID = 48, 24
    params = jxf.encoder_init(jax.random.PRNGKey(0), D, HID, 2)
    x = np.random.RandomState(1).randn(2, 300, D).astype(np.float32)
    w = np.random.RandomState(2).randn(2, 300, D).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jxf.encoder_apply(p, x, n_heads=6, drop=0.0,
                                         train=True)[-1] * w)

    ref = jxf.encoder_apply(params, jnp.asarray(x), n_heads=6, drop=0.0,
                            train=True)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    enc = txf.Encoder(D, HID, 2)
    enc.load_state_dict(encoder_state_dict(params))
    xt = _t(x).requires_grad_(True)
    got = txf.encoder_apply(enc, xt, n_heads=6, train=True, drop=0.0,
                            attn_train_impl=impl)
    (got[-1] * _t(w)).sum().backward()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), atol=1e-5)
    jgrads = encoder_state_dict(jg_p)
    for name, prm in enc.named_parameters():
        ref_g = jgrads[name].numpy()
        err = np.abs(prm.grad.numpy() - ref_g).max()
        assert err <= 1e-5 * max(1.0, np.abs(ref_g).max()), (name, err)


def test_encoder_train_k4_schedules_share_masks():
    """With dropout on, "pallas" and "hybrid" draw one seed per layer call
    from the generator, so their masks, and every later draw of the run,
    are the same: on the CPU both give the same output.  "xla" draws its
    own masks."""
    enc = txf.Encoder(48, 24, 2)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 300, 48, generator=torch.Generator().manual_seed(1))
    outs = {}
    for impl in ("pallas", "hybrid", "xla"):
        g = torch.Generator().manual_seed(7)
        outs[impl] = txf.encoder_apply(enc, x, n_heads=6, train=True,
                                       drop=0.2, generator=g,
                                       attn_train_impl=impl)[-1]
    no_drop = txf.encoder_apply(enc, x, n_heads=6, train=True, drop=0.0,
                                attn_train_impl="pallas")[-1]
    assert torch.equal(outs["pallas"], outs["hybrid"])
    assert not torch.allclose(outs["pallas"], no_drop, atol=1e-3)
    assert not torch.allclose(outs["pallas"], outs["xla"], atol=1e-3)


# --------------------------------------------------------------------- #
# the MLE / GRD forward
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module", params=[1, 2], ids=lambda s: f"S{s}")
def fwd_ref(request):
    """The JAX forward in both modes and its supervision, on one batch,
    with one and two captions per segment (seq_per_img)."""
    cfg = _jcfg(use_pallas=False, seq_per_img=request.param)
    jm = JaxModel(cfg)
    variables = jm.init(jax.random.PRNGKey(1))
    jb = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(
        cfg, 3, seed=2).items() if k != "seg_id"}
    losses, bn = jax.jit(lambda v, b: jm.forward(v, b, mode="MLE",
                                                 train=True))(variables, jb)
    grd = jax.jit(lambda v, b: jm.forward(v, b, mode="GRD"))(variables, jb)
    sup = jax.jit(jm.supervision)(jb)
    tcfg = _tcfg(cfg)
    return dict(cfg=tcfg, variables=_np_tree(variables),
                batch=synthetic_batch(tcfg, 3, seed=2),
                losses=_np_tree(losses), bn=_np_tree(bn),
                grd=_np_tree(grd), sup=_np_tree(sup))


def test_supervision_matches_jax(fwd_ref):
    """Every supervision tensor and count equal; batch_loss_counts is its
    scalar part."""
    model = GVDModel(fwd_ref["cfg"])
    batch = batch_to_device(fwd_ref["cfg"], fwd_ref["batch"], "cpu")
    sup = model.supervision(batch)
    assert sup.keys() == fwd_ref["sup"].keys()
    for k, v in fwd_ref["sup"].items():
        np.testing.assert_array_equal(sup[k].numpy(), v, err_msg=k)
    counts = model.batch_loss_counts(batch)
    assert counts.keys() == {"txt_count", "roi_count", "cls_count"}
    for k, v in counts.items():
        assert float(v) == float(fwd_ref["sup"][k]) > 0, k


def test_forward_mle_matches_jax(fwd_ref):
    """The four losses within 1e-5 relative, the three counts and the
    BatchNorm statistics after the batch equal."""
    model = _port_model(fwd_ref["cfg"], fwd_ref["variables"])
    losses, bn = model(batch_to_device(fwd_ref["cfg"], fwd_ref["batch"],
                                       "cpu"), mode="MLE", train=True)
    for k, v in fwd_ref["losses"].items():
        np.testing.assert_allclose(float(losses[k].detach()), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    for k in ("txt_count", "roi_count", "cls_count"):
        assert float(losses[k]) == float(fwd_ref["losses"][k]) > 0, k
    jbn = fwd_ref["bn"]["bn"]
    np.testing.assert_allclose(bn["running_mean"].numpy(), jbn["mean"],
                               atol=1e-6)
    np.testing.assert_allclose(bn["running_var"].numpy(), jbn["var"],
                               atol=1e-6)
    assert int(bn["num_batches_tracked"]) == int(jbn["count"])


def test_forward_grd_matches_jax(fwd_ref):
    """GRD mode: sim_target, pred_cls, att2_ind and grd_ind identical; no
    gradient is taken and no kernel is launched."""
    model = _port_model(fwd_ref["cfg"].replace(use_pallas=True),
                        fwd_ref["variables"])
    _build.reset_launches()
    out = model(batch_to_device(fwd_ref["cfg"], fwd_ref["batch"], "cpu"),
                mode="GRD")
    assert not _build.launches
    assert out.keys() == fwd_ref["grd"].keys()
    for k, v in fwd_ref["grd"].items():
        assert not out[k].requires_grad
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


# --------------------------------------------------------------------- #
# one optimizer step against the JAX Trainer
# --------------------------------------------------------------------- #

# (name, t_attn_mode, grad_accum): the flagship's BiGRU at accumulation 1
# and 2, and the BiLSTM whose fused biases the step must train once
_STEP_CASES = {"bigru-accum1": ("bigru", 1), "bigru-accum2": ("bigru", 2),
               "bilstm-accum1": ("bilstm", 1)}


@pytest.fixture(scope="module")
def step_ref(request):
    t_attn_mode, accum = _STEP_CASES[request.param]
    cfg = _jcfg(t_attn_mode, grad_accum=accum)
    trainer = JaxTrainer(cfg)
    st = trainer.init_state(rng=jax.random.PRNGKey(7))
    tcfg = _tcfg(cfg)
    batch = synthetic_batch(tcfg, 4, seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "seg_id"}
    step = trainer.make_train_step(donate=False)
    p, ms, _, m = step(st.params, st.model_state, st.opt_state, jb,
                       jax.random.PRNGKey(3), LR)
    return dict(cfg=tcfg, batch=batch,
                init=_np_tree({"params": st.params,
                               "state": st.model_state}),
                after=from_jax_variables(_np_tree({"params": p,
                                                   "state": ms})),
                metrics={k: float(v) for k, v in m.items()})


def _tiny(g: torch.Tensor) -> torch.Tensor:
    """Elements whose gradient is non-zero but below TINY_GRAD (an exact
    zero moves neither side)."""
    return (g.abs() < TINY_GRAD) & (g != 0)


def _max(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def _port_step(cfg, init, batch):
    """One port train step from the JAX initial variables; returns the
    model, the metrics and each parameter's gradient (after the clip)."""
    model = _port_model(cfg, init)
    trainer = Trainer(cfg, model)
    grads, step = {}, trainer.optimizer.step

    def step_recording_grads():
        grads.update({n: q.grad.clone() for n, q in model.named_parameters()
                      if q.grad is not None})
        step()

    trainer.optimizer.step = step_recording_grads
    metrics = trainer.train_step(batch_to_device(cfg, batch, "cpu"), LR)
    return model, metrics, grads


@pytest.mark.parametrize("step_ref,impl", [
    ("bigru-accum1", "pallas"), ("bigru-accum2", "pallas"),
    ("bilstm-accum1", "pallas"), ("bigru-accum1", "xla"),
    ("bigru-accum1", "hybrid"), ("bigru-accum1", "k5")],
    indirect=["step_ref"])
def test_train_step_matches_jax_trainer(step_ref, impl):
    """Losses within 1e-5 relative; parameters within 1e-6 absolute (see
    PARAM_ATOL); BatchNorm statistics equal.  "k5" trains the obj_interact
    layers through K5's wrapper (``use_pallas_encoder_train``, every
    dropout 0), which the JAX Trainer runs on its XLA encoder off the TPU:
    the same function."""
    if impl == "k5":
        cfg = step_ref["cfg"].replace(use_pallas_encoder_train=True)
    else:
        cfg = step_ref["cfg"].replace(attn_train_impl=impl)
    model, metrics, grads = _port_step(cfg, step_ref["init"],
                                       step_ref["batch"])
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(metrics[k]), step_ref["metrics"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    sd = model.state_dict()
    assert sd.keys() == step_ref["after"].keys()
    n_off = 0
    for k, ref in step_ref["after"].items():
        got = sd[k]
        if k.endswith("num_batches_tracked"):
            assert int(got) == int(ref)
            continue
        diff = (got.float() - ref.float()).abs()
        tiny = (_tiny(grads[k]) if k in grads
                else torch.zeros_like(diff, dtype=torch.bool))
        n_off += int((diff > PARAM_ATOL).sum())
        assert _max(diff[~tiny]) <= PARAM_ATOL, k
        assert _max(diff[tiny]) <= 2 * LR, k
    assert n_off <= 10


@pytest.mark.parametrize("step_ref", ["bilstm-accum1"], indirect=True)
def test_lstm_fused_bias_trains_once(step_ref):
    """After one Adam step, bias_ih + bias_hh of the core LSTMs (and of
    the BiLSTM temporal encoder) equals the JAX cell's single bias b, and
    bias_hh is still zero: it is frozen, so the fused bias is neither
    stepped twice nor counted twice in the clip norm."""
    model, _, grads = _port_step(step_ref["cfg"], step_ref["init"],
                                 step_ref["batch"])
    sd, ref = model.state_dict(), step_ref["after"]
    prefixes = ["core.att_lstm.", "core.lang_lstm."] + [
        f"context_enc.{{}}_l{li}{sfx}" for li in (0, 1)
        for sfx in ("", "_reverse")]
    for pre in prefixes:
        if pre.startswith("context_enc"):
            ih, hh = pre.format("bias_ih"), pre.format("bias_hh")
        else:
            ih, hh = pre + "bias_ih", pre + "bias_hh"
        assert torch.all(sd[hh] == 0) and hh not in grads, hh
        diff = (sd[ih] + sd[hh] - ref[ih]).abs()
        tiny = _tiny(grads[ih])
        assert _max(diff[~tiny]) <= PARAM_ATOL, ih


@pytest.mark.parametrize("seq_per_img", [1, 2])
def test_grad_accum_2_equals_1(seq_per_img):
    """grad_accum 2 gives the full batch's update: the count-renormalized
    microbatch losses sum to the full batch's masked means and their
    gradients sum to its gradient, also with two captions per segment
    (the supervision's caption rows are sliced with their segments).  SGD
    keeps the update linear in the gradient; dropout 0; no temporal
    encoder (att_input_mode region), as its BatchNorm normalizes each
    microbatch by its own statistics."""
    kw = dict(optim="sgd", learning_rate=1e-2, learning_rate_decay_start=-1,
              att_input_mode="region", seq_per_img=seq_per_img)
    cfg = tconfig.tiny_test_config(
        obj_interact=True, num_prop_per_frm=75, w_att2=0.05, w_grd=0.05,
        w_cls=0.1, batch_size=4, attn_train_impl="pallas", **kw)
    init = GVDModel(cfg).init(torch.Generator().manual_seed(3)).state_dict()
    batch = synthetic_batch(cfg, 4, seed=13)
    out = {}
    for accum in (1, 2):
        c = cfg.replace(grad_accum=accum)
        model = GVDModel(c)
        model.load_state_dict(init)
        m = Trainer(c, model).train_step(batch_to_device(c, batch, "cpu"),
                                         c.learning_rate)
        out[accum] = (m, model.state_dict())
    (m1, sd1), (m2, sd2) = out[1], out[2]
    for k in LOSS_KEYS + ("grad_norm",):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5,
                                   err_msg=k)
    for k, v in sd1.items():
        np.testing.assert_allclose(sd2[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_optimizer_groups_and_lr_schedule_match_jax():
    """The transferred layers train at 0.1 x the learning rate, the frozen
    LSTM biases are left out, and the epoch decay is the JAX Trainer's."""
    cfg = tconfig.tiny_test_config(t_attn_mode="bilstm")
    model = GVDModel(cfg)
    opt = make_optimizer(cfg, model)
    names = {id(p): n for n, p in model.named_parameters()}
    main, ft = opt.param_groups
    assert ft["lr_scale"] == 0.1 and main["lr_scale"] == 1.0
    assert sorted(names[id(p)] for p in ft["params"]) == [
        "ctx2pool_grd.0.bias", "ctx2pool_grd.0.weight", "vis_embed.0.weight"]
    in_opt = {names[id(p)] for g in opt.param_groups for p in g["params"]}
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen and not frozen & in_opt
    assert all(".bias_hh" in n for n in frozen)
    jt = JaxTrainer(jconfig.tiny_test_config())
    tt = Trainer(cfg, model)
    for epoch in range(12):
        assert tt.lr_at_epoch(epoch) == pytest.approx(jt.lr_at_epoch(epoch))


def test_fit_epoch_and_bf16_host_cast():
    """fit_epoch averages the step metrics over the loader; in bf16 the
    two feature banks go to the device as bf16 and geometry stays f32."""
    cfg = tconfig.tiny_test_config(obj_interact=True, batch_size=2,
                                   dtype="bfloat16", drop_prob_lm=0.5,
                                   enc_drop=0.2, w_att2=0.05, w_cls=0.1)
    batch = synthetic_batch(cfg, 2, seed=1)
    dev = batch_to_device(cfg, batch, "cpu")
    assert dev["seg_feat"].dtype == dev["ppls_feat"].dtype == torch.bfloat16
    assert dev["ppls"].dtype == dev["gt_boxes"].dtype == torch.float32
    assert "seg_id" not in dev
    model = GVDModel(cfg).init(torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model)
    metrics = trainer.fit_epoch([batch, synthetic_batch(cfg, 2, seed=2)],
                                epoch=0)
    assert set(metrics) == set(LOSS_KEYS) | {"grad_norm"}
    assert all(np.isfinite(v) for v in metrics.values())
