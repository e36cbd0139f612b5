"""PyTorch port, the device mesh (``grounded_video_description_torch/
parallel``) on the CPU: gloo ranks, each in its own process, at the tiny
widths in f32 on the plain path.  The data axis on two ranks:

- ``Trainer.train_step`` on two ranks equals one device's step on the
  whole batch, at dropout 0 and at the flagship rates, for the TopDown
  family (``att_input_mode`` both, so BatchNorm is synchronized; K4's
  plain version in the obj_interact encoder; two captions per segment)
  and the Masked-Transformer family (K5's plain version), both at
  ``grad_accum`` 2;
- the two-rank step equals the JAX package's jit mesh step
  (``make_sharded_train_step`` on a (2, 1) mesh of the virtual CPU
  devices) at dropout 0;
- K4's and K5's plain versions at a row offset ``row0`` equal the JAX
  interpret-mode kernels on the whole batch, restricted to those rows;
- the sharded ``evaluate`` (greedy, beam 3) and ``eval_grounding_gt``
  write the single-device port's JSONs byte for byte;
- the driver with ``--mesh_shape 2`` trains, validates and checkpoints,
  and a resume at world size 1 goes on as the run at 2 does; with no
  flag its data axis over eight cards is the JAX driver's auto-DP;
- the rank's loader rows, and one kernel build for two processes.

The model axis (``parallel/tensor.py``) on four ranks:

- (1, 2) and (2, 2) steps equal one device's, with a vocab padded to 2
  and the visual-word table split, and with a table that does not divide
  (replicated), under the flagship dropout rates;
- the (2, 2) step equals the JAX jit mesh step on a (2, 2) mesh of the
  virtual CPU devices (the logit split by the JAX TP rules);
- a checkpoint saved under (2, 2) holds the whole head and its moments,
  restores under one device and under (4, 1), and one more step there
  equals one device's;
- the sharded ``evaluate`` and ``eval_grounding_gt`` under (1, 2) write
  the single-device port's JSONs byte for byte.

The ranks of a case run in one spawned group; the JAX package is imported
only by the parent process."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import copy
import dataclasses
import json
import math
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.data.dataset import Loader
from grounded_video_description_torch.data.synthetic import synthetic_batch
from grounded_video_description_torch.engine.evaluator import Evaluator
from grounded_video_description_torch.engine.trainer import (
    Trainer, batch_to_device)
from grounded_video_description_torch.models import GVDModel
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.ops.kernels import (
    encoder_layer_train as k5)
from grounded_video_description_torch.ops.kernels.attention_train import (
    mha_probs_dropout_plain)
from grounded_video_description_torch.parallel import (
    Mesh, close_mesh, init_mesh, shard_model, shard_rows, spawn)
from grounded_video_description_torch.parallel import tensor as tp
from grounded_video_description_torch.tools.eval_files import (
    eval_references, eval_vocab)

WORLD = 2
TIMEOUT_S = 300
LR = 1e-2
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5            # of the tensor's largest |g|
# a tensor whose gradient is below this everywhere holds rounding noise
# around a true zero (as the region attention's alpha_net bias, by the
# softmax's shift invariance; tests/test_torch_train.py's TINY_GRAD): the
# other run's must be below it too
TINY_GRAD = 1e-7
BN_ATOL = 1e-6
PARAM_ATOL = 1e-6
LOSS_KEYS = ("loss", "lm_loss", "att2_loss", "ground_loss", "cls_loss")
FLAGSHIP_DROP = dict(drop_prob_lm=0.5, loc_drop=0.5, enc_drop=0.2)
NO_DROP = dict(drop_prob_lm=0.0, loc_drop=0.0, enc_drop=0.0)
FAMILIES = {
    # R = 4 x 75 = 300 proposals: the obj_interact encoder takes K4's
    # dispatch (topdown) or K5 (transformer), on the CPU their plain
    # versions, at the rank's row offset
    "topdown": dict(att_input_mode="both", attn_train_impl="pallas",
                    seq_per_img=2),
    "transformer": dict(att_model="transformer",
                        use_pallas_encoder_train=True, use_pallas=False),
}
TRAIN_CASES = {f"{fam}-{drop}": (fam, drop) for fam in FAMILIES
               for drop in ("drop0", "flagship-drop")}


def _train_cfg(family, drop):
    return tconfig.tiny_test_config(
        obj_interact=True, num_prop_per_frm=75, batch_size=4, grad_accum=2,
        optim="sgd", learning_rate=LR, learning_rate_decay_start=-1,
        w_att2=0.05, w_grd=0.05, w_cls=0.1, **FAMILIES[family],
        **(FLAGSHIP_DROP if drop == "flagship-drop" else NO_DROP))


def _record_step(trainer, batch, lr):
    """One ``train_step``; returns its metrics and each parameter's
    gradient as the optimizer took it."""
    grads, step = {}, trainer.optimizer.step

    def recording():
        grads.update({n: p.grad.clone()
                      for n, p in trainer.model.named_parameters()
                      if p.grad is not None})
        step()

    trainer.optimizer.step = recording
    metrics = trainer.train_step(batch, lr)
    return {k: float(v) for k, v in metrics.items()}, grads


def _step_result(trainer, batch, lr):
    metrics, grads = _record_step(trainer, batch, lr)
    return dict(metrics=metrics, grads=grads,
                state={k: v.clone()
                       for k, v in trainer.model.state_dict().items()})


# --------------------------------------------------------------------- #
# the two-rank group: every train case, then the evaluator
# --------------------------------------------------------------------- #

def _join(rank, tmp):
    return init_mesh("cpu", shape=(WORLD,), rank=rank,
                     init_method=f"file://{tmp}/rdzv")


def _group_worker(rank, tmp, jobs):
    mesh = _join(rank, tmp)
    out = {"train": {}, "eval": {}, "threads": torch.get_num_threads()}
    try:
        for name, (cfg, state, batch) in jobs["train"].items():
            rows = shard_rows(cfg.batch_size, cfg.grad_accum, rank, WORLD)
            model = GVDModel(cfg)
            model.load_state_dict(state)
            trainer = Trainer(cfg, model, mesh=mesh)
            local = {k: v[rows] for k, v in batch.items() if k != "seg_id"}
            out["train"][name] = _step_result(
                trainer, batch_to_device(cfg, local, "cpu"), LR)
        cfg, state, vocab, batches = jobs["eval"]
        for mode, beam in (("greedy", 1), ("beam3", 3)):
            model = GVDModel(cfg.replace(beam_size=beam))
            model.load_state_dict(state)
            ev = Evaluator(model.cfg, model.eval(), vocab, mesh)
            d = os.path.join(tmp, mode)
            stats = ev.evaluate(batches, out_dir=d)
            if beam == 1:
                stats.update(ev.eval_grounding_gt(batches, out_dir=d))
            out["eval"][mode] = stats
    finally:
        close_mesh(mesh)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _eval_job(root):
    """The tiny config with the eval flags, weights whose vocab head is
    scaled up (so that the captions hold words), a vocabulary, two batches
    of three (the second padded, two valid) and their reference files; no
    densecap reference exists, so the densecap JSON is written and not
    scored."""
    cfg = tconfig.tiny_test_config(
        batch_size=3, eval_obj_grounding=True, eval_obj_grounding_gt=True,
        language_eval=True, id="dp", use_pallas=False)
    vocab = eval_vocab(cfg)
    batches = []
    for i in range(2):
        batch = synthetic_batch(cfg, 3, seed=20 + i)
        batch["seg_id"] = [f"v_DP{3 * i + b:03d}_segment_{b:02d}"
                           for b in range(3)]
        batch["n_valid"] = 3 - i
        batches.append(batch)
    refs = eval_references(str(root), cfg, vocab, batches)
    refs["densecap_references"] = [str(root / "absent.json")]
    cfg = cfg.replace(**refs)
    model = GVDModel(cfg).init(torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.logit.weight.mul_(6.0)
    return cfg, model.state_dict(), vocab, batches


def _jax_mesh_step(shape):
    """The JAX package's jit mesh step on a ``shape`` mesh of the virtual
    CPU devices at dropout 0 (TopDown, BatchNorm on, accumulation 1, SGD;
    on a model axis the logit split by the JAX TP rules): its initial
    weights, the batch, its metrics and parameters after the step."""
    import jax
    import jax.numpy as jnp

    from grounded_video_description_tpu import config as jconfig
    from grounded_video_description_tpu.engine.trainer import (
        Trainer as JaxTrainer)
    from grounded_video_description_tpu.parallel import (
        make_mesh, make_sharded_train_step, shard_batch)
    from grounded_video_description_torch.weights import from_jax_variables

    jcfg = jconfig.tiny_test_config(
        batch_size=4, optim="sgd", learning_rate=LR,
        learning_rate_decay_start=-1, w_att2=0.05, w_grd=0.05, w_cls=0.1)
    mesh = make_mesh(shape, ("data", "model"),
                     devices=jax.devices()[:shape[0] * shape[1]])
    trainer = JaxTrainer(jcfg, mesh=mesh)
    st = trainer.shard_state(trainer.init_state(rng=jax.random.PRNGKey(7)))
    if shape[1] > 1:
        assert tuple(st.params["logit"]["w"].sharding.spec) == (
            None, "model")
    cfg = tconfig.GVDConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(tconfig.GVDConfig)}
                            ).validate()
    batch = synthetic_batch(cfg, 4, seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "seg_id"}
    step = make_sharded_train_step(trainer, mesh, donate=False)
    p, ms, _, m = step(st.params, st.model_state, st.opt_state,
                       shard_batch(mesh, jb), jax.random.PRNGKey(3), LR)
    tree = jax.tree.map(np.asarray, {"params": p, "state": ms})
    init = jax.tree.map(np.asarray, {"params": st.params,
                                     "state": st.model_state})
    return dict(cfg=cfg, batch=batch, init=from_jax_variables(init),
                after=from_jax_variables(tree),
                metrics={k: float(v) for k, v in m.items()})


@pytest.fixture(scope="module")
def jax_mesh_case():
    return _jax_mesh_step((2, 1))


@pytest.fixture(scope="module")
def group(tmp_path_factory, jax_mesh_case):
    """Every two-rank run of this file but the driver's, in one group:
    each train case from one seeded model and batch, the JAX case from
    the JAX weights, then the evaluator.  Returns the ranks' results and
    the jobs."""
    tmp = tmp_path_factory.mktemp("dp")
    train = {}
    for name, (fam, drop) in TRAIN_CASES.items():
        cfg = _train_cfg(fam, drop)
        state = GVDModel(cfg).init(
            torch.Generator().manual_seed(5)).state_dict()
        train[name] = (cfg, state, synthetic_batch(cfg, 4, seed=9))
    c = jax_mesh_case
    train["jax"] = (c["cfg"], c["init"], c["batch"])
    jobs = {"train": train, "eval": _eval_job(tmp)}
    spawn(_group_worker, WORLD, (str(tmp), jobs), timeout_s=TIMEOUT_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(ranks=ranks, jobs=jobs, tmp=tmp)


def _one_device(cfg, state, batch):
    model = GVDModel(cfg)
    model.load_state_dict(state)
    return _step_result(Trainer(cfg, model),
                        batch_to_device(cfg, batch, "cpu"), LR)


def _assert_same_run(got, ref):
    for k in LOSS_KEYS + ("grad_norm",):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert got["grads"].keys() == ref["grads"].keys()
    for n, g in ref["grads"].items():
        top = float(g.abs().max())
        if top < TINY_GRAD:
            assert float(got["grads"][n].abs().max()) < TINY_GRAD, n
            continue
        err = float((got["grads"][n] - g).abs().max())
        assert err <= GRAD_RTOL * top, (n, err)
    for n, v in ref["state"].items():
        w = got["state"][n]
        if n.endswith("num_batches_tracked"):
            assert int(w) == int(v), n
        else:
            atol = BN_ATOL if "running_" in n else PARAM_ATOL
            np.testing.assert_allclose(w.numpy(), v.numpy(), atol=atol,
                                       rtol=0, err_msg=n)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_dp_step_equals_one_device(group, case):
    """Loss terms and the gradient's norm before the clip within 1e-5
    relative, every gradient within 1e-5 of its
    tensor's largest |g| (or, where that is below ``TINY_GRAD``, below it
    too), BatchNorm running statistics within 1e-6 and the
    parameters after one SGD step within 1e-6 of one device's step on the
    whole batch, under dropout too (every rank draws the whole
    microbatch's masks and keeps its rows; K4 and K5 hash global rows).
    Both ranks end with the same weights."""
    cfg, state, batch = group["jobs"]["train"][case]
    ref = _one_device(cfg, state, batch)
    r0, r1 = (r["train"][case] for r in group["ranks"])
    _assert_same_run(r0, ref)
    for n, v in r0["state"].items():
        assert torch.equal(v, r1["state"][n]), n


def _assert_equals_jax_step(got, jax_case):
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got["metrics"][k],
                                   jax_case["metrics"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    for n, v in jax_case["after"].items():
        w = got["state"][n]
        if n.endswith("num_batches_tracked"):
            assert int(w) == int(v), n
        else:
            np.testing.assert_allclose(w.numpy(), v.numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=n)


def test_dp_step_equals_jax_mesh_step(group, jax_mesh_case):
    """The two-rank step against the JAX jit mesh step on the same
    weights and batch: losses within 1e-5 relative, parameters and
    BatchNorm statistics within 1e-6."""
    _assert_equals_jax_step(group["ranks"][0]["train"]["jax"], jax_mesh_case)


EVAL_FILES = {
    "greedy": ("densecap_results/densecap-validation-dp.json",
               "results/attn-gen-sent-results-validation-dp.json",
               "results/attn-gt-sent-results-validation-dp.json",
               "results/grd-gt-sent-results-validation-dp.json"),
    "beam3": ("densecap_results/densecap-validation-dp.json",
              "results/attn-gen-sent-results-validation-dp.json")}


@pytest.mark.parametrize("mode", list(EVAL_FILES))
def test_sharded_eval_writes_the_one_device_files(group, mode):
    """Rows 0 and 1-2 of each batch of three on the two ranks: the
    densecap and grounding JSONs byte for byte the single-device
    evaluator's (which tests/test_torch_eval.py holds to the JAX
    evaluator's), and every rank gets rank 0's scores."""
    cfg, state, vocab, batches = group["jobs"]["eval"]
    beam = 3 if mode == "beam3" else 1
    model = GVDModel(cfg.replace(beam_size=beam))
    model.load_state_dict(state)
    ev = Evaluator(model.cfg, model.eval(), vocab)
    d = str(group["tmp"] / f"one-{mode}")
    stats = ev.evaluate(batches, out_dir=d)
    if beam == 1:
        stats.update(ev.eval_grounding_gt(batches, out_dir=d))
    for name in EVAL_FILES[mode]:
        got = (group["tmp"] / mode / name).read_bytes()
        assert got == (Path(d) / name).read_bytes(), name
    caps = json.loads((Path(d) / EVAL_FILES[mode][0]).read_text())
    assert any(s["sentence"] for v in caps["results"].values() for s in v)
    r0, r1 = (r["eval"][mode] for r in group["ranks"])
    assert r0 == r1
    drop = ("captions_per_sec",)
    assert ({k: v for k, v in r0.items() if k not in drop}
            == {k: v for k, v in stats.items() if k not in drop})


# --------------------------------------------------------------------- #
# the model axis: four ranks, as (2, 2), (1, 2) on ranks 0-1 and (4, 1)
# --------------------------------------------------------------------- #

TP_WORLD = 4
PRE_CLIP_RTOL = 1e-6
TP_CASES = {
    # a vocab of 51 padded to 52, a table of 12 rows split in two
    "odd-vocab-split-table": dict(vocab_size=51, vocab_pad_to=2,
                                  detect_size=11),
    # a table of 11 rows: replicated, as the JAX _TP_OPTIONAL rule has it
    "replicated-table": dict(vocab_size=50, detect_size=10),
}


def _tp_cfg(case, **kw):
    return _train_cfg("topdown", "flagship-drop").replace(
        **TP_CASES[case], **kw).validate()


def _arrays(batch):
    return {k: v for k, v in batch.items() if k not in ("seg_id", "n_valid")}


def _tp_result(trainer, batch):
    """``_step_result`` with the split parameters' gradients and weights
    gathered whole."""
    metrics, grads = _record_step(trainer, batch, LR)
    shard = tp.shard_of(trainer.model)
    for n in (shard.names if shard else ()):
        grads[n] = tp._gathered(grads[n], shard)
    state = {k: v.clone()
             for k, v in tp.whole_state_dict(trainer.model).items()}
    return dict(metrics=metrics, grads=grads, state=state,
                split=shard.names if shard else ())


def _tp_train(cfg, state, batch, mesh, **trainer_kw):
    model = GVDModel(cfg)
    model.load_state_dict(state)
    trainer = Trainer(cfg, model, mesh=mesh, **trainer_kw)
    rows = shard_rows(cfg.batch_size, cfg.grad_accum, mesh.data_rank,
                      mesh.data)
    local = {k: v[rows] for k, v in batch.items() if k != "seg_id"}
    return trainer, batch_to_device(cfg, local, "cpu")


def _tp_worker(rank, tmp, jobs):
    """Every model-axis run: the train cases under (2, 2) and, on ranks 0
    and 1, under (1, 2); the JAX case under (2, 2); a checkpoint saved
    under (2, 2) and restored under (4, 1) for one more step; the
    evaluator under (1, 2)."""
    import torch.distributed as dist

    from grounded_video_description_torch.engine.checkpoint import (
        CheckpointManager)

    mesh22 = init_mesh("cpu", shape=(2, 2), rank=rank,
                       init_method=f"file://{tmp}/rdzv")
    # every rank makes both groups; ranks 0 and 1 form the (1, 2) mesh
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    mesh12 = Mesh((1, 2), rank, mesh22.device, pairs[0], None, pairs[0])
    mesh41 = Mesh((4, 1), rank, mesh22.device, mesh22.group, mesh22.group)
    out = {"train": {}, "eval": {}, "threads": torch.get_num_threads()}
    try:
        for name, (cfg, state, batch) in jobs["train"].items():
            for shape, mesh in (("2x2", mesh22), ("1x2", mesh12)):
                if shape == "1x2" and rank >= 2:
                    continue
                out["train"][name, shape] = _tp_result(
                    *_tp_train(cfg, state, batch, mesh))
        cfg, state, batch = jobs["ckpt"]
        trainer, local = _tp_train(cfg, state, batch, mesh22)
        trainer.train_step(local, LR)
        CheckpointManager(os.path.join(tmp, "ckpt"), mesh22).save(
            trainer, {"epoch": 1})
        fresh = GVDModel(cfg).init(torch.Generator().manual_seed(8))
        trainer, local = _tp_train(cfg, fresh.state_dict(), batch, mesh41)
        CheckpointManager(os.path.join(tmp, "ckpt"), mesh41).restore(
            trainer, load_best=False)
        out["restored41"] = {
            "model": {k: v.clone() for k, v in
                      trainer.model.state_dict().items()},
            "optimizer": copy.deepcopy(trainer.optimizer.state_dict())}
        out["ckpt41"] = _tp_result(trainer, local)
        if rank < 2:
            cfg, state, vocab, batches = jobs["eval"]
            for mode, beam in (("greedy", 1), ("beam3", 3)):
                model = GVDModel(cfg.replace(beam_size=beam))
                model.load_state_dict(state)
                shard_model(model, mesh12)
                ev = Evaluator(model.cfg, model.eval(), vocab, mesh12)
                # a decode before any evaluation gathers the head too
                out["eval"][mode, "generate"] = ev.generate(
                    _arrays(batches[0]))
                d = os.path.join(tmp, mode)
                stats = ev.evaluate(batches, out_dir=d)
                if beam == 1:
                    stats.update(ev.eval_grounding_gt(batches, out_dir=d))
                out["eval"][mode] = stats
    finally:
        close_mesh(mesh22)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def jax_tp_case():
    return _jax_mesh_step((2, 2))


@pytest.fixture(scope="module")
def tp_group(tmp_path_factory, jax_tp_case):
    tmp = tmp_path_factory.mktemp("tp")
    train = {}
    for case in TP_CASES:
        cfg = _tp_cfg(case)
        state = GVDModel(cfg).init(
            torch.Generator().manual_seed(5)).state_dict()
        train[case] = (cfg, state, synthetic_batch(cfg, 4, seed=9))
    c = jax_tp_case
    train["jax"] = (c["cfg"], c["init"], c["batch"])
    # one microbatch of four: a row for each rank of (4, 1)
    cfg = _tp_cfg("odd-vocab-split-table", grad_accum=1)
    ckpt = (cfg, GVDModel(cfg).init(
        torch.Generator().manual_seed(6)).state_dict(),
        synthetic_batch(cfg, 4, seed=10))
    cfg, state, vocab, batches = _eval_job(tmp)
    jobs = {"train": train, "ckpt": ckpt,
            "eval": (cfg.replace(vocab_pad_to=2), state, vocab, batches)}
    spawn(_tp_worker, TP_WORLD, (str(tmp), jobs), timeout_s=TIMEOUT_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(TP_WORLD)]
    return dict(ranks=ranks, jobs=jobs, tmp=tmp)


@pytest.mark.parametrize("ranks", ["group", "tp_group"])
def test_every_rank_runs_one_intra_op_thread(request, ranks):
    """A spawned rank imports this module, and with it ``torch_threads``,
    in an environment that holds its ``OMP_NUM_THREADS=1``: each of the
    two- and the four-rank groups runs one intra-op thread a rank."""
    got = [r["threads"] for r in request.getfixturevalue(ranks)["ranks"]]
    assert got == [1] * len(got)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("case", list(TP_CASES))
def test_model_axis_step_equals_one_device(tp_group, case, shape):
    """The step of a (1, 2) and of a (2, 2) mesh under the flagship
    dropout rates: losses within 1e-5 relative, the gradient's norm before
    the clip within 1e-6 relative, every gradient (the split ones gathered
    whole) within 1e-5 of its tensor's largest |g|, parameters and
    BatchNorm statistics within 1e-6 of one device's step on the whole
    batch.  The head is split on every rank, the table only where its
    rows divide; the ranks of a model group end with the same replicated
    weights."""
    cfg, state, batch = tp_group["jobs"]["train"][case]
    ref = _one_device(cfg, state, batch)
    ranks = [r["train"][case, shape] for r in tp_group["ranks"]
             if (case, shape) in r["train"]]
    assert len(ranks) == (2 if shape == "1x2" else 4)
    want_split = {"logit.weight", "logit.bias"} | (
        {"vis_embed.0.weight"} if case == "odd-vocab-split-table" else set())
    assert set(ranks[0]["split"]) == want_split
    assert cfg.vocab_size_padded == (52 if case.startswith("odd") else 50)
    for got in ranks:
        _assert_same_run(got, ref)
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   ref["metrics"]["grad_norm"],
                                   rtol=PRE_CLIP_RTOL)
        for n, v in got["state"].items():
            assert torch.equal(v, ranks[0]["state"][n]), n


def test_model_axis_step_equals_jax_mesh_step(tp_group, jax_tp_case):
    """The (2, 2) step against the JAX jit mesh step on a (2, 2) mesh (its
    logit split on the model axis) on the same weights and batch: losses
    within 1e-5 relative, parameters and BatchNorm within 1e-6."""
    _assert_equals_jax_step(tp_group["ranks"][0]["train"]["jax", "2x2"],
                            jax_tp_case)


def test_model_axis_checkpoint_restores_anywhere(tp_group):
    """A checkpoint saved after a (2, 2) step holds the whole padded head
    (52 rows) and its momentum: one device restores it exactly, every
    rank of a (4, 1) mesh too, and one more step under (4, 1) equals one
    more step on one device."""
    from grounded_video_description_torch.engine.checkpoint import (
        STATE_FILE, CheckpointManager)

    cfg, _, batch = tp_group["jobs"]["ckpt"]
    blob = torch.load(tp_group["tmp"] / "ckpt" / "model" / STATE_FILE,
                      weights_only=True)
    assert blob["model"]["logit.weight"].shape == (52, cfg.rnn_size)
    model = GVDModel(cfg)
    trainer = Trainer(cfg, model)
    CheckpointManager(str(tp_group["tmp"] / "ckpt")).restore(
        trainer, load_best=False)
    assert trainer.step == 1
    for n, v in blob["model"].items():
        assert torch.equal(model.state_dict()[n], v), n
    saved = blob["optimizer"]["state"]
    assert {tuple(st["momentum_buffer"].shape) for st in saved.values()
            } >= {(52, cfg.rnn_size), (52,), (12, cfg.att_feat_size)}
    for r in tp_group["ranks"]:
        got = r["restored41"]
        for n, v in blob["model"].items():
            assert torch.equal(got["model"][n], v), n
        for i, st in saved.items():
            assert torch.equal(got["optimizer"]["state"][i][
                "momentum_buffer"], st["momentum_buffer"]), i
    ref = _step_result(trainer, batch_to_device(cfg, batch, "cpu"), LR)
    for r in tp_group["ranks"]:
        _assert_same_run(r["ckpt41"], ref)


@pytest.mark.parametrize("mode", list(EVAL_FILES))
def test_model_axis_eval_writes_the_one_device_files(tp_group, mode):
    """The evaluator of a (1, 2) mesh, whose model holds half of the head:
    it gathers the whole head once per evaluation (and at a ``generate``
    before one) and splits each batch's rows over both ranks; the
    decode's tokens are the single-device evaluator's (its float arrays
    within 1e-6: a rank's products run on fewer rows), its densecap and
    grounding JSONs byte for byte, and both ranks get its scores."""
    cfg, state, vocab, batches = tp_group["jobs"]["eval"]
    beam = 3 if mode == "beam3" else 1
    model = GVDModel(cfg.replace(beam_size=beam))
    model.load_state_dict(state)
    ev = Evaluator(model.cfg, model.eval(), vocab)
    want = ev.generate(_arrays(batches[0]))
    got = tp_group["ranks"][0]["eval"][mode, "generate"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert tp_group["ranks"][1]["eval"][mode, "generate"] is None
    d = str(tp_group["tmp"] / f"one-{mode}")
    stats = ev.evaluate(batches, out_dir=d)
    if beam == 1:
        stats.update(ev.eval_grounding_gt(batches, out_dir=d))
    for name in EVAL_FILES[mode]:
        got = (tp_group["tmp"] / mode / name).read_bytes()
        assert got == (Path(d) / name).read_bytes(), name
    r0, r1 = (r["eval"][mode] for r in tp_group["ranks"][:2])
    drop = ("captions_per_sec",)
    assert r0 == r1
    assert ({k: v for k, v in r0.items() if k not in drop}
            == {k: v for k, v in stats.items() if k not in drop})


# --------------------------------------------------------------------- #
# K4 and K5 at a row offset, against the JAX interpret-mode kernels
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_row0_matches_jax_kernel_rows(kernel):
    """Rows 1-2 of a batch of three at row0 = 1 under dropout 0.3: the
    output and the gradients of sum(out * w) (K4: q, k, v; K5: x and the
    twelve weight gradients, those of rows 1-2 alone, the JAX cotangent
    zero on row 0) within 2e-5 of the JAX kernel on the whole batch."""
    import jax
    import jax.numpy as jnp

    from grounded_video_description_tpu.models import transformer as jxf
    from grounded_video_description_tpu.models.transformer import (
        _split_heads)
    from grounded_video_description_tpu.ops.pallas.attention_train import (
        mha_probs_dropout as jax_k4)
    from grounded_video_description_tpu.ops.pallas.encoder_layer import (
        pack_layer_params)
    from grounded_video_description_tpu.ops.pallas.encoder_layer_train \
        import fused_encoder_layer_train as jax_k5
    from grounded_video_description_torch.models import transformer as txf
    from grounded_video_description_torch.weights import encoder_state_dict

    B, R, D, H, HID, SEED, DROP = 3, 200, 32, 6, 24, -123456789, 0.3
    rng = np.random.RandomState(2)
    x, q, k, v = (rng.randn(B, R, D).astype(np.float32) for _ in range(4))
    w = rng.randn(B, R, D).astype(np.float32)
    w[0] = 0.0
    seed = torch.tensor([SEED & 0xFFFFFFFF])
    if kernel == "k4":
        def heads(t):
            return jnp.moveaxis(_split_heads(t, H), 2, 1)

        def jfn(a, b, c):
            o = jax_k4(heads(a), heads(b), heads(c), jnp.int32(SEED),
                       math.sqrt(D), DROP, True)
            return jnp.moveaxis(o, 1, 2).reshape(B, R, -1)[..., :D]

        ref, vjp = jax.vjp(jfn, q, k, v)
        jgrads = vjp(jnp.asarray(w))
        leaves = [torch.tensor(t[1:], requires_grad=True) for t in (q, k, v)]
        out = mha_probs_dropout_plain(*leaves, seed, n_heads=H,
                                      scale=math.sqrt(D), drop=DROP, row0=1)
        names = ("dq", "dk", "dv")
        got_grads, ref_grads = leaves, [g[1:] for g in jgrads]
    else:
        lp = jxf.encoder_init(jax.random.PRNGKey(0), D, HID, 1)

        def jfn(p, a):
            packed = pack_layer_params(p, H, jnp.float32)
            return jax_k5(a, packed, jnp.int32(SEED), DROP, H, 2, 1, True)

        ref, vjp = jax.vjp(jax.jit(jfn), lp["layers"][0], jnp.asarray(x))
        g_lp, g_x = vjp(jnp.asarray(w))
        enc = txf.Encoder(D, HID, 1)
        enc.load_state_dict(encoder_state_dict(lp))
        xt = torch.tensor(x[1:], requires_grad=True)
        out = k5.fused_encoder_layer_train_plain(
            xt, enc.layers[0].weights(), seed, n_heads=H, drop=DROP, row0=1)
        jw = encoder_state_dict({"layers": [g_lp]})
        params = dict(enc.named_parameters())
        names = ["dx"] + list(params)
        got_grads = [xt] + list(params.values())
        ref_grads = [np.asarray(g_x)[1:]] + [jw[n].numpy() for n in params]
    (out * torch.from_numpy(w[1:])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref)[1:],
                               rtol=2e-5, atol=2e-5)
    for name, leaf, g in zip(names, got_grads, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=2e-5, atol=2e-5, err_msg=name)


# --------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from grounded_video_description_torch.data.synthetic_files import (
        write_synthetic_dataset)

    root = tmp_path_factory.mktemp("dpdata")
    cfg = tconfig.tiny_test_config()
    return cfg, write_synthetic_dataset(str(root), cfg, n_train=4, n_val=4)


def _driver_argv(cfg, paths, save, epochs, extra=()):
    """tests/test_torch_cli.py's tiny flags at SGD (a step linear in the
    gradient), the default loc and encoder dropout on, one epoch of four
    steps of two segments between checkpoints."""
    dims = dict(
        rnn_size=cfg.rnn_size, input_encoding_size=cfg.input_encoding_size,
        att_hid_size=cfg.att_hid_size, fc_feat_size=cfg.fc_feat_size,
        rgb_feat_size=cfg.rgb_feat_size,
        motion_feat_size=cfg.motion_feat_size,
        att_feat_size=cfg.att_feat_size, t_attn_size=cfg.t_attn_size,
        num_sampled_frm=cfg.num_sampled_frm,
        num_prop_per_frm=cfg.num_prop_per_frm, glove_dim=cfg.glove_dim,
        loc_encoding_size=cfg.loc_encoding_size,
        seg_info_size=cfg.seg_info_size, seq_length=cfg.seq_length,
        batch_size=2, max_epochs=epochs, val_every_epoch=1, seed=11,
        optim="sgd", learning_rate=LR, checkpoint_path=save)
    argv = ["--device", "cpu"]
    for key, val in dims.items():
        argv += [f"--{key}", str(val)]
    for key, val in paths.items():
        if key == "densecap_references":
            argv += ["--densecap_references"] + list(val)
        else:
            argv += [f"--{key}", str(val)]
    return argv + list(extra)


def _driver(tmp, argv):
    from grounded_video_description_torch import main as tmain

    here = os.getcwd()
    os.makedirs(tmp, exist_ok=True)
    os.chdir(tmp)
    try:
        assert tmain.main(argv) == 0
    finally:
        os.chdir(here)


def test_driver_mesh_resumes_at_another_world_size(synth, tmp_path):
    """``--mesh_shape 2`` runs one epoch on two gloo workers, validates and
    checkpoints (rank 0 writes infos.json at epoch 1, step 4).  From that
    checkpoint a second epoch at world size 1 and one at world size 2 end
    with the same parameters (1e-6) and optimizer state: every rank holds
    the same generator state, which the checkpoint keeps."""
    from grounded_video_description_torch.engine.checkpoint import STATE_FILE

    cfg, paths = synth
    a, b = tmp_path / "a", tmp_path / "b"
    _driver(tmp_path / "run", _driver_argv(cfg, paths, str(a), 1,
                                           ["--mesh_shape", "2"]))
    infos = json.loads((a / "infos.json").read_text())
    assert infos["epoch"] == 1 and infos["step"] == 4
    shutil.copytree(a, b)
    _driver(tmp_path / "run2", _driver_argv(cfg, paths, str(a), 2,
                                            ["--mesh_shape", "2", "1"]))
    _driver(tmp_path / "run1", _driver_argv(cfg, paths, str(b), 2))
    blobs = [torch.load(d / "model" / STATE_FILE, weights_only=True)
             for d in (a, b)]
    assert blobs[0]["step"] == blobs[1]["step"] == 8
    for n, v in blobs[0]["model"].items():
        np.testing.assert_allclose(blobs[1]["model"][n].float().numpy(),
                                   v.float().numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=n)
    assert torch.equal(blobs[0]["generator"], blobs[1]["generator"])
    for i, st in blobs[0]["optimizer"]["state"].items():
        for key, val in st.items():
            np.testing.assert_allclose(
                blobs[1]["optimizer"]["state"][i][key].numpy(), val.numpy(),
                atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("batch,accum", [(240, 8), (240, 1), (12, 3),
                                         (7, 1)])
def test_auto_data_axis_is_the_jax_drivers(batch, accum, monkeypatch):
    """With no --mesh_shape and eight cards, the driver's data axis is the
    JAX driver's auto-DP over eight devices (the most that divide the
    microbatch; main.py:111-124), here the virtual CPU devices."""
    import jax

    import main as jmain
    from grounded_video_description_tpu import config as jconfig
    from grounded_video_description_torch import main as tmain

    assert jax.device_count() == 8
    _, mesh = jmain.build_driver_mesh(jconfig.tiny_test_config(
        batch_size=batch, grad_accum=accum))
    want = mesh.shape["data"] if mesh is not None else 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cfg = tconfig.tiny_test_config(batch_size=batch, grad_accum=accum)
    assert tmain.data_axis(cfg, torch.device("cuda")) == want
    assert tmain.data_axis(cfg, torch.device("cpu")) == 1


# --------------------------------------------------------------------- #
# the rank's rows, and one kernel build for many processes
# --------------------------------------------------------------------- #

def test_loader_reads_a_ranks_rows():
    """Rank r's batches are its slices of each microbatch of the
    single-process loader's batches, in the same global order."""
    from grounded_video_description_torch.data.dataset import ARRAY_KEYS

    rows = synthetic_batch(tconfig.tiny_test_config(), 24, seed=0)

    class Items:
        def __len__(self):
            return 24

        def __getitem__(self, i):
            return {**{k: rows[k][i] for k in ARRAY_KEYS}, "seg_id": f"s{i}"}

    kw = dict(shuffle=True, seed=4, num_threads=1)
    whole = list(Loader(Items(), 8, **kw))
    ranks = [list(Loader(Items(), 8, rank=r, world=2, accum=2, **kw))
             for r in range(2)]
    for i, batch in enumerate(whole):
        for r in range(2):
            mine = shard_rows(8, 2, r, 2)
            assert ranks[r][i]["seg_id"] == [batch["seg_id"][j]
                                             for j in mine]
            np.testing.assert_array_equal(ranks[r][i]["ppls"],
                                          batch["ppls"][mine])
            assert ranks[r][i]["n_valid"] == 4
    with pytest.raises(ValueError):
        shard_rows(8, 2, 0, 3)


def _build_worker(rank, build_dir, fake_bin):
    os.environ["PATH"] = f"{fake_bin}{os.pathsep}{os.environ['PATH']}"
    _build.BUILD_DIR = Path(build_dir)
    _build.build()


def test_kernel_library_is_built_once_for_many_processes(tmp_path):
    """Two processes that ask for the library at once (a fake ``nvcc``
    that takes half a second a source): one compile per source, one link,
    one ``.so``, no ``.o`` or ``.tmp`` left."""
    fake = tmp_path / "bin"
    fake.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = fake / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$*\" >> {log}\n"
        "out=''; prev=''\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        "sleep 0.5\n"
        "echo built > \"$out\"\n")
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    spawn(_build_worker, 2, (str(build_dir), str(fake)), timeout_s=120)
    calls = log.read_text().splitlines()
    n_cu = len(list(_build.CSRC_DIR.glob("*.cu")))
    assert sum(" -c " in c for c in calls) == n_cu
    assert sum(" -c " not in c for c in calls) == 1
    files = sorted(p.name for p in build_dir.iterdir())
    assert len([f for f in files if f.endswith(".so")]) == 1, files
    assert not [f for f in files if f.endswith((".o", ".tmp"))], files
