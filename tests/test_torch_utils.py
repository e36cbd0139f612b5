"""PyTorch port, the JAX package's last modules on the CPU, each held
against its JAX counterpart:

- ``data/synthetic_files.py::write_synthetic_dataset`` writes the JAX
  package's files: every JSON and ``.npy`` byte for byte, the proposals'
  HDF5 datasets equal, for the tiny config and with filler words;
- ``utils/params_io.py``: a JAX-written npz loads into the port and a
  port-written npz into the JAX ``load_variables`` (keys in JAX's order,
  arrays and dtypes exact, forward outputs within 1e-6), and a missing
  key or a shape that differs raises as in tests/test_params_io.py;
- ``utils/logging.py::ProfilerHooks``: ``Trainer.fit_epoch`` under
  ``profile_dir`` traces steps 2-4 and no other, with their spans; a
  CUDA trace without kernels raises;
- ``utils/logging.py::span``: with no profiler, ``generate`` and
  ``train_step`` record nothing and enter no ``record_function``; under
  one, each records its span tree, the bytes copied each way and host
  intervals inside the profile;
- ``tools/rehearsal.py --smoke``: two driver phases on one checkpoint
  directory, the resume, the four evaluation JSONs and the report."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import collections
import dataclasses
import json
import os
import time

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_description_tpu import config as jconfig
from grounded_video_description_tpu.data import synthetic_files as jsf
from grounded_video_description_tpu.models import GVDModel as JaxModel
from grounded_video_description_tpu.utils import params_io as jio
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.data import synthetic_files as tsf
from grounded_video_description_torch.data.synthetic import synthetic_batch
from grounded_video_description_torch.engine.evaluator import Evaluator
from grounded_video_description_torch.engine.trainer import (
    Trainer, batch_to_device)
from grounded_video_description_torch.models import (
    GVDModel, batch_to_tensors)
from grounded_video_description_torch.utils import params_io as tio
from grounded_video_description_torch.utils import logging as tlog
from grounded_video_description_torch.utils.logging import (
    ProfilerHooks, span_records, trace_events)
from grounded_video_description_torch.weights import (
    from_jax_variables, to_jax_variables)

FWD_ATOL = 1e-6


def _tcfg(jcfg):
    return tconfig.GVDConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tconfig.GVDConfig)}).validate()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# --------------------------------------------------------------------- #
# write_synthetic_dataset
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("extra_words", [0, 7])
def test_write_synthetic_dataset_writes_the_jax_files(tmp_path, extra_words):
    jcfg = jconfig.tiny_test_config()
    kw = dict(n_train=2, n_val=2, seed=3, n_extra_words=extra_words)
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    jpaths = jsf.write_synthetic_dataset(str(jroot), jcfg, **kw)
    tpaths = tsf.write_synthetic_dataset(str(troot), _tcfg(jcfg), **kw)
    assert json.dumps(tpaths).replace(str(troot), "R") \
        == json.dumps(jpaths).replace(str(jroot), "R")
    names = _files(jroot)
    assert _files(troot) == names and len(names) == 22
    for name in names:
        if name.endswith(".h5"):
            with h5py.File(jroot / name) as a, h5py.File(troot / name) as b:
                assert sorted(a) == sorted(b) == ["dets_labels", "dets_num"]
                for key in a:
                    assert a[key].dtype == b[key].dtype, key
                    np.testing.assert_array_equal(a[key][()], b[key][()])
        else:
            assert (troot / name).read_bytes() \
                == (jroot / name).read_bytes(), name
    words = json.loads((troot / "dic_anet.json").read_text())["ix_to_word"]
    assert sum(w.startswith("zzw") for w in words.values()) == extra_words


# --------------------------------------------------------------------- #
# params_io
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_vars():
    """The JAX tiny model (obj_interact, the LSTM encoder, both transfer
    embeddings, an additive grounder) and its variables, a batch, and the
    JAX MLE forward's losses on them."""
    jcfg = jconfig.tiny_test_config(
        obj_interact=True, t_attn_mode="bilstm", region_attn_mode="add",
        transfer_mode="both", w_att2=0.05, w_grd=0.05, w_cls=0.1)
    model = JaxModel(jcfg)
    variables = model.init(jax.random.PRNGKey(4))
    batch = synthetic_batch(_tcfg(jcfg), 3, seed=2)
    return dict(cfg=jcfg, model=model, variables=variables, batch=batch,
                losses=_jax_losses(model, variables, batch))


def _jax_losses(model, variables, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "seg_id"}
    losses, _ = jax.jit(lambda v, b: model.forward(
        v, b, mode="MLE", train=False))(variables, jb)
    return {k: float(v) for k, v in losses.items()}


def _port_losses(cfg, state, batch):
    model = GVDModel(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        losses, _ = model(batch_to_tensors(batch, "cpu"), mode="MLE",
                          train=False)
    return {k: float(v) for k, v in losses.items()}


def _leaves(tree):
    return list(tio._flatten(tree))


def test_params_io_jax_npz_loads_into_the_port(tmp_path, jax_vars):
    """A JAX ``save_variables`` file loaded onto the tree of a port model
    of another seed: its leaves, in JAX's order, equal the JAX variables
    exactly, in their dtypes, and the port's MLE forward on them equals
    its forward on the bridged JAX variables."""
    path = str(tmp_path / "jax.npz")
    jio.save_variables(path, jax_vars["variables"])
    cfg = _tcfg(jax_vars["cfg"])
    other = GVDModel(cfg).init(torch.Generator().manual_seed(9))
    got = tio.load_variables(path, to_jax_variables(other))
    want = jax.tree.map(np.asarray, jax_vars["variables"])
    assert [k for k, _ in _leaves(got)] == [
        jax.tree_util.keystr(kp)
        for kp, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    flat_want = dict(_leaves(want))
    for k, v in _leaves(got):
        assert v.dtype == flat_want[k].dtype, k
        np.testing.assert_array_equal(v, flat_want[k], err_msg=k)
    got_l = _port_losses(cfg, from_jax_variables(got), jax_vars["batch"])
    ref_l = _port_losses(cfg, from_jax_variables(want), jax_vars["batch"])
    for k in ref_l:
        np.testing.assert_allclose(got_l[k], ref_l[k], rtol=0,
                                   atol=FWD_ATOL, err_msg=k)


def test_params_io_port_npz_loads_into_jax(tmp_path, jax_vars):
    """The port's ``save_variables`` of ``to_jax_variables`` of a port
    model holding the JAX weights: the file's keys are the JAX file's in
    its order, the JAX ``load_variables`` restores every leaf exactly, and
    the JAX MLE forward on them equals the JAX forward on the original
    variables within 1e-6."""
    cfg = _tcfg(jax_vars["cfg"])
    model = GVDModel(cfg)
    model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, jax_vars["variables"])))
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tio.save_variables(tpath, to_jax_variables(model))
    jio.save_variables(jpath, jax_vars["variables"])
    with np.load(tpath) as t, np.load(jpath) as j:
        assert list(t.keys()) == list(j.keys())
        assert "params['obj_interact']['layers'][0]['ff']['l1']['b']" \
            in t.keys()
    template = jax_vars["model"].init(jax.random.PRNGKey(11))
    restored = jio.load_variables(tpath, template)
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(restored)[0],
            jax.tree_util.tree_flatten_with_path(jax_vars["variables"])[0]):
        assert a.dtype == b.dtype, jax.tree_util.keystr(kp)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = _jax_losses(jax_vars["model"], restored, jax_vars["batch"])
    for k, v in jax_vars["losses"].items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=FWD_ATOL,
                                   err_msg=k)


def test_params_io_missing_and_mismatched_keys(tmp_path):
    """tests/test_params_io.py's failures: a file without the state tree
    raises ``KeyError``, a template of other widths ``ValueError``."""
    cfg = tconfig.tiny_test_config()
    variables = to_jax_variables(GVDModel(cfg).init(
        torch.Generator().manual_seed(0)))
    path = str(tmp_path / "ckpt.npz")
    tio.save_variables(path, {"params": variables["params"]})
    with pytest.raises(KeyError, match="state"):
        tio.load_variables(path, variables)
    bigger = to_jax_variables(GVDModel(cfg.replace(rnn_size=128)).init(
        torch.Generator().manual_seed(0)))
    tio.save_variables(path, variables)
    with pytest.raises(ValueError, match="template"):
        tio.load_variables(path, bigger)


# --------------------------------------------------------------------- #
# ProfilerHooks
# --------------------------------------------------------------------- #

def test_profile_dir_traces_steps_two_to_four(tmp_path):
    """``profile_dir`` on the CPU: six steps of one epoch, a Chrome trace
    of steps 2, 3 and 4 (the window of JAX trainer.py:342-346) whose
    annotations are those three steps' spans and no other step's: three
    ``train_step``, each microbatch's ``forward`` and ``backward``, one
    ``optimizer`` a step; the hooks open and close only at their
    window's ends."""
    cfg = tconfig.tiny_test_config(profile_dir=str(tmp_path / "prof"))
    model = GVDModel(cfg).init(torch.Generator().manual_seed(1))
    trainer = Trainer(cfg, model)
    batches = [synthetic_batch(cfg, 2, seed=s) for s in range(6)]
    trainer.fit_epoch(batches, 0)
    prof = trainer.profiler
    assert prof.path and os.path.dirname(prof.path) == cfg.profile_dir
    assert os.path.basename(prof.path) == "trace_steps_2-4.json"
    names = collections.Counter(e["name"] for e in trace_events(
        prof.path, "user_annotation"))
    assert {k: names[k] for k in ("train_step", "forward", "backward",
                                  "optimizer", "encode")} == {
        "train_step": 3, "forward": 3, "backward": 3, "optimizer": 3,
        "encode": 3}
    hooks = ProfilerHooks(str(tmp_path / "h"), start_step=3, num_steps=2)
    opened = []
    for step in range(7):
        hooks.maybe_start(step)
        opened.append(hooks.active)
        hooks.maybe_stop(step + 1)
    assert opened == [False, False, False, True, True, False, False]


def test_profile_of_a_cuda_device_without_kernels_raises(tmp_path):
    hooks = ProfilerHooks(str(tmp_path), start_step=0, num_steps=1,
                          device="cuda")
    hooks.maybe_start(0)
    torch.ones(4).sum()
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        hooks.maybe_stop(1)


# --------------------------------------------------------------------- #
# spans
# --------------------------------------------------------------------- #

SERVE_TREE = [("d2h", "generate"), ("decode", "generate"),
              ("encode", "generate"), ("generate", None),
              ("h2d", "generate")]
TRAIN_TREE = sorted([("h2d", None), ("train_step", None),
                     ("optimizer", "train_step")]
                    + [("forward", "train_step"), ("encode", "forward"),
                       ("backward", "train_step")] * 2
                    + [("birnn", "encode")] * 4)


def _span_call(kind):
    """One call of ``kind`` at the tiny widths: a function that runs it
    and returns (the host arrays copied in, the host arrays returned)."""
    over = {"greedy": {}, "beam2": {"beam_size": 2},
            "transformer": {"att_model": "transformer"},
            "train": {"grad_accum": 2, "batch_size": 4}}[kind]
    cfg = tconfig.tiny_test_config(**over)
    model = GVDModel(cfg).init(torch.Generator().manual_seed(1))
    batch = synthetic_batch(cfg, cfg.batch_size, seed=3)
    arrays = {k: v for k, v in batch.items() if k != "seg_id"}
    if kind == "train":
        trainer = Trainer(cfg, model.train())

        def call():
            trainer.train_step(batch_to_device(cfg, batch, "cpu"),
                               cfg.learning_rate)
            return arrays, None
    else:
        ev = Evaluator(cfg, model.eval(), vocab=None)

        def call():
            return arrays, ev.generate(batch)
    return call


@pytest.mark.parametrize("kind", ["greedy", "beam2", "transformer",
                                  "train"])
def test_spans_are_recorded_under_a_profiler_alone(kind, monkeypatch):
    """(a) With no profiler a call records nothing and enters no
    ``record_function``; (b) under a CPU profile it records the span tree
    of its entry (serving: ``generate`` holding ``h2d``, ``encode``,
    ``decode`` and ``d2h``; training at two microbatches: ``h2d`` and
    ``train_step`` holding two ``forward`` (each holding ``encode``, which
    holds the two BiGRU layers' ``birnn``), two ``backward`` and one
    ``optimizer``), one ``record_function`` a span;
    (c) ``h2d`` counts the host arrays' bytes, ``d2h`` the returned
    arrays'; (d) each span's host interval lies within the clock's
    bounds around the profile, and within its parent's."""
    monkeypatch.setattr(tlog, "_records", collections.deque(maxlen=64))
    entered = []
    annotate = torch.profiler.record_function

    def counted(name):
        entered.append(name)
        return annotate(name)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    call = _span_call(kind)
    call()
    assert span_records() == [] and entered == []

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        arrays, out = call()
        t1 = time.time_ns()
    recs = span_records()
    tree = sorted((r.name, r.parent and r.parent.name) for r in recs)
    assert tree == (TRAIN_TREE if kind == "train" else SERVE_TREE)
    assert sorted(entered) == sorted(r.name for r in recs)
    nbytes = {r.name: r.nbytes for r in recs}
    assert nbytes["h2d"] == sum(np.asarray(v).nbytes
                                for v in arrays.values())
    if out is not None:
        assert nbytes["d2h"] == sum(a.nbytes for a in out.values())
    for r in recs:
        assert t0 <= r.t0_ns <= r.t1_ns <= t1
        if r.parent is not None:
            assert r.parent.t0_ns <= r.t0_ns <= r.t1_ns <= r.parent.t1_ns
        assert r.device_ms is None


# --------------------------------------------------------------------- #
# the rehearsal tool
# --------------------------------------------------------------------- #

def test_rehearsal_smoke_resumes_and_writes_the_eval_files(tmp_path):
    """``--smoke`` (tiny widths, ``--device cpu``): phase 1 trains and
    validates one epoch, phase 2 resumes from its checkpoint at epoch 1
    and runs the second; the report names the resume, the four evaluation
    JSONs, both epochs' rates and stats; it refuses to write over a
    report.  The driver's processes inherit ``OMP_NUM_THREADS=1`` from
    ``torch_threads`` and run one thread each, beside the other test
    workers."""
    from grounded_video_description_torch.tools import rehearsal

    out = tmp_path / "report.json"
    argv = ["--smoke", "--root", str(tmp_path / "r"), "--out", str(out),
            "--epochs_phase1", "1", "--epochs_total", "2"]
    rec = rehearsal.main(argv)
    assert json.loads(out.read_text()) == rec
    assert rec["resume_evidence"].endswith("at epoch 1")
    assert rec["artifacts_checked"] == sorted(rehearsal.EVAL_FILES)
    assert len(rec["per_epoch_seg_per_sec"]) == 2
    assert len(rec["val_stats_per_epoch"]) == 2
    assert rec["device"] == "cpu" and rec["epochs"] == 2
    assert not (tmp_path / "r").exists()
    with pytest.raises(SystemExit, match="exists"):
        rehearsal.main(argv)
