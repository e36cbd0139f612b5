"""PyTorch port, the training entry point against the JAX package on the
CPU (``--device cpu``), over a tiny dataset on disk written by the JAX
package's ``write_synthetic_dataset`` (as tests/test_cli_end_to_end.py):

- the port's ``AnetDataset`` items, ``Loader`` batches (shuffled, and
  ``pad_last``) and packed cache are the JAX package's byte for byte; its
  native packer equals its NumPy path;
- ``GVDConfig.from_cli`` gives the JAX values for every shared field,
  with and without a ``--path_opt`` YAML; a JAX flag the port does not
  read is an argparse error;
- a 1-epoch train + validate + checkpoint run of
  ``grounded_video_description_torch.main`` writes the files the JAX
  driver writes, under the same names, with the same infos keys, epoch
  and step;
- ``model-best`` follows CIDEr; crash recovery resumes the latest
  checkpoint, restoring model, optimizer and generator exactly;
  ``--start_from ... --inference_only`` runs; the saved state dict goes
  through the JAX package's ``import_torch_checkpoint`` with every key
  read;
- ``--mesh_shape 1 2`` (a model axis on two gloo workers) trains,
  validates and checkpoints as one device does with the vocab padded to
  2; a multi-host process index outside the host count raises; no
  visible card with ``--device cuda`` raises."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from grounded_video_description_tpu import config as jconfig
from grounded_video_description_tpu.data import dataset as jdataset
from grounded_video_description_tpu.data import packed_cache as jpacked
from grounded_video_description_tpu.data.synthetic_files import (
    write_synthetic_dataset)
from grounded_video_description_tpu.engine.checkpoint import (
    import_torch_bn_state, import_torch_checkpoint)
from grounded_video_description_tpu.models import GVDModel as JaxModel
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch import main as tmain
from grounded_video_description_torch.data import dataset as tdataset
from grounded_video_description_torch.data import native_pack
from grounded_video_description_torch.data import packed_cache as tpacked
from grounded_video_description_torch.data.synthetic import synthetic_batch
from grounded_video_description_torch.engine.checkpoint import (
    STATE_FILE, CheckpointManager)
from grounded_video_description_torch.engine.trainer import Trainer
from grounded_video_description_torch.models import GVDModel
from grounded_video_description_torch.utils.logging import MetricLogger

ID = "porttest"
EVAL_FILES = (f"densecap_results/densecap-validation-{ID}.json",
              f"results/attn-gen-sent-results-validation-{ID}.json",
              f"results/attn-gt-sent-results-validation-{ID}.json",
              f"results/grd-gt-sent-results-validation-{ID}.json")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """tests/test_cli_end_to_end.py's dataset: 8 training and 8
    validation segments of the tiny config."""
    root = tmp_path_factory.mktemp("synthdata")
    cfg = jconfig.tiny_test_config()
    paths = write_synthetic_dataset(str(root), cfg, n_train=4, n_val=4)
    return cfg, paths


def _argv(cfg, paths, extra=()):
    """tests/test_cli_end_to_end.py's flags: the tiny widths, batch 2, one
    epoch validated, the dataset's files."""
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
        batch_size=2, max_epochs=1, val_every_epoch=1,
        drop_prob_lm=0.0, seed=11)
    argv = []
    for k, v in dims.items():
        argv += [f"--{k}", str(v)]
    for k, v in paths.items():
        if k == "densecap_references":
            argv += ["--densecap_references"] + list(v)
        else:
            argv += [f"--{k}", str(v)]
    return argv + list(extra)


def _configs(synth):
    cfg, paths = synth
    jcfg = cfg.replace(**paths, batch_size=2)
    tcfg = tconfig.GVDConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tconfig.GVDConfig)})
    return jcfg, tcfg


def _assert_batches_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if k in ("seg_id", "n_valid"):
            assert got[k] == ref[k], k
        else:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# --------------------------------------------------------------------- #
# the host data path
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("split", ["training", "validation"])
def test_dataset_items_match_jax(synth, split):
    jcfg, tcfg = _configs(synth)
    ref = jdataset.AnetDataset(jcfg, split=split)
    got = tdataset.AnetDataset(tcfg, split=split)
    assert len(got) == len(ref) == 8
    assert got.vocab.vocab_size == ref.vocab.vocab_size
    for i in range(len(ref)):
        _assert_batches_equal(got[i], ref[i])


@pytest.mark.parametrize("kind", ["shuffled", "pad_last"])
def test_loader_batches_match_jax(synth, kind):
    """Two shuffled epochs of the training split (seed + epoch), or the
    validation split in order in batches of 3 with the last one padded."""
    jcfg, tcfg = _configs(synth)
    if kind == "shuffled":
        kw, split, epochs, bs = dict(shuffle=True, seed=5), "training", 2, 2
    else:
        kw = dict(shuffle=False, drop_last=False, pad_last=True)
        split, epochs, bs = "validation", 1, 3
    ref = jdataset.Loader(jdataset.AnetDataset(jcfg, split=split), bs, **kw)
    got = tdataset.Loader(tdataset.AnetDataset(tcfg, split=split), bs, **kw)
    for _ in range(epochs):
        rb, gb = list(ref), list(got)
        assert len(gb) == len(rb) == len(ref)
        for g, r in zip(gb, rb):
            _assert_batches_equal(g, r)
    if kind == "pad_last":
        assert rb[-1]["n_valid"] == 2 and len(rb[-1]["seg_id"]) == 3


def test_packed_cache_matches_jax(synth, tmp_path):
    """The cache files (every .npy and meta.json) are byte-identical, and
    the packed dataset's ordered batches equal the JAX one's."""
    jcfg, tcfg = _configs(synth)
    ref = jpacked.open_or_build(
        jdataset.AnetDataset(jcfg, split="validation"), str(tmp_path / "j"))
    got = tpacked.open_or_build(
        tdataset.AnetDataset(tcfg, split="validation"), str(tmp_path / "t"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert "meta.json" in names and len(names) == 12
    for name in names:
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name
    for g, r in zip(got.iter_batches(3, pad_last=True),
                    ref.iter_batches(3, pad_last=True)):
        _assert_batches_equal(g, r)
    # an unchanged fingerprint opens the cache as it is
    again = tpacked.open_or_build(
        tdataset.AnetDataset(tcfg, split="validation"), str(tmp_path / "t"))
    assert again.seg_ids == got.seg_ids


@pytest.mark.parametrize("exclude_bgd", [False, True])
def test_native_packer_matches_numpy_path(exclude_bgd):
    """The C++ packer (built into the port's _build/) and the NumPy path
    give the same arrays, into fresh and into preallocated buffers, with
    more proposals than slots and fewer."""
    assert native_pack.native_available()
    rng = np.random.RandomState(0)
    for n_in, n_box in ((30, 4), (12, 6)):
        props = rng.rand(n_in, 7) * 10
        props[:, 4] = rng.randint(0, 4, n_in)
        props[:, 5] = rng.randint(0, 3, n_in)
        props[:, 6] = rng.rand(n_in)
        feat = rng.randn(n_in, 24).astype(np.float32)
        frms = rng.randint(0, 4, n_box).astype(np.float32)
        kw = dict(prop_thresh=0.2, exclude_bgd=exclude_bgd, max_proposal=20,
                  max_box=6)
        native = native_pack.pack_segment(props, feat, frms, **kw)
        plain = native_pack.pack_segment(props, feat, frms, native=False,
                                         **kw)
        out = (np.full((20, 7), 9, np.float32), np.zeros(20, bool),
               np.full((20, 24), 9, np.float32), np.zeros((20, 6), bool))
        into = native_pack.pack_segment(props, feat, frms, out=out, **kw)
        for a, b, c in zip(native, plain, into):
            assert a.dtype == b.dtype == c.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, b)


# --------------------------------------------------------------------- #
# the config from flags and YAML
# --------------------------------------------------------------------- #

_CLI_CASES = {
    "flags": ["--batch_size", "4", "--obj_interact", "--no-use_pallas_rnn",
              "--densecap_references", "a.json", "b.json", "--start_from",
              "runs/a", "--val_split", "testing", "--learning_rate", "1e-3",
              "--use_pallas_encoder_train", "--log_jsonl", "m.jsonl"],
    "yaml": ["--path_opt", "{yaml}"],
    "yaml-and-flags": ["--path_opt", "{yaml}", "--max_epochs", "3",
                       "--no-exclude_bgd_det", "--mesh_shape", "2", "1"],
}


@pytest.mark.parametrize("case", list(_CLI_CASES))
def test_from_cli_matches_jax(case, tmp_path):
    """The same argv gives the JAX values for every field the port has:
    YAML over the defaults, explicit flags over both."""
    yml = tmp_path / "opt.yml"
    yml.write_text("batch_size: 6\nmax_epochs: 7\nexclude_bgd_det: true\n"
                   "prop_thresh: 0.3\nnum_workers: 5\nid: yml\n"
                   "checkpoint_path: null\n")
    argv = [a.format(yaml=yml) for a in _CLI_CASES[case]]
    ref = jconfig.GVDConfig.from_cli(argv)
    got = tconfig.GVDConfig.from_cli(argv)
    for f in dataclasses.fields(tconfig.GVDConfig):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


def test_from_cli_refuses_a_flag_the_port_does_not_read():
    for flag in (["--remat"], ["--rng_impl", "rbg"]):
        jconfig.GVDConfig.from_cli(flag)          # a JAX flag
        with pytest.raises(SystemExit):
            tconfig.GVDConfig.from_cli(flag)


# --------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------- #

def _in_dir(path, fn):
    """fn() with ``path`` as the working directory (the drivers write the
    evaluation JSONs there)."""
    here = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(here)


_RUN_FLAGS = ["--language_eval", "--eval_obj_grounding",
              "--eval_obj_grounding_gt", "--id", ID, "--w_att2", "0.05",
              "--w_cls", "0.1"]


@pytest.fixture(scope="module")
def driver_runs(synth, tmp_path_factory):
    """One epoch of training, a validation and a checkpoint by each
    driver on the same flags, each in its own working directory."""
    import main as jmain

    cfg, paths = synth
    out = {}
    for name, fn, extra in (
            ("jax", jmain.main, []),
            ("port", tmain.main, ["--device", "cpu"])):
        root = tmp_path_factory.mktemp(name)
        argv = extra + _argv(cfg, paths, _RUN_FLAGS + [
            "--checkpoint_path", str(root / "save")])
        assert _in_dir(root, lambda: fn(argv)) == 0
        out[name] = root
    return out


def test_driver_writes_the_jax_drivers_files(driver_runs):
    """model/, infos.json and the four evaluation JSONs under the JAX
    names; infos with the JAX keys (histories too), epoch and step; the
    first validation is the best so far, as in the JAX run."""
    jroot, troot = driver_runs["jax"], driver_runs["port"]
    for root in (jroot, troot):
        assert os.path.isdir(root / "save" / "model")
        assert os.path.isdir(root / "save" / "model-best")
        for name in EVAL_FILES:
            assert os.path.isfile(root / name), (root, name)
    assert os.path.isfile(troot / "save" / "model" / STATE_FILE)
    for name in ("infos.json", "infos-best.json"):
        ref = json.loads((jroot / "save" / name).read_text())
        got = json.loads((troot / "save" / name).read_text())
        assert got.keys() == ref.keys()
        assert got["histories"].keys() == ref["histories"].keys()
        for k in ("epoch", "step", "vocab_size"):
            assert got[k] == ref[k], k
        assert got["epoch"] == 1 and got["step"] == 4
        assert got["histories"]["val"].keys() == {"0"}
    for name in EVAL_FILES:
        ref = json.loads((jroot / name).read_text())
        got = json.loads((troot / name).read_text())
        assert got.keys() == ref.keys(), name
        # per video: its captions (densecap) or its segments (attn, grd)
        assert {v: len(s) for v, s in got["results"].items()} == \
            {v: len(s) for v, s in ref["results"].items()}, name


def test_saved_state_goes_through_import_torch_checkpoint(synth,
                                                          driver_runs):
    """Every key of the saved model state dict is read by the JAX
    package's importers, and every leaf they fill is finite."""
    jcfg, _ = _configs(synth)
    blob = torch.load(driver_runs["port"] / "save" / "model" / STATE_FILE,
                      weights_only=True)
    read = set()

    class Recording(dict):
        def get(self, key, default=None):
            if key in self:
                read.add(key)
            return super().get(key, default)

        def __getitem__(self, key):
            read.add(key)
            return super().__getitem__(key)

    sd = Recording(blob["model"])
    jcfg = jcfg.replace(vocab_size=blob["model"]["embed.0.weight"].shape[0],
                        detect_size=blob["model"][
                            "vis_embed.0.weight"].shape[0] - 1)
    init = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    nan = jax.tree.map(lambda a: np.full_like(a, np.nan), init)
    params = import_torch_checkpoint(sd, nan["params"])
    state = import_torch_bn_state(sd, nan["state"])
    assert set(sd) == read, sorted(set(sd) - read)
    for leaf in jax.tree.leaves({"params": params, "state": state}):
        assert np.isfinite(np.asarray(leaf)).all()


class _CiderEvaluator:
    """An evaluator whose CIDEr follows a script, one value per call."""

    def __init__(self, scores):
        self.scores = list(scores)

    def evaluate(self, loader, *, epoch, out_dir):
        return {"CIDEr": self.scores.pop(0)}


def _tiny_trainer(**kw):
    cfg = tconfig.tiny_test_config(obj_interact=True, batch_size=2,
                                   use_pallas_encoder_train=True,
                                   enc_drop=0.2, **kw)
    model = GVDModel(cfg).init(torch.Generator().manual_seed(0))
    return cfg, Trainer(cfg, model)


def test_best_checkpoint_only_when_cider_rises(tmp_path):
    """CIDEr 0.2, 0.1, 0.3 over three validated epochs: model-best is
    written at epochs 0 and 2, model at each; histories keep every
    epoch."""
    cfg, trainer = _tiny_trainer(max_epochs=3, val_every_epoch=1)
    batches = [synthetic_batch(cfg, 2, seed=1)]
    ckpt = CheckpointManager(str(tmp_path))
    records = tmain.run(cfg, trainer, _CiderEvaluator([0.2, 0.1, 0.3]),
                        batches, None, ckpt, MetricLogger(), {"epoch": 0})
    assert [r["best"] for r in records] == [True, False, True]
    infos = json.loads((tmp_path / "infos.json").read_text())
    best = json.loads((tmp_path / "infos-best.json").read_text())
    assert infos["epoch"] == best["epoch"] == 3
    assert infos["best_val_score"] == 0.3 and infos["step"] == 3
    assert sorted(infos["histories"]["val"]) == ["0", "1", "2"]
    cfg, trainer = _tiny_trainer(max_epochs=2, val_every_epoch=1)
    ckpt = CheckpointManager(str(tmp_path / "b"))
    tmain.run(cfg, trainer, _CiderEvaluator([0.2, 0.1]), batches, None,
              ckpt, MetricLogger(), {"epoch": 0})
    best = json.loads((tmp_path / "b" / "infos-best.json").read_text())
    assert best["epoch"] == 1 and best["best_val_score"] == 0.2


def test_restore_gives_back_model_optimizer_and_generator(tmp_path):
    """A checkpoint restored into a fresh trainer holds the saved model,
    optimizer and dropout generator state exactly, and its step; the next
    step from both trainers gives the same parameters (the same masks)."""
    cfg, trainer = _tiny_trainer()
    batch = synthetic_batch(cfg, 2, seed=2)
    trainer.fit_epoch([batch], epoch=0)
    CheckpointManager(str(tmp_path)).save(trainer, {"epoch": 1})
    _, fresh = _tiny_trainer()
    infos = CheckpointManager(str(tmp_path)).restore(fresh, load_best=True)
    assert infos["epoch"] == 1 and fresh.step == trainer.step == 1
    for (k, a), b in zip(trainer.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert torch.equal(trainer.generator.get_state(),
                       fresh.generator.get_state())
    for t in (trainer, fresh):
        t.fit_epoch([batch], epoch=1)
    for (k, a), b in zip(trainer.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_crash_recovery_and_start_from_inference_only(synth, driver_runs,
                                                      tmp_path):
    """A second run on the first run's checkpoint_path resumes its latest
    checkpoint at epoch 1 and trains epoch 1 only; then --start_from that
    directory with --inference_only validates once and writes no
    checkpoint."""
    import shutil

    cfg, paths = synth
    save = tmp_path / "save"
    shutil.copytree(driver_runs["port"] / "save", save)
    argv = ["--device", "cpu"] + _argv(cfg, paths, _RUN_FLAGS + [
        "--checkpoint_path", str(save), "--max_epochs", "2"])
    assert _in_dir(tmp_path, lambda: tmain.main(argv)) == 0
    infos = json.loads((save / "infos.json").read_text())
    assert infos["epoch"] == 2 and infos["step"] == 8
    assert sorted(infos["histories"]["loss"]) == ["0", "1"]
    argv = ["--device", "cpu"] + _argv(cfg, paths, [
        "--checkpoint_path", str(tmp_path / "none"), "--start_from",
        str(save), "--inference_only", "--language_eval", "--id", "inf",
        "--max_epochs", "3"])
    assert _in_dir(tmp_path, lambda: tmain.main(argv)) == 0
    assert os.path.isfile(
        tmp_path / "densecap_results" / "densecap-validation-inf.json")
    assert not os.path.isdir(tmp_path / "none" / "model")


def test_driver_runs_the_transformer_family(synth, tmp_path):
    """--att_model transformer through the port's driver: one epoch of
    training, a validation that writes the densecap and attn-gen JSONs
    (the GT-sentence grounding eval is the TopDown family's and is
    skipped), and a checkpoint whose model holds the decoder."""
    cfg, paths = synth
    argv = ["--device", "cpu"] + _argv(cfg, paths, _RUN_FLAGS + [
        "--checkpoint_path", str(tmp_path / "save"), "--att_model",
        "transformer"])
    assert _in_dir(tmp_path, lambda: tmain.main(argv)) == 0
    for name in EVAL_FILES:
        assert os.path.isfile(tmp_path / name) == ("-gt-" not in name), name
    infos = json.loads((tmp_path / "save" / "infos.json").read_text())
    assert infos["epoch"] == 1 and infos["step"] == 4
    blob = torch.load(tmp_path / "save" / "model" / STATE_FILE,
                      weights_only=True)
    assert any(k.startswith("cap_model.decoder.") for k in blob["model"])


def test_driver_model_axis_writes_the_one_device_files(synth, tmp_path):
    """``--mesh_shape 1 2`` on the CPU: two gloo workers split the vocab
    head (the driver pads it to 2), train one epoch under the default loc
    and encoder dropout, validate and checkpoint.  The four evaluation
    JSONs are byte for byte those of one device run with ``--vocab_pad_to
    2``, and the checkpoint holds the whole head, within 1e-6 of the one
    device's, at the same epoch and step.  SGD, a step linear in the
    gradient: Adam turns the rounding noise of a gradient that is zero in
    exact arithmetic (the region attention's alpha_net bias) into steps of
    the learning rate's size."""
    cfg, paths = synth
    blobs = {}
    for name, extra in (("mesh", ["--mesh_shape", "1", "2"]),
                        ("one", ["--vocab_pad_to", "2"])):
        root = tmp_path / name
        argv = ["--device", "cpu"] + _argv(cfg, paths, _RUN_FLAGS + extra + [
            "--optim", "sgd", "--checkpoint_path", str(root / "save")])
        assert _in_dir(root, lambda: tmain.main(argv)) == 0
        blobs[name] = torch.load(root / "save" / "model" / STATE_FILE,
                                 weights_only=True)
    for name in EVAL_FILES:
        assert (tmp_path / "mesh" / name).read_bytes() \
            == (tmp_path / "one" / name).read_bytes(), name
    got, ref = blobs["mesh"], blobs["one"]
    assert got["step"] == ref["step"] == 4
    assert got["model"]["logit.weight"].shape[0] % 2 == 0
    for n, v in ref["model"].items():
        assert got["model"][n].shape == v.shape, n
        np.testing.assert_allclose(got["model"][n].float().numpy(),
                                   v.float().numpy(), atol=1e-6, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("case", ["multi-host", "no-card"])
def test_unported_paths_raise(synth, tmp_path, case):
    cfg, paths = synth
    extra = ["--checkpoint_path", str(tmp_path / "save")]
    device = ["--device", "cpu"]
    if case == "multi-host":
        extra += ["--coordinator_address", "localhost:1234",
                  "--num_processes", "2", "--process_id", "2"]
    else:
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        device = []                                # the default, cuda
    err = {"multi-host": ValueError, "no-card": RuntimeError}[case]
    with pytest.raises(err):
        tmain.main(device + _argv(cfg, paths, extra))
