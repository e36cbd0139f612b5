"""PyTorch port, the evaluation slice against the JAX package on the CPU:
the port's ``Evaluator`` and the JAX ``Evaluator`` on the same weights
and the same numpy batches of a synthetic dataset on disk write
byte-identical densecap, attn-gen, attn-gt and grd-gt JSONs with equal
stats; the port's ``grounding_eval_cfg`` is ``main.grounding_eval_cfg``;
each copied evalmetrics scorer gives the JAX scorer's numbers; under
``vis_attn`` both draw the same attention overlays.  The dataset is
written by the port's ``write_synthetic_dataset`` (which
tests/test_torch_utils.py holds to the JAX package's) and read by the
JAX package's loader."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import dataclasses
import importlib
import itertools
import json
import os

import jax
import numpy as np
import pytest

from grounded_video_description_tpu import config as jconfig
from grounded_video_description_tpu.data.dataset import AnetDataset, Loader
from grounded_video_description_tpu.engine.evaluator import (
    Evaluator as JaxEvaluator)
from grounded_video_description_tpu.models import GVDModel as JaxModel
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.data.synthetic_files import (
    write_synthetic_dataset)
from grounded_video_description_torch.data.vocab import VocabTables
from grounded_video_description_torch.engine.evaluator import (
    Evaluator, grounding_eval_cfg)
from grounded_video_description_torch.models import GVDModel
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.weights import from_jax_variables

FILES = ("densecap_results/densecap-validation-parity.json",
         "results/attn-gen-sent-results-validation-parity.json",
         "results/attn-gt-sent-results-validation-parity.json",
         "results/grd-gt-sent-results-validation-parity.json")


def _tcfg(jcfg, **kw):
    return tconfig.GVDConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tconfig.GVDConfig)}).replace(**kw)


@pytest.fixture(scope="module")
def jax_eval(tmp_path_factory):
    """A synthetic dataset of 8 validation segments with 300 proposals
    each (so the obj_interact encoder takes K7's dispatch when its flag is
    on), read by the JAX dataset and loader in batches of 3 (the last one
    padded), and the JAX evaluator's files and stats on them."""
    root = tmp_path_factory.mktemp("eval")
    cfg = jconfig.tiny_test_config(obj_interact=True, num_prop_per_frm=75,
                                   batch_size=3)
    paths = write_synthetic_dataset(str(root / "data"), _tcfg(cfg),
                                    n_train=1, n_val=4, seed=0)
    cfg = cfg.replace(**paths, language_eval=True, eval_obj_grounding=True,
                      eval_obj_grounding_gt=True, id="parity",
                      data_path=str(root / "data"))
    dataset = AnetDataset(cfg, split=cfg.val_split)
    vocab = dataset.vocab
    cfg = cfg.replace(vocab_size=vocab.vocab_size,
                      detect_size=vocab.detect_size,
                      unk_idx=int(vocab.wtoi.get("UNK",
                                                 vocab.vocab_size - 1)))
    batches = list(Loader(dataset, 3, shuffle=False, drop_last=False,
                          pad_last=True))
    assert [b["n_valid"] for b in batches] == [3, 3, 2]
    model = JaxModel(cfg)
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(5)))
    ev = JaxEvaluator(cfg, model, vocab)
    out = str(root / "jax")
    stats = ev.evaluate(variables, batches, out_dir=out)
    stats.update(ev.eval_grounding_gt(variables, batches, out_dir=out))
    return dict(cfg=cfg, variables=variables, batches=batches, out=out,
                stats=stats, root=root, vocab=vocab)


@pytest.mark.parametrize("kernels", [False, True])
def test_evaluator_json_and_stats_match_jax(jax_eval, kernels):
    """With every kernel flag off, and with the evaluator's flags on (K6,
    K7, K3, K2; K1 off by the grounding guard), which on CPU tensors take
    their plain twins: the four JSONs byte for byte, and every stat but
    captions_per_sec equal."""
    ref = jax_eval
    cfg = grounding_eval_cfg(_tcfg(
        ref["cfg"], use_pallas=kernels, use_pallas_rnn=kernels,
        use_pallas_decode=kernels, use_pallas_mha=kernels))
    assert not cfg.use_pallas_encoder
    model = GVDModel(cfg)
    model.load_state_dict(from_jax_variables(ref["variables"]))
    ev = Evaluator(cfg, model.eval(),
                   VocabTables.from_file(ref["cfg"].input_dic))
    out = str(ref["root"] / f"port-{kernels}")
    _build.reset_launches()
    stats = ev.evaluate(ref["batches"], out_dir=out)
    stats.update(ev.eval_grounding_gt(ref["batches"], out_dir=out))
    assert not _build.launches
    for name in FILES:
        with open(os.path.join(ref["out"], name), "rb") as f:
            want = f.read()
        with open(os.path.join(out, name), "rb") as f:
            assert f.read() == want, name
    grd = json.loads(want)["results"]
    assert sum(len(v) for v in grd.values()) == 8      # every segment
    want_stats = {k: v for k, v in ref["stats"].items()
                  if k != "captions_per_sec"}
    got_stats = {k: v for k, v in stats.items() if k != "captions_per_sec"}
    assert got_stats == want_stats
    assert {"CIDEr", "box_accu_att", "cls_accu", "grd_f1_all"} <= set(stats)


def test_transformer_evaluator_json_and_stats_match_jax(jax_eval):
    """att_model "transformer" (its greedy decode; its zero att2 grounds
    every generated word on proposal 0 of each frame, as in the JAX
    evaluator) on the same dataset and batches: the densecap and attn-gen
    JSONs byte for byte, every stat but captions_per_sec equal."""
    from test_torch_transformer import _sharpen

    ref = jax_eval
    jcfg = ref["cfg"].replace(att_model="transformer")
    jm = JaxModel(jcfg)
    variables = jax.tree.map(np.asarray,
                             _sharpen(jm.init(jax.random.PRNGKey(6))))
    out_j = str(ref["root"] / "jax-transformer")
    want_stats = JaxEvaluator(jcfg, jm, ref["vocab"]).evaluate(
        variables, ref["batches"], out_dir=out_j)
    cfg = _tcfg(jcfg).validate()
    model = GVDModel(cfg)
    model.load_state_dict(from_jax_variables(variables))
    out = str(ref["root"] / "port-transformer")
    stats = Evaluator(cfg, model.eval(), VocabTables.from_file(
        jcfg.input_dic)).evaluate(ref["batches"], out_dir=out)
    for name in FILES[:2]:
        with open(os.path.join(out_j, name), "rb") as f:
            want = f.read()
        with open(os.path.join(out, name), "rb") as f:
            assert f.read() == want, name
    results = json.loads(want)["results"]
    assert sum(len(v) for v in results.values()) == 8
    drop = ("captions_per_sec",)
    assert ({k: v for k, v in stats.items() if k not in drop}
            == {k: v for k, v in want_stats.items() if k not in drop})


def _jpegs(root):
    from PIL import Image

    return {os.path.relpath(os.path.join(d, f), root):
            np.asarray(Image.open(os.path.join(d, f)))
            for d, _, fs in os.walk(root) for f in fs}


def test_evaluator_vis_attn_matches_jax(jax_eval, tmp_path, monkeypatch,
                                        capsys):
    """``vis_attn`` over frames that PIL wrote under ``image_path``
    (<seg_id>/NN.jpg; one segment has no directory and is passed over,
    one lacks a frame and is skipped with a message): the port's
    evaluator draws the JAX evaluator's JPEGs, under the same paths
    (vis/<id>/<seg_id>_generated_sent.jpg in the working directory), with
    equal pixels, and prints the same skip line."""
    from PIL import Image

    ref = jax_eval
    batch = ref["batches"][0]
    frames = tmp_path / "frames"
    rng = np.random.RandomState(0)
    for i, seg_id in enumerate(batch["seg_id"][:batch["n_valid"]]):
        if i == 2:
            continue
        (frames / seg_id).mkdir(parents=True)
        for f in range(ref["cfg"].num_sampled_frm - (i == 1)):
            Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)).save(
                frames / seg_id / f"{f + 1:02d}.jpg")
    jcfg = ref["cfg"].replace(vis_attn=True, image_path=str(frames))
    logs = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            JaxEvaluator(jcfg, JaxModel(jcfg), ref["vocab"]).evaluate(
                ref["variables"], [batch], out_dir="out")
        else:
            cfg = _tcfg(jcfg)
            model = GVDModel(cfg)
            model.load_state_dict(from_jax_variables(ref["variables"]))
            Evaluator(cfg, model.eval(), VocabTables.from_file(
                jcfg.input_dic)).evaluate([batch], out_dir="out")
        logs[side] = [line for line in capsys.readouterr().out.splitlines()
                      if line.startswith("[vis_attn]")]
    want = _jpegs(tmp_path / "jax" / "vis")
    got = _jpegs(tmp_path / "port" / "vis")
    assert sorted(got) == sorted(want) == [
        f"parity/{batch['seg_id'][0]}_generated_sent.jpg"]
    for name, pixels in want.items():
        np.testing.assert_array_equal(got[name], pixels, err_msg=name)
    assert logs["port"] == logs["jax"]
    assert len(logs["jax"]) == 1 and batch["seg_id"][1] in logs["jax"][0]


_GUARD = ("pallas_encoder_grounding_guard", "use_pallas_encoder",
          "eval_obj_grounding", "eval_obj_grounding_gt")


@pytest.mark.parametrize("flags", list(itertools.product(
    [False, True], repeat=4)), ids=lambda f: "".join(str(int(x)) for x in f))
def test_grounding_eval_cfg_matches_main(flags):
    from main import grounding_eval_cfg as main_grounding_eval_cfg
    kw = dict(zip(_GUARD, flags))
    jcfg = jconfig.GVDConfig(**kw)
    tcfg = tconfig.GVDConfig(**kw)
    jout, tout = main_grounding_eval_cfg(jcfg), grounding_eval_cfg(tcfg)
    assert (jout is jcfg) == (tout is tcfg)
    for f in dataclasses.fields(tconfig.GVDConfig):
        assert getattr(tout, f.name) == getattr(jout, f.name), f.name


# ---------------------------------------------------------------------- #
# the copied scorers
# ---------------------------------------------------------------------- #

GTS = {"0": ["a man throws a ball to the dog", "the man plays with a dog"],
       "1": ["a woman opens the door of the house"],
       "2": ["two boys run in the park near a tree", "kids run, then sit."]}
RES = {"0": ["a man throws the ball"], "1": ["the woman opens a window"],
       "2": ["boys run in a park"]}


def _both(module):
    return (importlib.import_module(
        f"grounded_video_description_tpu.evalmetrics.{module}"),
        importlib.import_module(
            f"grounded_video_description_torch.evalmetrics.{module}"))


def _grounding_files(tmp_path):
    ref = {"annotations": {"v_A": {"segments": {"0": {
        "process_clss": ["man", "ball"], "frame_ind": [0, 1],
        "process_bnd_box": [[10, 10, 50, 60], [5, 5, 20, 20]],
        "process_idx": [1, 4]}}}, "v_B": {"segments": {"0": {
            "process_clss": ["dog"], "frame_ind": [1],
            "process_bnd_box": [[30, 30, 80, 90]], "process_idx": [2]}}}}}
    sub = {"results": {"v_A": {"0": {
        "clss": ["man", "ball", "tree"], "idx_in_sent": [1, 4, 6],
        "bbox_for_all_frames": [[[12, 11, 49, 58], [0, 0, 5, 5]],
                                [[0, 0, 1, 1], [6, 5, 21, 19]],
                                [[1, 1, 9, 9], [1, 1, 9, 9]]]}}},
        "v_B": {"0": {"clss": ["dog"], "idx_in_sent": [2],
                      "bbox_for_all_frames": [[[0, 0, 9, 9],
                                               [100, 100, 120, 130]]]}}}
    split = {"validation": ["v_A", "v_B"]}
    files = []
    for name, obj in (("ref", ref), ("sub", sub), ("split", split)):
        files.append(str(tmp_path / f"{name}.json"))
        with open(files[-1], "w") as f:
            json.dump(obj, f)
    return files


def _densecap_files(tmp_path):
    gt = {"v_A": {"duration": 30.0, "timestamps": [[0, 15], [15, 30]],
                  "sentences": GTS["0"]},
          "v_B": {"duration": 20.0, "timestamps": [[2, 12]],
                  "sentences": GTS["1"]}}
    pred = {"results": {"v_A": [{"sentence": RES["0"][0],
                                 "timestamp": [0, 14.5]},
                                {"sentence": RES["2"][0],
                                 "timestamp": [16, 30]}],
                        "v_B": [{"sentence": RES["1"][0],
                                 "timestamp": [3, 11]}]}}
    paths = [str(tmp_path / "gt.json"), str(tmp_path / "pred.json")]
    for p, obj in zip(paths, (gt, pred)):
        with open(p, "w") as f:
            json.dump(obj, f)
    return paths


def _score(module, mods, tmp_path):
    """The scorer's outputs on fixed inputs, with module ``mods``."""
    if module == "tokenizer":
        return [(mods.ptb_tokenize(s), list(mods.ngrams(s.split(), 2)))
                for v in GTS.values() for s in v]
    if module == "bleu":
        return mods.compute_bleu(GTS, RES)
    if module == "cider":
        return mods.compute_cider(GTS, RES)
    if module == "meteor":
        return (mods.compute_meteor(GTS, RES), mods.meteor_impl(),
                mods.compute_meteor_fallback(GTS, RES))
    if module == "spice":
        return (mods.find_spice_jar(None, str(tmp_path)),
                mods.make_spice_fn(data_path=str(tmp_path)) is None)
    if module == "densecap":
        gt, pred = _densecap_files(tmp_path)
        ev = mods.DensecapEvaluator([gt], pred)
        return ev.evaluate(), ev.meteor_impl
    ref, sub, split = _grounding_files(tmp_path)
    ev = mods.GroundingEvaluator(ref, sub, split, ["validation"])
    return (ev.gt_grd_eval(), ev.grd_eval("all"), ev.grd_eval("loc"),
            mods.box_iou([0, 0, 10, 10], [5, 5, 15, 15]))


@pytest.mark.parametrize("module", ["tokenizer", "bleu", "cider", "meteor",
                                    "spice", "densecap", "grounding"])
def test_copied_scorer_matches_jax_package(module, tmp_path):
    jmod, tmod = _both(module)
    want = _score(module, jmod, tmp_path)
    got = _score(module, tmod, tmp_path)
    assert got == want
