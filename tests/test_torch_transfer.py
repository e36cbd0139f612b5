"""PyTorch port, the Visual-Genome weight transfer against the JAX package
on the CPU: the GloVe helpers and the detector-pickle loader give the JAX
package's arrays; ``apply_weight_transfer`` on a port model, in the cls,
glove and both modes, gives the parameters of the JAX function after the
weights bridge; and the port's driver, on a data directory that holds
``detectron_weights``, applies the transfer the JAX driver applies and
prints its line."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from grounded_video_description_tpu import config as jconfig
from grounded_video_description_tpu.data import transfer as jtransfer
from grounded_video_description_tpu.data import vocab as jvocab
from grounded_video_description_tpu.models import GVDModel as JaxModel
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch import main as tmain
from grounded_video_description_torch.data import transfer as ttransfer
from grounded_video_description_torch.data import vocab as tvocab
from grounded_video_description_torch.data.synthetic_files import (
    write_synthetic_dataset)
from grounded_video_description_torch.models import GVDModel
from grounded_video_description_torch.weights import from_jax_variables

MODES = ["cls", "glove", "both"]
N_VG = 20
# the VG classes the target classes sit next to (background first)
NEAR = [0, 3, 7, 11, 15, 2, 19, 5, 8, 13, 1]


def _tcfg(jcfg):
    return tconfig.GVDConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tconfig.GVDConfig)}).validate()


def _detector(cfg, seed=0):
    """Synthetic detector weights for ``cfg``'s widths: an fc7 layer
    narrower than ``ctx2pool_grd``'s output and wider than its input (so
    both slices of the copy are exercised), and a VG classifier of N_VG
    classes over the detector's feature width."""
    rng = np.random.RandomState(seed)
    n_out = cfg.vis_encoding_size - 2
    return {
        "fc7_w": rng.randn(n_out, cfg.att_feat_size + 6).astype(np.float32),
        "fc7_b": rng.randn(n_out).astype(np.float32),
        "cls_score_w": rng.randn(N_VG, cfg.att_feat_size).astype(np.float32),
        "cls_score_b": rng.randn(N_VG).astype(np.float32),
    }


def _glove(cfg, seed=1):
    rng = np.random.RandomState(seed)
    glove_vg = rng.randn(N_VG, cfg.glove_dim)
    glove_cls = (glove_vg[NEAR[:cfg.detect_size + 1]]
                 + rng.randn(cfg.detect_size + 1, cfg.glove_dim) * 1e-3)
    return glove_vg.astype(np.float32), glove_cls.astype(np.float32)


def test_glove_helpers_match_jax(tmp_path):
    """GloVe from a file (a line of the wrong width skipped), the sha1
    fallback of a word it lacks, phrase vectors, and the class and word
    tables."""
    rng = np.random.RandomState(2)
    words = ["man", "dog", "ball", "red"]
    with open(tmp_path / "glove.txt", "w") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{v:.6f}" for v in rng.randn(12))
                    + "\n")
        f.write("short 1.0 2.0\n")
    with open(tmp_path / "vg.txt", "w") as f:
        f.write("man\nred ball\ndog,cat\nkite\n")
    for path in (str(tmp_path / "glove.txt"), None):
        jg, tg = jvocab.GloVe(path, dim=12), tvocab.GloVe(path, dim=12)
        assert sorted(tg.table) == sorted(jg.table)
        for w in words + ["kite", "short"]:
            np.testing.assert_array_equal(tg.vec(w), jg.vec(w))
        jcls = jvocab.load_vg_classes(str(tmp_path / "vg.txt"))
        assert tvocab.load_vg_classes(str(tmp_path / "vg.txt")) == jcls
        np.testing.assert_array_equal(tvocab.build_vg_cls_glove(jcls, tg),
                                      jvocab.build_vg_cls_glove(jcls, jg))
        itod = {1: "man", 2: "ball", 3: "kite"}
        np.testing.assert_array_equal(tvocab.build_class_glove(itod, tg),
                                      jvocab.build_class_glove(itod, jg))
        wtoi = {"red ball": "1", "dog": "2", "UNK": "3"}
        np.testing.assert_array_equal(tvocab.build_word_glove(wtoi, tg),
                                      jvocab.build_word_glove(wtoi, jg))


def test_load_detectron_weights_matches_jax(tmp_path):
    """The four pickles (f64 and f32), and a directory that lacks the
    classifier."""
    det = _detector(jconfig.tiny_test_config())
    det["fc7_w"] = det["fc7_w"].astype(np.float64)
    for name, value in det.items():
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump(value, f)
    for drop in ((), ("cls_score_w", "cls_score_b")):
        for name in drop:
            os.remove(tmp_path / f"{name}.pkl")
        got = ttransfer.load_detectron_weights(str(tmp_path))
        ref = jtransfer.load_detectron_weights(str(tmp_path))
        assert sorted(got) == sorted(ref) == sorted(set(det) - set(drop))
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_apply_weight_transfer_matches_jax(mode):
    """The port's surgery on a port model equals the JAX function's on the
    same weights, bridged: every parameter bit for bit (the fc7 copy into
    torch's (out, in) weight is the transpose of the JAX package's (in,
    out) one); background matched to background."""
    cfg = jconfig.tiny_test_config(transfer_mode=mode)
    variables = jax.tree.map(np.asarray,
                             JaxModel(cfg).init(jax.random.PRNGKey(3)))
    det = _detector(cfg)
    glove_vg, glove_cls = _glove(cfg)
    kw = dict(transfer_mode=mode, detectron=det, glove_vg_cls=glove_vg,
              glove_clss=glove_cls)
    ref = from_jax_variables({
        "params": jtransfer.apply_weight_transfer(
            dict(variables["params"]), **kw),
        "state": variables["state"]})
    model = GVDModel(_tcfg(cfg))
    model.load_state_dict(from_jax_variables(variables))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert ttransfer.apply_weight_transfer(model, **kw) is model
    got = model.state_dict()
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    n = det["fc7_w"].shape[0]
    w = got["ctx2pool_grd.0.weight"]
    assert torch.equal(w[:n], torch.from_numpy(
        det["fc7_w"][:, :cfg.att_feat_size]))
    assert torch.equal(w[n:], before["ctx2pool_grd.0.weight"][n:])
    changed = {k for k in ref if not torch.equal(got[k], before[k])}
    want = {"ctx2pool_grd.0.weight", "ctx2pool_grd.0.bias",
            "vis_embed.0.weight"}
    if mode != "glove":
        want.add("vis_classifiers_bias")
        assert torch.equal(got["vis_classifiers_bias"][:2], torch.from_numpy(
            det["cls_score_b"][[0, NEAR[1]]]))
    assert changed == want


def test_apply_weight_transfer_refuses_a_width_it_cannot_copy():
    cfg = jconfig.tiny_test_config(transfer_mode="glove")
    model = GVDModel(_tcfg(cfg))
    _, glove_cls = _glove(cfg)
    with pytest.raises(ValueError, match="into a parameter"):
        ttransfer.apply_weight_transfer(
            model, transfer_mode="glove", detectron={},
            glove_clss=glove_cls[:, :5])
    with pytest.raises(ValueError, match="needs"):
        ttransfer.apply_weight_transfer(
            model, transfer_mode="cls", detectron=_detector(cfg))


@pytest.fixture(scope="module")
def transfer_data(tmp_path_factory):
    """A tiny synthetic dataset on disk whose data directory also holds
    the detector's pickles and the VG class list (one line per VG class
    but the background)."""
    root = tmp_path_factory.mktemp("transfer")
    cfg = jconfig.tiny_test_config()
    paths = write_synthetic_dataset(str(root), _tcfg(cfg), n_train=1,
                                    n_val=1)
    os.makedirs(root / "detectron_weights")
    with open(root / "vg_object_vocab.txt", "w") as f:
        f.write("\n".join(["man", "woman", "dog", "ball", "red car"]
                          + [f"vg{i}" for i in range(N_VG - 6)]) + "\n")
    return root, paths


@pytest.mark.parametrize("mode", MODES)
def test_driver_applies_the_transfer(transfer_data, mode, capsys):
    """``build_model_and_vocab`` of the port's driver on a data directory
    with ``detectron_weights`` prints the JAX driver's line, and the
    transferred parameters equal the JAX driver's (its other weights come
    from another initialiser); the model is on the device asked for."""
    import main as jmain

    root, paths = transfer_data
    jcfg = jconfig.tiny_test_config(transfer_mode=mode).replace(
        **paths, data_path=str(root))
    det = _detector(jcfg, seed=4)
    for name, value in det.items():
        with open(root / "detectron_weights" / f"{name}.pkl", "wb") as f:
            pickle.dump(value, f)
    _, model, _, _, _ = tmain.build_model_and_vocab(_tcfg(jcfg),
                                                    torch.device("cpu"))
    out = capsys.readouterr().out
    assert f"applied detectron weight transfer ({mode})" in out
    assert next(model.parameters()).device.type == "cpu"
    _, _, variables, _, _, _ = jmain.build_model_and_vocab(jcfg)
    capsys.readouterr()
    ref = from_jax_variables(jax.tree.map(np.asarray, variables))
    got = model.state_dict()
    n = det["fc7_w"].shape[0]
    assert torch.equal(got["ctx2pool_grd.0.weight"][:n],
                       ref["ctx2pool_grd.0.weight"][:n])
    assert torch.equal(got["ctx2pool_grd.0.bias"][:n],
                       ref["ctx2pool_grd.0.bias"][:n])
    keys = ["vis_embed.0.weight"]
    if mode != "glove":
        keys.append("vis_classifiers_bias")
    for k in keys:
        assert torch.equal(got[k], ref[k]), k
