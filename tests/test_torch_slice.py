"""PyTorch port, the greedy-captioning slice: the port's config and
synthetic batches against the JAX package's, encode banks and
sample_greedy against the JAX model on the same weights and batch (f32,
CPU), the weights bridge, seeded init, and that the port and
chip_smoke.py stay off JAX and off the CPU."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import dataclasses
import os
import subprocess
import sys

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
from grounded_video_description_tpu.models import GVDModel as JaxModel
from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.data import synthetic_batch
from grounded_video_description_torch.models import (
    GVDModel, batch_to_tensors)
from grounded_video_description_torch.weights import from_jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides, summation orders differ: 1e-4 abs
ATOL = 1e-4
B = 3

# (t_attn_mode, region_attn_mode): the flagship's, and the LSTM encoder
# with the additive grounder head
COMBOS = [("bigru", "mix"), ("bilstm", "add")]


def _cfg(t_attn_mode, region_attn_mode, **kw):
    """The JAX package's tiny config."""
    return jconfig.tiny_test_config(
        obj_interact=True, t_attn_mode=t_attn_mode,
        region_attn_mode=region_attn_mode, **kw)


def _tcfg(jcfg):
    """The port's config holding the same values as a JAX config."""
    return tconfig.GVDConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tconfig.GVDConfig)}).validate()


_DERIVED = ("max_proposal", "vocab_size_padded", "fc_feat_size_full",
            "vis_encoding_size", "pool_feat_size")
# (tiny, overrides): the defaults, the flagship (bench.py), and tiny
# configs like the ones the slice tests run
_CONFIG_CASES = {
    "defaults": (False, {}),
    "flagship": (False, dict(vocab_size=4905, detect_size=431,
                             obj_interact=True, use_pallas=True)),
    "tiny-bigru-mix": (True, dict(obj_interact=True)),
    "tiny-bilstm-add-both": (True, dict(
        obj_interact=True, t_attn_mode="bilstm", region_attn_mode="add",
        transfer_mode="both", vocab_pad_to=8)),
    # the README's training flags, with K4 in training
    "flagship-train": (False, dict(
        vocab_size=4905, detect_size=431, obj_interact=True, batch_size=240,
        grad_accum=8, w_att2=0.05, w_cls=0.1, attn_train_impl="pallas",
        dtype="bfloat16")),
    # the README's evaluation flags, with K6 and K7
    "flagship-eval": (False, dict(
        vocab_size=4905, detect_size=431, obj_interact=True,
        language_eval=True, eval_obj_grounding=True,
        eval_obj_grounding_gt=True, use_pallas=True, use_pallas_decode=True,
        use_pallas_mha=True, id="flagship", val_split="testing",
        densecap_references=["ref.json"], grd_reference="grd.json",
        split_file="split.json", data_path="d", val_images_use=200)),
    # the Masked-Transformer family at flagship width, and int8 banks
    "flagship-transformer": (False, dict(
        vocab_size=4905, detect_size=431, obj_interact=True,
        att_model="transformer")),
    "tiny-quantize-banks": (True, dict(
        obj_interact=True, quantize_banks=True, quantize_group_size=16)),
    # the training driver's fields, with K5 in training
    "flagship-driver": (False, dict(
        vocab_size=4905, detect_size=431, obj_interact=True, batch_size=240,
        grad_accum=8, w_att2=0.05, w_cls=0.1, use_pallas_encoder_train=True,
        dtype="bfloat16", input_json="cap.json", input_dic="dic.json",
        proposal_h5="p.h5", feature_root="fc6", seg_feature_root="seg",
        glove_file="g.txt", prop_thresh=0.3, exclude_bgd_det=True,
        packed_cache_dir="cache", train_split="training", max_epochs=30,
        val_every_epoch=1, checkpoint_path="save/run", start_from="save/a",
        load_best_score=0, inference_only=True, disp_interval=20,
        log_jsonl="m.jsonl", tensorboard_dir="tb", path_opt="o.yml")),
}


@pytest.mark.parametrize("case", list(_CONFIG_CASES))
def test_config_and_synthetic_batch_match_jax_package(case):
    """The port's own config and synthetic_batch are the JAX package's:
    same field values and derived widths, same arrays for a seed."""
    tiny, kw = _CONFIG_CASES[case]
    if tiny:
        jcfg = jconfig.tiny_test_config(**kw)
        tcfg = tconfig.tiny_test_config(**kw)
    else:
        jcfg, tcfg = jconfig.GVDConfig(**kw), tconfig.GVDConfig(**kw)
    jax_fields = {f.name for f in dataclasses.fields(jconfig.GVDConfig)}
    for f in dataclasses.fields(tconfig.GVDConfig):
        assert f.name in jax_fields, f.name
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    for name in _DERIVED:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    if case == "defaults":
        return
    b = 2 if case == "flagship" else B
    got, ref = synthetic_batch(tcfg, b, seed=3), jax_synthetic_batch(
        jcfg, b, seed=3)
    assert got.keys() == ref.keys()
    for key in ref:
        if key == "seg_id":
            assert got[key] == ref[key]
        else:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.fixture(scope="module", params=COMBOS, ids=lambda c: "-".join(c))
def jax_run(request):
    """JAX reference: the XLA path (use_pallas=False; the two default
    Pallas kernels are gated to the TPU backend)."""
    cfg = _cfg(*request.param, use_pallas=False)
    model = JaxModel(cfg)
    variables = model.init(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(
        cfg, B, seed=1).items() if k != "seg_id"}
    enc, _ = jax.jit(lambda v, b: model.encode(
        v["params"], v["state"], b, train=False))(variables, jb)
    out = jax.jit(model.sample_greedy)(variables, jb)
    tcfg = _tcfg(cfg)
    return dict(cfg=tcfg, variables=jax.tree.map(np.asarray, variables),
                batch=synthetic_batch(tcfg, B, seed=1),
                enc=jax.tree.map(np.asarray, enc),
                out=[np.asarray(o) for o in out])


def _port(ref, kernels):
    cfg = ref["cfg"].replace(use_pallas=kernels, use_pallas_rnn=kernels,
                             use_pallas_encoder=kernels)
    m = GVDModel(cfg)
    m.load_state_dict(from_jax_variables(ref["variables"]))
    return m.eval()


@pytest.mark.parametrize("kernels", [False, True])
def test_encode_banks_match_jax(jax_run, kernels):
    """Under no_grad, as sample_greedy runs it: the kernels have no
    backward, and their wrappers refuse inputs that require grad."""
    with torch.no_grad():
        enc = _port(jax_run, kernels).encode(
            batch_to_tensors(jax_run["batch"], "cpu"))
    for key in ("fc_feats", "conv_feats", "p_conv_feats", "pool_feats",
                "p_pool_feats", "g_pool_feats", "sim_mat_static",
                "sim_logits"):
        np.testing.assert_allclose(enc[key].numpy(), jax_run["enc"][key],
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("kernels", [False, True])
def test_sample_greedy_matches_jax(jax_run, kernels):
    """Tokens identical; logprobs, att2 logits and sim_mat_static within
    1e-4.  With the kernel flags on, CPU tensors take the plain versions
    and no kernel is launched."""
    from grounded_video_description_torch.ops.kernels import _build
    _build.reset_launches()
    seq, lp, att2, sim = _port(jax_run, kernels).sample_greedy(
        batch_to_tensors(jax_run["batch"], "cpu"))
    assert not _build.launches
    jseq, jlp, jatt2, jsim = jax_run["out"]
    assert seq.dtype == torch.int32 and seq.shape == jseq.shape
    np.testing.assert_array_equal(seq.numpy(), jseq)
    np.testing.assert_allclose(lp.numpy(), jlp, atol=ATOL)
    np.testing.assert_allclose(att2.numpy(), jatt2, atol=ATOL)
    np.testing.assert_allclose(sim.numpy(), jsim, atol=ATOL)


class _RecordingDict(dict):
    """A state dict that records which keys the importer read."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def get(self, key, default=None):
        if key in self:
            self.read.add(key)
        return super().get(key, default)

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "-".join(c))
def test_weights_roundtrip_through_importer_is_identity(combo):
    """JAX -> port state_dict -> import_torch_checkpoint /
    import_torch_bn_state -> JAX gives back every leaf exactly, and the
    importer reads every port key."""
    cfg = _cfg(*combo)
    variables = jax.tree.map(
        np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(2)))
    variables["state"]["bn"]["mean"] = np.linspace(
        -1, 1, cfg.rnn_size).astype(np.float32)
    variables["state"]["bn"]["count"] = np.float32(7)
    port = GVDModel(_tcfg(cfg))
    port.load_state_dict(from_jax_variables(variables))   # strict
    sd = _RecordingDict(port.state_dict())

    def nan_like(tree):
        return jax.tree.map(lambda a: np.full_like(a, np.nan), tree)

    params = import_torch_checkpoint(sd, nan_like(variables["params"]))
    state = import_torch_bn_state(sd, nan_like(variables["state"]))
    assert set(sd) == sd.read, sorted(set(sd) - sd.read)
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(variables),
            jax.tree.leaves({"params": params, "state": state})):
        np.testing.assert_array_equal(np.asarray(b, a.dtype), a,
                                      err_msg=jax.tree_util.keystr(path))


def test_seeded_init_distributions_and_reverse_bridge():
    """The port's own init: deterministic per seed, JAX's distributions,
    and its weights imported into JAX give the same greedy tokens."""
    cfg = _cfg("bigru", "mix")
    tcfg = _tcfg(cfg)
    a = GVDModel(tcfg).init(torch.Generator().manual_seed(0))
    b = GVDModel(tcfg).init(torch.Generator().manual_seed(0))
    c = GVDModel(tcfg).init(torch.Generator().manual_seed(1))
    for (k, va), vb in zip(a.state_dict().items(),
                           b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.logit.weight, c.logit.weight)
    bound = 1 / cfg.rnn_size ** 0.5
    w = a.logit.weight.detach().abs().max()
    assert 0.9 * bound < float(w) <= bound
    assert 0.9 < float(a.embed[0].weight.detach().std()) < 1.1
    w = a.core.att_lstm.weight_ih.detach().abs().max()
    assert float(w) <= bound          # U(+-1/sqrt(hidden)), hidden = rnn
    assert torch.all(a.core.att_lstm.bias_hh == 0)
    assert torch.all(a.vis_classifiers_bias == 0)
    assert torch.all(a.att_embed_aux[0].running_var == 1)

    jm = JaxModel(cfg.replace(use_pallas=False))
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    sd = a.state_dict()
    jvars = {"params": import_torch_checkpoint(sd, init["params"]),
             "state": import_torch_bn_state(sd, init["state"])}
    jb = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(
        cfg, B, seed=4).items() if k != "seg_id"}
    jseq = np.asarray(jax.jit(jm.sample_greedy)(jvars, jb)[0])
    seq = a.sample_greedy(batch_to_tensors(
        synthetic_batch(tcfg, B, seed=4), "cpu"))[0]
    np.testing.assert_array_equal(seq.numpy(), jseq)


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports JAX or the JAX
    package."""
    code = (
        "import sys\n"
        "import grounded_video_description_torch.config\n"
        "import grounded_video_description_torch.data.synthetic\n"
        "import grounded_video_description_torch.models\n"
        "import grounded_video_description_torch.weights\n"
        "import grounded_video_description_torch.ops.kernels._build\n"
        "import grounded_video_description_torch.ops.kernels.birnn\n"
        "import grounded_video_description_torch.ops.kernels.encoder_layer\n"
        "import grounded_video_description_torch.ops.kernels."
        "region_attention\n"
        "import grounded_video_description_torch.ops.kernels."
        "attention_train\n"
        "import grounded_video_description_torch.ops.geometry\n"
        "import grounded_video_description_torch.ops.quantize\n"
        "import grounded_video_description_torch.losses\n"
        "import grounded_video_description_torch.engine.trainer\n"
        "import grounded_video_description_torch.engine.evaluator\n"
        "import grounded_video_description_torch.data.vocab\n"
        "import grounded_video_description_torch.evalmetrics.bleu\n"
        "import grounded_video_description_torch.evalmetrics.cider\n"
        "import grounded_video_description_torch.evalmetrics.densecap\n"
        "import grounded_video_description_torch.evalmetrics.grounding\n"
        "import grounded_video_description_torch.evalmetrics.meteor\n"
        "import grounded_video_description_torch.evalmetrics.spice\n"
        "import grounded_video_description_torch.evalmetrics.tokenizer\n"
        "import grounded_video_description_torch.ops.kernels.decode_scan\n"
        "import grounded_video_description_torch.ops.kernels.mha\n"
        "import grounded_video_description_torch.ops.kernels."
        "encoder_layer_train\n"
        "import grounded_video_description_torch.data.dataset\n"
        "import grounded_video_description_torch.data.native_pack\n"
        "import grounded_video_description_torch.data.packed_cache\n"
        "import grounded_video_description_torch.engine.checkpoint\n"
        "import grounded_video_description_torch.utils.logging\n"
        "import grounded_video_description_torch.main\n"
        "import grounded_video_description_torch.models.beam\n"
        "import grounded_video_description_torch.data.transfer\n"
        "import grounded_video_description_torch.parallel.mesh\n"
        "import grounded_video_description_torch.parallel.spmd\n"
        "import grounded_video_description_torch.tools.eval_files\n"
        "import grounded_video_description_torch.tools.overfit\n"
        "import grounded_video_description_torch.tools.kernel_delta\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'grounded_video_description_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_the_test_process_runs_one_intra_op_thread():
    """``torch_threads``, imported first by every port test module, caps
    the process at one intra-op thread (6 workers x 8 OpenMP threads
    would share 8 cores)."""
    assert torch.get_num_threads() == 1


def test_a_child_process_starts_with_one_intra_op_thread():
    """A child started as the port's tests start the driver's processes
    (``subprocess`` with the inherited environment) reads
    ``OMP_NUM_THREADS=1`` and runs one intra-op thread."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.get_num_threads())"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1"]


def test_chip_smoke_refuses_to_run_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
