"""The language-model captioner (``att_model`` "lm", ``models/lm.py``)
against the benchmark's plain reference (``benchmark/reference/lm.py``),
at a tiny size in float32 on seeded random weights
(``benchmark/weights_lm.py``): the prefill and the absorbed decode
through the latent cache against the reference's full forward, in logits
at every step; the grouped dispatch against the reference's expert loop
(and ``torch._grouped_mm`` against one GEMM an expert, where torch has
it); the score bias moving the picks but not their weights; and
``Evaluator.generate`` end to end over a GVD model built on the meta
device."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import weights_lm  # noqa: E402
from benchmark.reference import lm as ref_lm  # noqa: E402
from grounded_video_description_torch.config import tiny_test_config  # noqa: E402
from grounded_video_description_torch.models import lm  # noqa: E402

BLOCK = dict(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
             num_hidden_layers=3, first_k_dense_replace=1,
             intermediate_size=96, n_routed_experts=8, num_experts_per_tok=2,
             n_shared_experts=1, moe_intermediate_size=24, vocab_size=256,
             rms_norm_eps=1e-5, rope_theta=800000,
             routed_scaling_factor=2.446, q_lora_rank=None,
             scoring_func="sigmoid", topk_method="noaux_tc", n_group=1,
             topk_group=1, norm_topk_prob=True, projector_hidden_size=32,
             start_id=1, torch_dtype="float32")
D_VISUAL, B, VISUAL, STEPS = 20, 3, 12, 6


def _weights(seed=5):
    return weights_lm.lm_weights({"lm": BLOCK,
                                  "model": {"rnn_size": D_VISUAL}},
                                 seed, "cpu")


def _model(weights):
    with torch.device("meta"):
        m = lm.LanguageModel(BLOCK, D_VISUAL)
    m.load_state_dict(weights, assign=True)
    return m


def case_cache_matches_full_forward():
    """Prefill, then the absorbed decode through the latent cache: the
    logits at every step within 1e-5 of the reference's full forward
    over the same words."""
    w = _weights()
    m = _model(w)
    g = torch.Generator().manual_seed(0)
    vis = [torch.randn(B, 5, D_VISUAL, generator=g),
           torch.randn(B, VISUAL - 5, D_VISUAL, generator=g)]
    words = torch.randint(1, BLOCK["vocab_size"], (B, STEPS - 1),
                          generator=g)
    with torch.no_grad():
        x = m.visual_tokens(vis)
        S = x.shape[1]
        cache = m.new_cache(B, S + STEPS - 1, "cpu")
        hs = [m.prefill(x, cache)]
        for t in range(STEPS - 1):
            hs.append(m.step(words[:, t], S + t, cache))
        got = m.lm_head(m.norm(torch.stack(hs, 1)))
    want = ref_lm.LMReference(BLOCK, w).logits(
        ref_lm.LMOps(), torch.cat(vis, 1), words)
    assert got.shape == want.shape == (B, STEPS, BLOCK["vocab_size"])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    # greedy serves each word's log-probability of the same forward
    seq, lp = m.greedy(vis, STEPS)
    want = ref_lm.LMReference(BLOCK, w).logits(
        ref_lm.LMOps(), torch.cat(vis, 1), seq[:, :-1])
    err, gap = ref_lm.position_errors(want, seq, lp)
    assert float(err.max()) < 1e-5 and float(gap.max()) < 1e-5


def case_grouped_dispatch_matches_expert_loop():
    """The MoE over tokens sorted by expert (each expert's rows
    contiguous) against the reference's loop over experts; and
    ``torch._grouped_mm`` in bf16 against one GEMM an expert."""
    w = _weights(7)
    m = _model(w)
    layer = m.layers[1].mlp
    x = torch.randn(40, BLOCK["hidden_size"],
                    generator=torch.Generator().manual_seed(1))
    W = {k[len("layers.1."):]: v for k, v in w.items()
         if k.startswith("layers.1.")}
    with torch.no_grad():
        got = lm.moe_forward(layer, x, 2, BLOCK["routed_scaling_factor"])
        want = ref_lm.LMReference(BLOCK, w).moe(ref_lm.LMOps(), W, x, 2)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        if hasattr(torch, "_grouped_mm"):
            ex = layer.experts
            bf = lm.Experts.__new__(lm.Experts)
            torch.nn.Module.__init__(bf)
            bf.gate_up_proj = torch.nn.Parameter(ex.gate_up_proj.bfloat16())
            bf.down_proj = torch.nn.Parameter(ex.down_proj.bfloat16())
            top, _ = lm.route(layer, x, 2, 1.0)
            xb = x.bfloat16()
            a = lm.experts_forward(bf, xb, top, grouped=True).float()
            b = lm.experts_forward(bf, xb, top, grouped=False).float()
            torch.testing.assert_close(a, b, atol=2e-2 * b.abs().max(),
                                       rtol=0)


def case_score_bias_moves_picks_not_weights():
    """e_score_correction_bias picks the experts; the weights are the
    unbiased scores of the picks over their sum, times the scale."""
    m = _model(_weights(9))
    moe = m.layers[2].mlp
    x = torch.randn(30, BLOCK["hidden_size"],
                    generator=torch.Generator().manual_seed(2))
    scale = BLOCK["routed_scaling_factor"]
    with torch.no_grad():
        moe.gate.e_score_correction_bias.zero_()
        top0, w0 = lm.route(moe, x, 2, scale)
        moe.gate.e_score_correction_bias[3] = 10.0
        top1, w1 = lm.route(moe, x, 2, scale)
        s = torch.sigmoid(x @ moe.gate.weight.t())
    assert (top1 == 3).any(-1).all() and not (top0 == 3).any(-1).all()
    for top, w in ((top0, w0), (top1, w1)):
        picked = s.gather(-1, top)
        torch.testing.assert_close(
            w, picked / picked.sum(-1, keepdim=True) * scale)


def case_evaluator_generate():
    """``Evaluator.generate`` with att_model lm over a GVD model built on
    the meta device and loaded with assign=True: seq in the LM's ids
    (int32), the served log-probabilities as the reference's."""
    from grounded_video_description_torch.data import synthetic_batch
    from grounded_video_description_torch.engine.evaluator import Evaluator
    from grounded_video_description_torch.models.gvd import GVDModel
    cfg = tiny_test_config(att_model="lm", lm=BLOCK, vocab_size=256,
                           obj_interact=True)
    with torch.device("meta"):
        model = GVDModel(cfg)
    assert not hasattr(model, "core") and not hasattr(model, "logit")
    config = {"lm": BLOCK, "model": {
        k: getattr(cfg, k) for k in (
            "vocab_size", "detect_size", "rnn_size", "input_encoding_size",
            "att_hid_size", "fc_feat_size", "rgb_feat_size",
            "motion_feat_size", "att_feat_size", "t_attn_size",
            "num_sampled_frm", "num_prop_per_frm", "loc_encoding_size",
            "seg_info_size", "seq_length", "att_model")}}
    config["model"]["obj_interact"] = True
    weights = weights_lm.program_weights(config, 11, "cpu")
    assert set(weights) == set(model.state_dict())
    model.load_state_dict(weights, assign=True)
    out = Evaluator(cfg, model.eval(), vocab=None).generate(
        synthetic_batch(cfg, 2, seed=4))
    assert out["seq"].dtype == np.int32 and out["seq"].shape == (2, 8)
    assert out["logprobs"].shape == (2, 8)
    assert (out["logprobs"] < 0).any()
    cap = model.cap_model
    with torch.no_grad():
        enc = model.encode({k: torch.as_tensor(v) for k, v in
                            synthetic_batch(cfg, 2, seed=4).items()
                            if k != "seg_id"})
        logits = ref_lm.LMReference(BLOCK, {
            k[len("cap_model."):]: v for k, v in weights.items()
            if k.startswith("cap_model.")}).logits(
            ref_lm.LMOps(), torch.cat([enc["conv_feats"],
                                       enc["pool_feats"]], 1),
            torch.as_tensor(out["seq"][:, :-1]))
    err, _ = ref_lm.position_errors(logits, torch.as_tensor(out["seq"]),
                                    torch.as_tensor(out["logprobs"]))
    assert float(err.max()) < 1e-5
    assert cap.shape.vocab == 256


def case_config_rejects():
    """att_model lm takes its block, greedy decoding only, no int8 banks
    and no model axis."""
    for kw in ({}, {"lm": BLOCK, "vocab_size": 50},
               {"lm": BLOCK, "vocab_size": 256, "beam_size": 3},
               {"lm": BLOCK, "vocab_size": 256, "quantize_banks": True},
               {"lm": BLOCK, "vocab_size": 256, "mesh_shape": [1, 2]},
               {"lm": {**BLOCK, "scoring_func": "softmax"},
                "vocab_size": 256}):
        with pytest.raises(ValueError):
            tiny_test_config(att_model="lm", **kw)
    with pytest.raises(ValueError):
        tiny_test_config(lm=BLOCK)


CASES = {f.__name__[len("case_"):]: f for f in (
    case_cache_matches_full_forward,
    case_grouped_dispatch_matches_expert_loop,
    case_score_bias_moves_picks_not_weights, case_evaluator_generate,
    case_config_rejects)}


@pytest.mark.parametrize("case", list(CASES))
def test_lm_captioner(case):
    CASES[case]()
