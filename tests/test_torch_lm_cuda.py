"""The language-model captioner (``models/lm.py``) on a CUDA card only, at
the published widths of Kimi-VL-A3B's language model, in bf16, against
the benchmark's plain reference (``benchmark/reference/lm.py``) in f32
on the same weights: one MoE layer (the grouped dispatch through
``torch._grouped_mm``), one MLA layer (the prefill, then decode steps
through the latent cache), and the ``kimivl-greedy`` cell's judge on a
batch of 4 segments. The machine with the card has no JAX, so this file
imports none; run it there without the repository's conftest:
    python -m pytest --noconftest -m cuda tests/test_torch_lm_cuda.py -q
Without a card every test skips.

Tolerances, as a share of the reference's largest magnitude: bf16 keeps
8 significant bits (a rounding of 2^-9 = 0.2% relative); the MoE rounds
its input, the SwiGLU's intermediate and each expert's output, the MLA
its input, the projections, the latent, the scores and the context, each
time at 0.2%, and the sums run in f32; 2% (MoE) and 3% (MLA) leave room
for those roundings, where a dropped expert (one pick of 6 carries ~17%
of the routed sum) or a wrong RoPE position would not pass.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import weights_lm  # noqa: E402
from benchmark.reference import lm as ref_lm  # noqa: E402
from grounded_video_description_torch.models import lm  # noqa: E402

CONFIG = json.loads((ROOT / "benchmark" / "configs" /
                     "gvd-kimivl-a3b-anet.json").read_text())
# the published widths at three layers (the dense one and two MoE)
BLOCK = {**CONFIG["lm"], "num_hidden_layers": 3}
MOE_TOL, MLA_TOL = 2e-2, 3e-2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = {"lm": BLOCK, "model": CONFIG["model"]}
    w = weights_lm.lm_weights(cfg, 2419, "cuda")
    with torch.device("meta"):
        m = lm.LanguageModel(BLOCK, CONFIG["model"]["rnn_size"])
    m.load_state_dict(w, assign=True)
    return m, w


def _layer(w, i):
    p = f"layers.{i}."
    return {k[len(p):]: v.float() for k, v in w.items() if k.startswith(p)}


@pytest.mark.cuda
def test_moe_layer_bf16_against_f32_reference(card):
    m, w = card
    assert lm.grouped_gemm_available(torch.empty(1, dtype=torch.bfloat16,
                                                 device="cuda"))
    x = torch.randn(512, BLOCK["hidden_size"], device="cuda").bfloat16()
    with torch.no_grad():
        got = lm.moe_forward(m.layers[1].mlp, x, BLOCK["num_experts_per_tok"],
                             BLOCK["routed_scaling_factor"]).float()
        want = ref_lm.LMReference(BLOCK, w).moe(
            ref_lm.LMOps(), _layer(w, 1), x.float(),
            BLOCK["num_experts_per_tok"])
    err = (got - want).abs().max() / want.abs().max()
    assert err < MOE_TOL, float(err)


@pytest.mark.cuda
def test_mla_layer_prefill_and_decode_bf16_against_f32_reference(card):
    m, w = card
    B, S, steps = 2, 300, 3
    x = torch.randn(B, S + steps, BLOCK["hidden_size"], device="cuda")
    attn = m.layers[1].self_attn
    s = m.shape
    with torch.no_grad():
        cache = torch.empty(B, S + steps, s.latent, dtype=torch.bfloat16,
                            device="cuda")
        xb = x.bfloat16()
        outs = [lm.mla_prefill(attn, xb[:, :S], cache, s)]
        for t in range(steps):
            outs.append(lm.mla_decode(attn, xb[:, S + t], cache, S + t,
                                      s)[:, None])
        got = torch.cat(outs, 1).float()
        want = ref_lm.LMReference(BLOCK, w).attention(
            ref_lm.LMOps(), _layer(w, 1), xb.float())
    err = (got - want).abs().max() / want.abs().max()
    assert err < MLA_TOL, float(err)


@pytest.mark.cuda
def test_kimivl_judge_on_a_small_batch():
    """The cell's program and judge at the published widths on 4
    segments: every number under its limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import harness
    cell = harness.load_cell("kimivl-greedy", 2419, 1.0, False)
    cell.traffic.update(batch_size=4, distinct_batches=1,
                        judged_segments=2)
    driver = harness.load_module(harness.BENCH_DIR / "drivers" /
                                 "serve_closed_lm.py")
    batches = driver.inputs(cell)
    ev = driver.program(cell, weights_lm.program_weights(
        cell.config, cell.seed, "cuda"))
    served = [(0, ev.generate(batches[0]))]
    del ev
    driver.free(cell)
    numbers = driver.judged(cell, served, batches)[driver.QUANTILE]
    limits = cell.checks["numbers"]
    assert set(numbers) == set(limits)
    for k, v in numbers.items():
        assert v <= limits[k]["limit"], (k, v)
