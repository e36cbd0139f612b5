"""The weights of an "lm" configuration, drawn on the device from its
seed: the GVD encoder's as ``weights.py`` draws them, and the language
model's in its stored dtype (bfloat16 at the published size), each
matrix N(0, ``INIT_STD``) drawn in f32 chunks of ``CHUNK`` values and
rounded, so that the whole model is never held in f32. Norm weights are
1, biases 0, each router's e_score_correction_bias U(-0.01, 0.01) in
f32. The program and the reference each take the same dict."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import lm as ref_lm
from benchmark.weights import draw_weights

INIT_STD = 0.02         # the family's initializer_range
SCORE_BIAS = 0.01       # e_score_correction_bias ~ U(-SCORE_BIAS, +)
CHUNK = 1 << 28
LM_SEED = 3             # the LM's stream: seed + 3 (+1 traffic, +2 dropout)
# the encoder is drawn with the reference's TopDown block at this
# vocabulary: the "lm" model has no TopDown head, so its words do not
# size the draw
ENCODER_VOCAB = 2
CAPTIONER_KEYS = ("embed.", "logit.", "core.")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def encoder_block(config: Dict) -> Dict:
    """The configuration's ``model`` block as the reference's
    ``GVDReference`` builds the encoder from."""
    return {**config["model"], "att_model": "topdown",
            "vocab_size": ENCODER_VOCAB}


def encoder_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The reference encoder's state dict (its unused TopDown head
    included) from ``seed``."""
    return draw_weights({"model": encoder_block(config)}, seed, device)


def lm_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The language model's parameters (``reference/lm.py::plan``) from
    ``seed``."""
    block = config["lm"]
    dtype = DTYPES[block.get("torch_dtype", "bfloat16")]
    g = torch.Generator(device=device).manual_seed(seed + LM_SEED)
    out = {}
    for name, shape, kind in ref_lm.plan(block, config["model"]["rnn_size"]):
        if kind == "score_bias":
            u = torch.rand(shape, generator=g, device=device)
            out[name] = (2.0 * u - 1.0) * SCORE_BIAS
            continue
        t = torch.empty(shape, dtype=dtype, device=device)
        if kind == "normal":
            flat = t.view(-1)
            for a in range(0, flat.numel(), CHUNK):
                b = min(a + CHUNK, flat.numel())
                flat[a:b] = torch.randn(b - a, generator=g,
                                        device=device) * INIT_STD
        else:
            t.fill_(1.0 if kind == "ones" else 0.0)
        out[name] = t
    return out


def program_weights(config: Dict, seed: int, device
                    ) -> Dict[str, torch.Tensor]:
    """The program's state dict: the encoder without the TopDown head,
    and the language model under ``cap_model.``."""
    enc = {k: v for k, v in encoder_weights(config, seed, device).items()
           if not k.startswith(CAPTIONER_KEYS)}
    return {**enc, **{"cap_model." + k: v
                      for k, v in lm_weights(config, seed, device).items()}}
