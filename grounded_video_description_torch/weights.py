"""Weights bridge from the JAX package's variables to the port.

``from_jax_variables`` takes the JAX ``{"params", "state"}`` tree (as
numpy arrays or anything ``np.asarray`` reads) and returns a state dict
for ``GVDModel.load_state_dict``.  The keys are the reference model's
state-dict keys, the ones ``engine/checkpoint.py::import_torch_checkpoint``
and ``import_torch_bn_state`` read, so JAX -> port -> importer -> JAX is
the identity.  Linear weights are transposed from (in, out) to (out, in);
the JAX LSTM cell's single bias goes to ``bias_ih`` with ``bias_hh = 0``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def from_jax_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    p, state = variables["params"], variables["state"]
    sd: Dict[str, torch.Tensor] = {}

    def lin(prefix: str, d: Dict):
        sd.update(_linear_state_dict(d, prefix))

    def lstm(prefix: str, d: Dict):
        sd[prefix + ".weight_ih"] = _t(np.asarray(d["wi"]).T)
        sd[prefix + ".weight_hh"] = _t(np.asarray(d["wh"]).T)
        sd[prefix + ".bias_ih"] = _t(d["b"])
        sd[prefix + ".bias_hh"] = torch.zeros(np.asarray(d["b"]).shape)

    for ours, theirs in (("loc_fc", "loc_fc.0"), ("fc_embed", "fc_embed.0"),
                         ("seg_info_embed", "seg_info_embed.0"),
                         ("pool_embed", "pool_embed.0"),
                         ("ctx2att", "ctx2att"), ("ctx2pool", "ctx2pool"),
                         ("logit", "logit"),
                         ("ctx2pool_grd", "ctx2pool_grd.0"),
                         ("att_embed_rgb", "att_embed.0.0"),
                         ("att_embed_motion", "att_embed.1.0")):
        lin(theirs, p[ours])
    sd["embed.0.weight"] = _t(p["embed"]["w"])
    sd["vis_embed.0.weight"] = _t(p["vis_embed"]["w"])
    if "alpha_net" in p:
        lin("alpha_net", p["alpha_net"])
    if "vis_classifiers_bias" in p:
        sd["vis_classifiers_bias"] = _t(p["vis_classifiers_bias"])

    bn, bn_state = p["att_embed_aux"], state["bn"]
    sd["att_embed_aux.0.weight"] = _t(bn["gamma"])
    sd["att_embed_aux.0.bias"] = _t(bn["beta"])
    sd["att_embed_aux.0.running_mean"] = _t(bn_state["mean"])
    sd["att_embed_aux.0.running_var"] = _t(bn_state["var"])
    sd["att_embed_aux.0.num_batches_tracked"] = torch.tensor(
        int(np.asarray(bn_state["count"])), dtype=torch.long)

    core = p["core"]
    lstm("core.att_lstm", core["att_lstm"])
    lstm("core.lang_lstm", core["lang_lstm"])
    for ours, theirs in (("attn", "core.attention"),
                         ("attn2", "core.attention2"),
                         ("attn2_dual", "core.attention2_dual")):
        if ours in core:
            lin(theirs + ".h2att", core[ours]["h2att"])
            if "alpha_net" in core[ours]:
                lin(theirs + ".alpha_net", core[ours]["alpha_net"])
    if "dual_pointer" in core:
        lin("core.dual_pointer.0", core["dual_pointer"])

    sd.update(birnn_state_dict(p["context_enc"], "context_enc."))
    if "obj_interact" in p:
        sd.update(encoder_state_dict(p["obj_interact"],
                                     "obj_interact.encoder."))
    if "cap_model" in p:
        sd.update(decoder_state_dict(p["cap_model"], "cap_model.decoder."))
    return sd


def birnn_state_dict(p: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX ``birnn_init`` tree as ``BiRNNParams`` keys (torch's
    per-layer, per-direction names)."""
    sd: Dict[str, torch.Tensor] = {}
    for li, layer in enumerate(p["layers"]):
        for dirn, sfx in (("fwd", ""), ("bwd", "_reverse")):
            cell = layer[dirn]
            key = f"_l{li}{sfx}"
            sd[f"{prefix}weight_ih{key}"] = _t(np.asarray(cell["wi"]).T)
            sd[f"{prefix}weight_hh{key}"] = _t(np.asarray(cell["wh"]).T)
            if "bi" in cell:                        # GRU keeps both biases
                sd[f"{prefix}bias_ih{key}"] = _t(cell["bi"])
                sd[f"{prefix}bias_hh{key}"] = _t(cell["bh"])
            else:                                   # LSTM: one bias
                sd[f"{prefix}bias_ih{key}"] = _t(cell["b"])
                sd[f"{prefix}bias_hh{key}"] = torch.zeros(
                    np.asarray(cell["b"]).shape)
    return sd


def encoder_state_dict(p: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX ``transformer.encoder_init`` tree as ``transformer.Encoder``
    keys."""
    sd: Dict[str, torch.Tensor] = {}
    for i, lp in enumerate(p["layers"]):
        base = f"{prefix}layers.{i}"
        for name in ("wq", "wk", "wv", "wo"):
            sd[f"{base}.selfattn.layer.{name}.weight"] = _t(
                np.asarray(lp["selfattn"][name]["w"]).T)
        for ln_key, ln_name in (("ln1", "selfattn.layernorm"),
                                ("ln2", "feedforward.layernorm")):
            sd[f"{base}.{ln_name}.gamma"] = _t(lp[ln_key]["gamma"])
            sd[f"{base}.{ln_name}.beta"] = _t(lp[ln_key]["beta"])
        for j, name in ((1, "l1"), (2, "l2")):
            sd[f"{base}.feedforward.layer.linear{j}.weight"] = _t(
                np.asarray(lp["ff"][name]["w"]).T)
            sd[f"{base}.feedforward.layer.linear{j}.bias"] = _t(
                lp["ff"][name]["b"])
    return sd


def _linear_state_dict(d: Dict, prefix: str) -> Dict[str, torch.Tensor]:
    sd = {prefix + ".weight": _t(np.asarray(d["w"]).T)}
    if "b" in d:
        sd[prefix + ".bias"] = _t(d["b"])
    return sd


def decoder_state_dict(p: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX ``transformer.decoder_init`` tree as ``transformer.Decoder``
    keys: selfattn / crossattn / ff with ln1 / ln2 / ln3 become the
    reference's selfattn / attention / feedforward blocks with their
    layernorms (checkpoint.py's importer reads them back)."""
    sd = _linear_state_dict(p["out"], prefix + "out")
    for i, lp in enumerate(p["layers"]):
        base = f"{prefix}layers.{i}"
        for ours, ln, theirs in (("selfattn", "ln1", "selfattn"),
                                 ("crossattn", "ln2", "attention")):
            for name in ("wq", "wk", "wv", "wo"):
                sd.update(_linear_state_dict(
                    lp[ours][name], f"{base}.{theirs}.layer.{name}"))
            sd[f"{base}.{theirs}.layernorm.gamma"] = _t(lp[ln]["gamma"])
            sd[f"{base}.{theirs}.layernorm.beta"] = _t(lp[ln]["beta"])
        for j, name in ((1, "l1"), (2, "l2")):
            sd.update(_linear_state_dict(
                lp["ff"][name], f"{base}.feedforward.layer.linear{j}"))
        sd[f"{base}.feedforward.layernorm.gamma"] = _t(lp["ln3"]["gamma"])
        sd[f"{base}.feedforward.layernorm.beta"] = _t(lp["ln3"]["beta"])
    return sd
