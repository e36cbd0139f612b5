"""Weights bridge between the JAX package's variables and the port.

``from_jax_variables`` takes the JAX ``{"params", "state"}`` tree (as
numpy arrays or anything ``np.asarray`` reads) and returns a state dict
for ``GVDModel.load_state_dict``.  The keys are the reference model's
state-dict keys, the ones ``engine/checkpoint.py::import_torch_checkpoint``
and ``import_torch_bn_state`` read, so JAX -> port -> importer -> JAX is
the identity.  Linear weights are transposed from (in, out) to (out, in);
the JAX LSTM cell's single bias goes to ``bias_ih`` with ``bias_hh = 0``.

``to_jax_variables`` is its inverse: a model's weights as the JAX tree of
numpy arrays (an LSTM's two biases summed into its one), which
``utils/params_io.py`` writes in the JAX tools' npz format.
"""

from __future__ import annotations

from typing import Dict, List

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


# --------------------------------------------------------------------- #
# the port's weights as the JAX tree
# --------------------------------------------------------------------- #

_LINEARS = (("loc_fc", "loc_fc.0"), ("fc_embed", "fc_embed.0"),
            ("seg_info_embed", "seg_info_embed.0"),
            ("pool_embed", "pool_embed.0"), ("ctx2att", "ctx2att"),
            ("ctx2pool", "ctx2pool"), ("logit", "logit"),
            ("ctx2pool_grd", "ctx2pool_grd.0"),
            ("att_embed_rgb", "att_embed.0.0"),
            ("att_embed_motion", "att_embed.1.0"))


def to_jax_variables(model) -> Dict:
    """The JAX ``{"params", "state"}`` tree of a whole model's weights
    (numpy f32; the BatchNorm count as the JAX package's f32 scalar), so
    that ``from_jax_variables`` of it is the model's state dict again, up
    to the LSTMs' zero ``bias_hh``.  A model-axis rank holds a slice of
    the vocab head: pass ``parallel.whole_model`` of it."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def a(key):
        return sd[key].float().numpy().copy()

    def lin(prefix, bias=True):
        d = {"w": a(prefix + ".weight").T.copy()}
        if bias and prefix + ".bias" in sd:
            d["b"] = a(prefix + ".bias")
        return d

    def lstm(prefix):
        return {"wi": a(prefix + ".weight_ih").T.copy(),
                "wh": a(prefix + ".weight_hh").T.copy(),
                "b": a(prefix + ".bias_ih") + a(prefix + ".bias_hh")}

    p: Dict = {ours: lin(theirs) for ours, theirs in _LINEARS}
    p["embed"] = {"w": a("embed.0.weight")}
    p["vis_embed"] = {"w": a("vis_embed.0.weight")}
    if "alpha_net.weight" in sd:
        p["alpha_net"] = lin("alpha_net")
    if "vis_classifiers_bias" in sd:
        p["vis_classifiers_bias"] = a("vis_classifiers_bias")
    p["att_embed_aux"] = {"gamma": a("att_embed_aux.0.weight"),
                          "beta": a("att_embed_aux.0.bias")}
    core = {"att_lstm": lstm("core.att_lstm"),
            "lang_lstm": lstm("core.lang_lstm")}
    for ours, theirs in (("attn", "core.attention"),
                         ("attn2", "core.attention2"),
                         ("attn2_dual", "core.attention2_dual")):
        if theirs + ".h2att.weight" in sd:
            core[ours] = {"h2att": lin(theirs + ".h2att")}
            if theirs + ".alpha_net.weight" in sd:
                core[ours]["alpha_net"] = lin(theirs + ".alpha_net")
    if "core.dual_pointer.0.weight" in sd:
        core["dual_pointer"] = lin("core.dual_pointer.0")
    p["core"] = core
    p["context_enc"] = _birnn_tree(sd, "context_enc.")
    if "obj_interact.encoder.layers.0.selfattn.layer.wq.weight" in sd:
        p["obj_interact"] = {"layers": [
            _encoder_layer_tree(lin, a, base) for base in _layers(
                sd, "obj_interact.encoder.layers.")]}
    if "cap_model.decoder.out.weight" in sd:
        p["cap_model"] = {
            "layers": [_decoder_layer_tree(lin, a, base) for base in
                       _layers(sd, "cap_model.decoder.layers.")],
            "out": lin("cap_model.decoder.out")}
    state = {"bn": {
        "mean": a("att_embed_aux.0.running_mean"),
        "var": a("att_embed_aux.0.running_var"),
        "count": np.float32(sd["att_embed_aux.0.num_batches_tracked"])}}
    return {"params": p, "state": state}


def _layers(sd: Dict, prefix: str) -> List[str]:
    n = 1 + max(int(k[len(prefix):].split(".")[0]) for k in sd
                if k.startswith(prefix))
    return [f"{prefix}{i}" for i in range(n)]


def _birnn_tree(sd: Dict, prefix: str) -> Dict:
    """``birnn_state_dict``'s inverse: GRU cells keep both biases, an
    LSTM cell's two are summed into its one."""
    n = 1 + max(int(k.split("_l")[-1].split("_")[0]) for k in sd
                if k.startswith(prefix + "weight_ih_l"))
    layers = []
    for li in range(n):
        layer = {}
        for dirn, sfx in (("fwd", ""), ("bwd", "_reverse")):
            key = f"_l{li}{sfx}"

            def a(name):
                return sd[f"{prefix}{name}{key}"].float().numpy().copy()

            cell = {"wi": a("weight_ih").T.copy(),
                    "wh": a("weight_hh").T.copy()}
            if a("weight_ih").shape[0] == 3 * a("weight_hh").shape[1]:
                cell.update(bi=a("bias_ih"), bh=a("bias_hh"))   # GRU
            else:
                cell["b"] = a("bias_ih") + a("bias_hh")          # LSTM
            layer[dirn] = cell
        layers.append(layer)
    return {"layers": layers}


def _encoder_layer_tree(lin, a, base: str) -> Dict:
    return {
        "selfattn": {n: lin(f"{base}.selfattn.layer.{n}")
                     for n in ("wq", "wk", "wv", "wo")},
        "ln1": {"gamma": a(f"{base}.selfattn.layernorm.gamma"),
                "beta": a(f"{base}.selfattn.layernorm.beta")},
        "ln2": {"gamma": a(f"{base}.feedforward.layernorm.gamma"),
                "beta": a(f"{base}.feedforward.layernorm.beta")},
        "ff": {"l1": lin(f"{base}.feedforward.layer.linear1"),
               "l2": lin(f"{base}.feedforward.layer.linear2")}}


def _decoder_layer_tree(lin, a, base: str) -> Dict:
    tree = {}
    for ours, ln, theirs in (("selfattn", "ln1", "selfattn"),
                             ("crossattn", "ln2", "attention")):
        tree[ours] = {n: lin(f"{base}.{theirs}.layer.{n}")
                      for n in ("wq", "wk", "wv", "wo")}
        tree[ln] = {"gamma": a(f"{base}.{theirs}.layernorm.gamma"),
                    "beta": a(f"{base}.{theirs}.layernorm.beta")}
    tree["ff"] = {"l1": lin(f"{base}.feedforward.layer.linear1"),
                  "l2": lin(f"{base}.feedforward.layer.linear2")}
    tree["ln3"] = {"gamma": a(f"{base}.feedforward.layernorm.gamma"),
                   "beta": a(f"{base}.feedforward.layernorm.beta")}
    return tree
