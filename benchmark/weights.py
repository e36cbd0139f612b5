"""The weights of a cell, drawn on the device from its seed in a few
large calls: one uniform draw for every U(+-bound) tensor and one normal
draw for the embeddings, sliced and scaled per tensor, under the names
of the reference state dict. The program and the reference each load
the same dict."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.gvd import GVDReference, parameter_plan


def draw_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``config``'s model from ``seed``. A
    configuration's ``scaled_weights`` ({"prefix", "suffixes", "factor"})
    multiplies the tensors it names, after the draw."""
    with torch.device("meta"):
        plan = parameter_plan(GVDReference(config["model"]))
    g = torch.Generator(device=device).manual_seed(seed)

    def count(kinds):
        return sum(torch.Size(shape).numel()
                   for _, shape, _, kind, _ in plan if kind in kinds)

    uniform = torch.rand(count(("fan_in", "hidden")), generator=g,
                         device=device)
    normal = torch.randn(count(("normal",)), generator=g, device=device)
    used = {"u": 0, "n": 0}
    out = {}
    for name, shape, dtype, kind, bound in plan:
        n = torch.Size(shape).numel()
        if kind in ("fan_in", "hidden"):
            u = uniform[used["u"]:used["u"] + n]
            used["u"] += n
            t = (2.0 * u - 1.0) * bound
        elif kind == "normal":
            t = normal[used["n"]:used["n"] + n]
            used["n"] += n
        else:
            t = torch.full((n,), 1 if kind == "ones" else 0, dtype=dtype,
                           device=device)
        out[name] = t.view(shape).to(dtype)
    scaled = config.get("scaled_weights")
    if scaled:
        for name in out:
            if name.startswith(scaled["prefix"]) and name.endswith(
                    tuple(scaled["suffixes"])):
                out[name] = out[name] * scaled["factor"]
    return out
