"""The model axis of the mesh: the vocab head and the visual-word table
split over the M ranks of a model group.

The counterpart of the tensor-parallel rules of
``grounded_video_description_tpu/parallel/mesh.py`` (``_TP_RULES``), where
XLA places ``logit.w`` as P(None, "model"), ``logit.b`` as P("model") and
``vis_embed.w`` as P("model", None) and inserts the collectives itself.
Here the collectives are explicit, and everything else stays replicated:

* ``logit`` is column-parallel: rank m holds rows [m Vp / M, (m + 1) Vp /
  M) of the (Vp, rnn) weight and of its bias.  Its forward is the rank's
  logits, gathered over the model group to (..., Vp) by a differentiable
  all-gather whose backward keeps the rank's own columns; its input goes
  through ``copy_to_model`` (the identity forward, an all-reduce of the
  gradient over the model group backward), so every rank's input gradient
  is the whole head's.  The driver pads the vocab to a multiple of M
  (``vocab_pad_to``, main.py:145-147 of the JAX package); a head that does
  not divide is replicated with a warning, as the JAX rule is.
* ``vis_embed`` is split by rows where detect_size + 1 divides by M, and
  gathered whole by the same all-gather at each of its two uses;
  otherwise it is replicated without a word (the JAX ``_TP_OPTIONAL``).

Every rank past the gathers computes the same values, so the replicated
parameters' gradients are equal across the model group and the sharded
slices' are the whole head's.  ``whole_model`` gathers the split weights
for what needs the whole head (evaluation, K6, checkpoints).
"""

from __future__ import annotations

import copy
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch import nn

# the parameters the model axis splits, each along its dim 0 (torch's
# layout: the logit weight is (Vp, rnn), the table (detect_size + 1, E))
RULES = ("logit.weight", "logit.bias", "vis_embed.0.weight")
# split where they divide, else replicated silently (JAX _TP_OPTIONAL)
OPTIONAL = ("vis_embed.0.weight",)


@dataclass(frozen=True)
class ModelShard:
    """A model's place on the model axis: rank ``index`` of ``size`` in
    ``group``, and the names of the parameters split along dim 0."""
    group: Any
    index: int
    size: int
    names: Tuple[str, ...]

    def rows(self, n: int) -> slice:
        """This rank's rows of a dim of ``n``."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


def shard_of(model: nn.Module):
    """The model's ``ModelShard``, or None for a whole model."""
    return getattr(model, "tp", None)


# --------------------------------------------------------------------- #
# collectives with their gradients
# --------------------------------------------------------------------- #

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherModel(torch.autograd.Function):
    """The ranks' x concatenated along ``dim`` in rank order; the
    gradient of a rank's x is its own part of the output's gradient."""

    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(shard.size)]
        dist.all_gather(parts, x, group=shard.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.shard.size
        return g.narrow(ctx.dim, ctx.shard.index * n, n), None, None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return _CopyToModel.apply(x, shard.group)


def gather_model(x: torch.Tensor, dim: int,
                 shard: ModelShard) -> torch.Tensor:
    return _GatherModel.apply(x, dim, shard)


def _gathered(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """A slice's whole tensor along dim 0, without a gradient."""
    with torch.no_grad():
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(shard.size)]
        dist.all_gather(parts, t, group=shard.group)
        return torch.cat(parts)


# --------------------------------------------------------------------- #
# the model's split weights
# --------------------------------------------------------------------- #

def shard_model(model: nn.Module, mesh) -> None:
    """Split ``RULES``' parameters of a whole model over the mesh's model
    group in place (a no-op for M = 1), before an optimizer takes them."""
    if mesh is None or mesh.model == 1:
        return
    M = mesh.model
    params = dict(model.named_parameters())
    names = []
    for name in RULES:
        if name not in params:
            continue
        if params[name].shape[0] % M:
            if name not in OPTIONAL:
                warnings.warn(
                    f"{name} {tuple(params[name].shape)} does not split "
                    f"over a model axis of {M} -> replicated (set "
                    "vocab_pad_to to the model-axis size)", stacklevel=2)
            continue
        names.append(name)
    shard = ModelShard(mesh.model_group, mesh.model_rank, M, tuple(names))
    for name in names:
        owner, leaf = _owner(model, name)
        p = getattr(owner, leaf)
        setattr(owner, leaf, nn.Parameter(
            p.detach()[shard.rows(p.shape[0])].clone(),
            requires_grad=p.requires_grad))
    model.tp = shard


def _owner(model: nn.Module, name: str):
    path, leaf = name.rsplit(".", 1)
    return model.get_submodule(path), leaf


def head_logits(model: nn.Module, x: torch.Tensor, linear) -> torch.Tensor:
    """``logit`` of x, (..., Vp): on a model-axis rank its columns,
    gathered whole."""
    shard = shard_of(model)
    if shard is None or "logit.weight" not in shard.names:
        return linear(model.logit, x)
    return gather_model(linear(model.logit, copy_to_model(x, shard)), -1,
                        shard)


def vis_embed_weight(model: nn.Module) -> torch.Tensor:
    """The whole visual-word table (gathered on a model-axis rank that
    holds its rows)."""
    w = model.vis_embed[0].weight
    shard = shard_of(model)
    if shard is None or "vis_embed.0.weight" not in shard.names:
        return w
    return gather_model(w, 0, shard)


def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with the split parameters gathered whole (a
    collective over the model group: every rank of it calls)."""
    sd = model.state_dict()
    shard = shard_of(model)
    if shard is not None:
        for name in shard.names:
            sd[name] = _gathered(sd[name], shard)
    return sd


def local_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to this rank's slices of the split
    parameters."""
    shard = shard_of(model)
    if shard is None:
        return sd
    sd = dict(sd)
    for name in shard.names:
        sd[name] = sd[name][shard.rows(sd[name].shape[0])]
    return sd


def whole_model(model: nn.Module) -> nn.Module:
    """``model`` itself if it is whole, else a shallow copy that shares
    its replicated parameters and buffers and holds the split ones
    gathered (without gradients): what evaluation decodes with, on every
    rank.  A collective over the model group."""
    shard = shard_of(model)
    if shard is None:
        return model
    whole = {n: _gathered(dict(model.named_parameters())[n], shard)
             for n in shard.names}
    view = copy.copy(model)
    view._modules = dict(model._modules)
    view.tp = None
    for top in {n.split(".")[0] for n in whole}:
        view._modules[top] = _copied(model._modules[top])
    for name, w in whole.items():
        owner, leaf = _owner(view, name)
        owner._parameters[leaf] = nn.Parameter(w, requires_grad=False)
    return view


def _copied(module: nn.Module) -> nn.Module:
    """A copy of ``module`` and its submodules that shares their tensors
    until one is set anew."""
    m = copy.copy(module)
    m._parameters = dict(module._parameters)
    m._modules = {k: _copied(v) for k, v in module._modules.items()}
    return m


# --------------------------------------------------------------------- #
# the optimizer's moments of the split parameters
# --------------------------------------------------------------------- #

def _split_indices(trainer) -> Dict[int, torch.Tensor]:
    """{index in the optimizer's state: parameter} of the split
    parameters."""
    shard = shard_of(trainer.model)
    if shard is None:
        return {}
    split = {id(dict(trainer.model.named_parameters())[n])
             for n in shard.names}
    return {i: p for i, p in enumerate(trainer.params) if id(p) in split}


def whole_optimizer_state(trainer) -> Dict:
    """The optimizer's state dict with the split parameters' moments
    gathered whole (a collective over the model group)."""
    sd = trainer.optimizer.state_dict()
    split = _split_indices(trainer)
    if not split:
        return sd
    shard = shard_of(trainer.model)
    state = {}
    for i, st in sd["state"].items():
        p = split.get(i)
        state[i] = {k: (_gathered(v, shard) if p is not None
                        and torch.is_tensor(v) and v.shape == p.shape else v)
                    for k, v in st.items()}
    return {**sd, "state": state}


def local_optimizer_state(trainer, sd: Dict) -> Dict:
    """A whole optimizer state dict cut to this rank's slices."""
    split = _split_indices(trainer)
    if not split:
        return sd
    shard = shard_of(trainer.model)
    state = {}
    for i, st in sd["state"].items():
        p = split.get(int(i))
        state[i] = {k: (v[shard.rows(v.shape[0])] if p is not None
                        and torch.is_tensor(v) and v.dim() > 0
                        and v.shape[0] == p.shape[0] * shard.size else v)
                    for k, v in st.items()}
    return {**sd, "state": state}


def split_params(trainer) -> List[torch.Tensor]:
    """The trainer's parameters that the model axis splits."""
    return list(_split_indices(trainer).values())
