"""Post-LN transformer encoder for the obj_interact region bank (the
encoder half of ``grounded_video_description_tpu/models/transformer.py``).

Behavioural contract from misc/transformer.py:
  * post-LN residual blocks whose LayerNorm divides by (unbiased std +
    eps) (transformer.py:66-77);
  * multi-head attention with *chunked* head splitting (1024 dims over 6
    heads -> 171 x 5 + 169, transformer.py:118-123) and one shared
    sqrt(d_model) score scale (transformer.py:94);
  * the encoder returns the per-layer encoding list.

Module names follow the reference state dict
(``obj_interact.encoder.layers.{i}.selfattn.layer.wq`` and so on).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from grounded_video_description_torch.nn import init_linear_
from grounded_video_description_torch.ops.kernels.encoder_layer import (
    EncoderLayerWeights, fused_encoder_layer, fused_encoder_layer_plain,
)


class LayerNormParams(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))


class MultiHeadParams(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Linear(d_model, d_model, bias=False))


class FeedForwardParams(nn.Module):
    def __init__(self, d_model: int, d_hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_hidden)
        self.linear2 = nn.Linear(d_hidden, d_model)


class ResidualBlock(nn.Module):
    def __init__(self, layer: nn.Module, d_model: int):
        super().__init__()
        self.layer = layer
        self.layernorm = LayerNormParams(d_model)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_hidden: int):
        super().__init__()
        self.selfattn = ResidualBlock(MultiHeadParams(d_model), d_model)
        self.feedforward = ResidualBlock(
            FeedForwardParams(d_model, d_hidden), d_model)

    def weights(self) -> EncoderLayerWeights:
        a, f = self.selfattn, self.feedforward
        return EncoderLayerWeights(
            a.layer.wq.weight, a.layer.wk.weight, a.layer.wv.weight,
            a.layer.wo.weight,
            f.layer.linear1.weight, f.layer.linear1.bias,
            f.layer.linear2.weight, f.layer.linear2.bias,
            a.layernorm.gamma, a.layernorm.beta,
            f.layernorm.gamma, f.layernorm.beta)


class Encoder(nn.Module):
    def __init__(self, d_model: int, d_hidden: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, d_hidden) for _ in range(n_layers))

    def reset_parameters(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)
            elif isinstance(m, LayerNormParams):
                with torch.no_grad():
                    m.gamma.fill_(1.0)
                    m.beta.zero_()


class ObjInteract(nn.Module):
    """The region self-attention encoder (model.py:126-135): 2 layers,
    6 heads, FFN width d_model / 2."""

    def __init__(self, d_model: int, d_hidden: int, n_layers: int):
        super().__init__()
        self.encoder = Encoder(d_model, d_hidden, n_layers)


def encoder_apply(enc: Encoder, x: torch.Tensor, *, n_heads: int,
                  use_kernel: bool = False) -> List[torch.Tensor]:
    """Per-layer encodings at inference (transformer.py:177-190), one
    ``fused_encoder_layer`` per layer as gvd.py:247-255 dispatches in the
    JAX package.  Without ``use_kernel`` each layer is the kernel's plain
    twin, ``fused_encoder_layer_plain`` (the head-sequential schedule of
    transformer.py:211-234, scores and softmax in f32)."""
    layer = fused_encoder_layer if use_kernel else fused_encoder_layer_plain
    encodings = []
    for lp in enc.layers:
        x = layer(x, lp.weights(), n_heads=n_heads)
        encodings.append(x)
    return encodings
