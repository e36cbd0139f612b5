"""Post-LN transformer: the obj_interact region encoder and the
Masked-Transformer caption decoder (the port of
``grounded_video_description_tpu/models/transformer.py``).

Behavioural contract from misc/transformer.py:
  * post-LN residual blocks whose LayerNorm divides by (unbiased std +
    eps) (transformer.py:66-77);
  * multi-head attention with *chunked* head splitting (1024 dims over 6
    heads -> 171 x 5 + 169, transformer.py:118-123) and one shared
    sqrt(d_model) score scale (transformer.py:94);
  * causal masking by subtracting an upper-triangular INF = 1e10 before
    the division by the scale (transformer.py:100-104);
  * the encoder returns the per-layer encoding list; decoder layer i
    cross-attends encoding i (transformer.py:177-190, 206-212);
  * the decoder's token embedding is its output projection's weight
    scaled by sqrt(d_model) (tied, transformer.py:207).

Module names follow the reference state dict
(``obj_interact.encoder.layers.{i}.selfattn.layer.wq``,
``cap_model.decoder.layers.{i}.attention.layer.wk``, and so on).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from grounded_video_description_torch.nn import (
    dropout, init_linear_, layer_norm_affine)
from grounded_video_description_torch.ops.kernels.attention_train import (
    draw_seed, mha_probs_dropout, mha_probs_dropout_hybrid)
from grounded_video_description_torch.ops.kernels.encoder_layer import (
    LN_EPS, EncoderLayerWeights, fused_encoder_layer,
    fused_encoder_layer_plain, head_slices, layer_tail,
)
from grounded_video_description_torch.ops.kernels.encoder_layer_train import (
    fused_encoder_layer_train)
from grounded_video_description_torch.ops.kernels.mha import (
    flash_self_attention)
from grounded_video_description_torch.parallel.mesh import row0_of

# the K4 and K7 dispatch of the JAX package (models/transformer.py:157-159,
# 179-180): self-attention over more than this many keys
KERNEL_MIN_KEYS = 256
# the causal mask's and the greedy decode's masking constant
# (transformer.py:100-104), not -inf, as in the JAX package
INF = 1e10


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


def _self_attention_train(w: EncoderLayerWeights, x: torch.Tensor, *,
                          n_heads: int, drop: float,
                          generator: Optional[torch.Generator],
                          attn_train_impl: str) -> torch.Tensor:
    """Multi-head self-attention in training (JAX ``transformer._mha``):
    one shared scale sqrt(D), torch.chunk heads, dropout on the probs.

    Over more than ``KERNEL_MIN_KEYS`` keys, "pallas" runs K4's kernels
    forward and backward, and "hybrid" K4's plain forward with its
    backward kernels; both draw one seed per call from ``generator``.
    Otherwise ("xla", or few keys) the heads run one after another in
    plain PyTorch, scores and softmax in f32, with prob dropout drawn
    from ``generator``."""
    dt = x.dtype
    D, R = x.shape[-1], x.shape[1]
    scale = math.sqrt(D)
    q = F.linear(x, w.wq.to(dt))
    k = F.linear(x, w.wk.to(dt))
    v = F.linear(x, w.wv.to(dt))
    if attn_train_impl != "xla" and R > KERNEL_MIN_KEYS:
        prim = {"pallas": mha_probs_dropout,
                "hybrid": mha_probs_dropout_hybrid}[attn_train_impl]
        if generator is not None and drop > 0.0:
            seed, rate = draw_seed(generator), drop
        else:
            seed, rate = torch.zeros(1, dtype=torch.int64,
                                     device=x.device), 0.0
        o = prim(q, k, v, seed, n_heads=n_heads, scale=scale, drop=rate,
                 row0=row0_of(generator, x))
    else:
        heads = []
        for sl in head_slices(D, n_heads):
            s = (q[..., sl].float() @ k[..., sl].float().transpose(1, 2)) \
                * (1.0 / scale)
            p = dropout(torch.softmax(s, dim=-1), drop, train=True,
                        generator=generator)
            heads.append((p @ v[..., sl].float()).to(dt))
        o = torch.cat(heads, dim=-1)
    return F.linear(o, w.wo.to(dt))


def _encoder_layer_train(w: EncoderLayerWeights, x: torch.Tensor, *,
                         n_heads: int, drop: float,
                         generator: Optional[torch.Generator],
                         attn_train_impl: str) -> torch.Tensor:
    """One post-LN layer in training, with dropout at the JAX package's
    three sites: the probs, the attention residual and the FFN residual
    (transformer.py:237-268).  LayerNorm statistics in f32, as in K1."""
    dt, f32 = x.dtype, torch.float32
    a = _self_attention_train(w, x, n_heads=n_heads, drop=drop,
                              generator=generator,
                              attn_train_impl=attn_train_impl)
    a = dropout(a, drop, train=True, generator=generator)
    x1 = layer_norm_affine(w.g1, w.be1, x.to(f32) + a.to(f32), LN_EPS,
                           use_std=True).to(dt)
    f = F.linear(F.relu(F.linear(x1, w.w1.to(dt), w.b1.to(dt))),
                 w.w2.to(dt), w.b2.to(dt))
    f = dropout(f, drop, train=True, generator=generator)
    return layer_norm_affine(w.g2, w.be2, x1.to(f32) + f.to(f32), LN_EPS,
                             use_std=True).to(dt)


def _encoder_layer_flash(w: EncoderLayerWeights, x: torch.Tensor, *,
                         n_heads: int) -> torch.Tensor:
    """One layer at inference with its self-attention through K7, as the
    JAX package's ``_mha`` runs ``flash_self_attention``
    (transformer.py:179-193): the heads zero-padded to one width
    (1024 -> 6 x 171, ``_split_heads``) as (B * heads, R, width), q
    divided by sqrt(D), merged and sliced back to D before ``wo``.  A
    head's zero pad changes no product.  The rest of the layer is
    ``fused_encoder_layer_plain``'s."""
    dt = x.dtype
    B, R, D = x.shape
    width = -(-D // n_heads)

    def heads_first(t):
        t = F.pad(t, (0, width * n_heads - D))
        return t.reshape(B, R, n_heads, width).transpose(1, 2).reshape(
            B * n_heads, R, width)

    q, k, v = (heads_first(F.linear(x, m.to(dt)))
               for m in (w.wq, w.wk, w.wv))
    o = flash_self_attention(q / math.sqrt(D), k, v)
    o = o.reshape(B, n_heads, R, width).transpose(1, 2).reshape(
        B, R, n_heads * width)[..., :D]
    return layer_tail(x, F.linear(o, w.wo.to(dt)), w)


def encoder_apply_fused_train(enc: Encoder, x: torch.Tensor, *,
                              n_heads: int, drop: float,
                              generator: Optional[torch.Generator]
                              ) -> List[torch.Tensor]:
    """Training through K5, one ``fused_encoder_layer_train`` per layer
    (JAX ``encoder_layer_train.py::encoder_apply_fused_train``; no mask
    path): one dropout seed per layer drawn from ``generator``; with
    ``drop`` 0 or no generator the rate is 0 and the seeds are zero."""
    if generator is None or drop <= 0.0:
        drop = 0.0
        seeds = [torch.zeros(1, dtype=torch.int64, device=x.device)
                 for _ in enc.layers]
    else:
        seeds = [draw_seed(generator) for _ in enc.layers]
    encodings = []
    for lp, seed in zip(enc.layers, seeds):
        x = fused_encoder_layer_train(x, lp.weights(), seed, n_heads=n_heads,
                                      drop=drop, row0=row0_of(generator, x))
        encodings.append(x)
    return encodings


def encoder_apply(enc: Encoder, x: torch.Tensor, *, n_heads: int,
                  use_kernel: bool = False, use_mha: bool = False,
                  train: bool = False, drop: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  attn_train_impl: str = "xla",
                  fused_train: bool = False) -> List[torch.Tensor]:
    """Per-layer encodings (transformer.py:177-190).

    At inference: one ``fused_encoder_layer`` (K1) per layer with
    ``use_kernel``, as gvd.py:247-255 dispatches in the JAX package;
    otherwise, with ``use_mha`` and more than ``KERNEL_MIN_KEYS`` regions,
    the layer with its self-attention through ``flash_self_attention``
    (K7, gvd.py:266-270); else K1's plain twin
    ``fused_encoder_layer_plain`` (the head-sequential schedule of
    transformer.py:211-234, scores and softmax in f32).

    In training (``train``): with ``fused_train`` the whole layer through
    K5 (``encoder_apply_fused_train``), as gvd.py:256-265 dispatches it
    before the attention schedule is looked at; otherwise the
    differentiable layer, with dropout at ``drop`` from ``generator`` and
    the attention schedule ``attn_train_impl`` ("xla", "pallas" or
    "hybrid"; see ``_self_attention_train``)."""
    if train and fused_train:
        return encoder_apply_fused_train(enc, x, n_heads=n_heads, drop=drop,
                                         generator=generator)
    encodings = []
    for lp in enc.layers:
        if train:
            x = _encoder_layer_train(lp.weights(), x, n_heads=n_heads,
                                     drop=drop, generator=generator,
                                     attn_train_impl=attn_train_impl)
        elif use_kernel:
            x = fused_encoder_layer(x, lp.weights(), n_heads=n_heads)
        elif use_mha and x.shape[1] > KERNEL_MIN_KEYS:
            x = _encoder_layer_flash(lp.weights(), x, n_heads=n_heads)
        else:
            x = fused_encoder_layer_plain(x, lp.weights(), n_heads=n_heads)
        encodings.append(x)
    return encodings


# --------------------------------------------------------------------- #
# the Masked-Transformer caption decoder (att_model "transformer")
# --------------------------------------------------------------------- #

def positional_encodings(T: int, D: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(T, D): even channel c sin(pos / 10000^(c / D)), odd channel c
    cos(pos / 10000^((c - 1) / D)), computed in float64, then cast."""
    pos = np.arange(T, dtype=np.float64)[:, None]
    chan = np.arange(D, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, np.where(chan % 2 == 0, chan,
                                             chan - 1) / D)
    enc = np.where(chan % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(enc).to(dtype=dtype, device=device)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, d_hidden: int):
        super().__init__()
        self.selfattn = ResidualBlock(MultiHeadParams(d_model), d_model)
        self.attention = ResidualBlock(MultiHeadParams(d_model), d_model)
        self.feedforward = ResidualBlock(
            FeedForwardParams(d_model, d_hidden), d_model)


class Decoder(nn.Module):
    """Layers of causal self-attention, cross-attention and a ReLU FFN,
    and ``out`` (d_model -> vocab, with bias), whose weight is also the
    token embedding."""

    def __init__(self, d_model: int, d_hidden: int, vocab: int,
                 n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, d_hidden) for _ in range(n_layers))
        self.out = nn.Linear(d_model, vocab)


class CaptionModel(nn.Module):
    """The captioner of att_model "transformer" (model.py:411-419): 2
    decoder layers, 6 heads, FFN width d_model / 2."""

    def __init__(self, d_model: int, d_hidden: int, vocab: int,
                 n_layers: int):
        super().__init__()
        self.decoder = Decoder(d_model, d_hidden, vocab, n_layers)


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, D) -> (B, heads, T, ceil(D / heads)), the feature tail zero-
    padded: a padded column adds zero to every score and its output
    column is sliced away, so this is the reference's uneven chunks."""
    B, T, D = t.shape
    width = -(-D // n_heads)
    t = F.pad(t, (0, width * n_heads - D))
    return t.reshape(B, T, n_heads, width).transpose(1, 2)


def _merge(o: torch.Tensor, D: int) -> torch.Tensor:
    B, h, T, width = o.shape
    return o.transpose(1, 2).reshape(B, T, h * width)[..., :D]


def _attend(p: MultiHeadParams, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, *, causal: bool, drop: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Heads q (B, h, Tq, w), k and v (B, h, Tk, w) -> the output
    projection of their attention (B, Tq, D).  Scores in the operands'
    dtype (as the JAX einsum), softmax in f32 at the shared scale
    sqrt(D); dropout on the probs."""
    D = p.wo.weight.shape[0]
    s = (q @ k.transpose(-1, -2)).float()
    if causal:
        Tk = k.shape[2]
        s = s - torch.full((Tk, Tk), INF, device=s.device).triu(1)
    w = dropout(torch.softmax(s / math.sqrt(D), dim=-1), drop, train=train,
                generator=generator)
    o = _merge(w.to(v.dtype) @ v, D)
    return F.linear(o, p.wo.weight.to(o.dtype))


def _project(w: nn.Linear, x: torch.Tensor, dt: torch.dtype,
             n_heads: int) -> torch.Tensor:
    """The heads of x W^T, made in x's dtype and taken in ``dt``."""
    return _heads(F.linear(x, w.weight.to(x.dtype)).to(dt), n_heads)


def _mha(p: MultiHeadParams, query: torch.Tensor, kv: torch.Tensor, *,
         n_heads: int, causal: bool, drop: float, train: bool,
         generator: Optional[torch.Generator]) -> torch.Tensor:
    dt = query.dtype
    return _attend(p, _project(p.wq, query, dt, n_heads),
                   _project(p.wk, kv, dt, n_heads),
                   _project(p.wv, kv, dt, n_heads), causal=causal,
                   drop=drop, train=train, generator=generator)


def _residual(block: ResidualBlock, x: torch.Tensor, sub: torch.Tensor, *,
              drop: float, train: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """LayerNorm(x + dropout(sub)), the statistics in f32."""
    sub = dropout(sub, drop, train=train, generator=generator)
    ln = block.layernorm
    return layer_norm_affine(ln.gamma, ln.beta, x.float() + sub.float(),
                             LN_EPS, use_std=True).to(x.dtype)


def _ff(p: FeedForwardParams, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.relu(F.linear(x, p.linear1.weight.to(dt), p.linear1.bias.to(dt)))
    return F.linear(h, p.linear2.weight.to(dt), p.linear2.bias.to(dt))


def _embed(dec: Decoder, tokens: torch.Tensor) -> torch.Tensor:
    """The tied embedding: rows of ``out``'s weight times sqrt(d_model)
    (f32, as the parameters)."""
    return dec.out.weight[tokens] * math.sqrt(dec.out.weight.shape[1])


def decoder_apply(dec: Decoder, tokens: torch.Tensor,
                  encodings: List[torch.Tensor], *, n_heads: int,
                  drop: float, train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Teacher-forced pass over ``tokens`` (B, T) -> (B, T, d_model) in f32
    (the embedding's dtype; each encoding's projections are made in its
    own dtype).  Dropout at the JAX package's sites: the embedding plus
    positions, and per layer the two attentions' probs and the three
    residuals (transformer.py:281-293)."""
    D = encodings[0].shape[-1]
    x = _embed(dec, tokens)
    x = x + positional_encodings(x.shape[1], D, x.dtype, x.device)[None]
    x = dropout(x, drop, train=train, generator=generator)
    kw = dict(drop=drop, train=train, generator=generator)
    for layer, enc in zip(dec.layers, encodings):
        a = _mha(layer.selfattn.layer, x, x, n_heads=n_heads, causal=True,
                 **kw)
        x = _residual(layer.selfattn, x, a, **kw)
        c = _mha(layer.attention.layer, x, enc, n_heads=n_heads,
                 causal=False, **kw)
        x = _residual(layer.attention, x, c, **kw)
        x = _residual(layer.feedforward, x, _ff(layer.feedforward.layer, x),
                      **kw)
    return x


def decoder_xe_loss(dec: Decoder, encodings: List[torch.Tensor],
                    seq: torch.Tensor, *, n_heads: int, drop: float,
                    train: bool,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Cross-entropy over the non-pad targets (transformer.py:271-280);
    ``seq`` (B, T + 1) starts with BOS = 0."""
    out = decoder_apply(dec, seq[:, :-1], encodings, n_heads=n_heads,
                        drop=drop, train=train, generator=generator)
    targets = seq[:, 1:]
    logits = F.linear(out, dec.out.weight.to(out.dtype),
                      dec.out.bias.to(out.dtype))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = (targets != 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def decoder_greedy(dec: Decoder, encodings: List[torch.Tensor], T: int, *,
                   n_heads: int) -> torch.Tensor:
    """Incremental greedy decode (transformer.py:214-241) -> (B, T) int32:
    from BOS = 0, the argmax of each step's logits (no UNK suppression),
    in the encodings' dtype.

    The JAX package's scan re-projects every layer's whole encoding and
    its (B, T, D) buffer of filled slots at every step; the values are
    those of a row's projection alone, so here each layer's cross-attention
    keys and values are made once per decode and each slot's self-
    attention key and value once, when the slot is filled.  The step
    attends the slots up to its own; the JAX package masks the later ones
    with -INF, which adds an exact zero to its softmax."""
    enc0 = encodings[0]
    B, D, dt, dev = enc0.shape[0], enc0.shape[-1], enc0.dtype, enc0.device
    width = -(-D // n_heads)
    pe = positional_encodings(T, D, dt, dev)
    cross = [(_project(l.attention.layer.wk, enc, dt, n_heads).contiguous(),
              _project(l.attention.layer.wv, enc, dt, n_heads).contiguous())
             for l, enc in zip(dec.layers, encodings)]
    cache = [[torch.zeros(B, n_heads, T, width, dtype=dt, device=dev)
              for _ in range(2)] for _ in dec.layers]
    tok = torch.zeros(B, dtype=torch.long, device=dev)
    toks = []
    kw = dict(drop=0.0, train=False, generator=None)
    for t in range(T):
        x = (_embed(dec, tok) + pe[t].float()).to(dt)[:, None]   # (B, 1, D)
        for layer, (ck, cv), (sk, sv) in zip(dec.layers, cross, cache):
            p = layer.selfattn.layer
            sk[:, :, t:t + 1] = _project(p.wk, x, dt, n_heads)
            sv[:, :, t:t + 1] = _project(p.wv, x, dt, n_heads)
            a = _attend(p, _project(p.wq, x, dt, n_heads),
                        sk[:, :, :t + 1], sv[:, :, :t + 1], causal=False,
                        **kw)
            x = _residual(layer.selfattn, x, a, **kw)
            p = layer.attention.layer
            c = _attend(p, _project(p.wq, x, dt, n_heads), ck, cv,
                        causal=False, **kw)
            x = _residual(layer.attention, x, c, **kw)
            x = _residual(layer.feedforward, x,
                          _ff(layer.feedforward.layer, x), **kw)
        logits = F.linear(x[:, 0], dec.out.weight.to(dt),
                          dec.out.bias.to(dt))
        tok = logits.argmax(dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32)
