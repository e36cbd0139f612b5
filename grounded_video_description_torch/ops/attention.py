"""Attention ops of the port (counterpart of
``grounded_video_description_tpu/ops/attention.py``).

Behavioural contracts:
  * temporal additive attention over frame features —
    misc/AttModel.py:22-53 (`Attention`);
  * region attention with dual masking — misc/AttModel.py:56-108
    (`Attention2`);
  * word<->region grounding scorer — misc/model.py:243-280 (`_grounder`).

Mask convention: bool, True == masked.  Masked scores are set to
MIN_VALUE *before* the softmax; the returned grounding logits also carry
the pnt mask.

The attention parameters come as a module ``p`` with ``h2att`` and, where
the mode has one, ``alpha_net`` (``nn.Linear``s), named as in the
reference state dict (``core.attention2.h2att`` and so on).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from grounded_video_description_torch.nn import linear
from grounded_video_description_torch.ops import MIN_VALUE
from grounded_video_description_torch.ops.kernels.region_attention import (
    fused_region_attention, fused_region_attention_plain,
)
from grounded_video_description_torch.ops.quantize import dequantize


def _lin(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return linear(x, m.weight, m.bias)


def temporal_attention(p: nn.Module, h: torch.Tensor,
                       att_feats: torch.Tensor,
                       p_att_feats: torch.Tensor) -> torch.Tensor:
    """h (B, rnn); att_feats (B, T, rnn); p_att_feats (B, T, att_hid)
    -> (B, rnn).  Either bank may be a ``QuantBank``, dequantized into
    the query's dtype."""
    att_h = _lin(p.h2att, h)                                  # (B, H)
    p_att_feats = dequantize(p_att_feats, att_h.dtype)
    att_feats = dequantize(att_feats, att_h.dtype)
    dot = torch.tanh(p_att_feats + att_h[:, None, :])         # (B, T, H)
    scores = _lin(p.alpha_net, dot)[..., 0]                   # (B, T)
    weight = torch.softmax(scores, dim=1)
    return torch.einsum("bt,btd->bd", weight, att_feats)


def region_attention(p: nn.Module, h: torch.Tensor,
                     pool_feats: torch.Tensor, p_pool_feats: torch.Tensor,
                     att_mask: torch.Tensor, pnt_mask: torch.Tensor, *,
                     mode: str, use_kernel: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Region attention with dual masking.

    h (B, rnn); pool_feats (B, R, rnn); p_pool_feats (B, R, att_hid);
    att_mask / pnt_mask (B, R) bool, True == masked.
    mode: 'add' | 'mix' (additive), 'mix_mul' (multiplicative inside the
    tanh), 'cat' (concatenated), 'dp' (dot product).
    Returns (att_res (B, rnn), grounding_logits (B, R), att_h).

    Modes add/mix are K3: ``fused_region_attention`` with ``use_kernel``,
    else its plain twin ``fused_region_attention_plain`` (f32 arithmetic,
    outputs in the input dtype).  Either bank may be a ``QuantBank``,
    dequantized into the query's dtype before K3 reads it, as the JAX
    package hands its K3 the dequantized bank.
    """
    att_h = _lin(p.h2att, h)                                  # (B, H)
    p_pool_feats = dequantize(p_pool_feats, att_h.dtype)
    pool_feats = dequantize(pool_feats, att_h.dtype)

    if mode in ("add", "mix"):
        fn = (fused_region_attention if use_kernel
              else fused_region_attention_plain)
        att_res, grd = fn(p_pool_feats, att_h, pool_feats,
                          p.alpha_net.weight, p.alpha_net.bias, att_mask,
                          pnt_mask)
        return att_res, grd, att_h

    if mode == "mix_mul":
        dot = torch.tanh(p_pool_feats * att_h[:, None, :])
        scores = _lin(p.alpha_net, dot)[..., 0]
    elif mode == "cat":
        dot = torch.cat([p_pool_feats,
                         att_h[:, None, :].expand_as(p_pool_feats)], dim=-1)
        scores = _lin(p.alpha_net, torch.tanh(dot))[..., 0]
    elif mode == "dp":
        scores = torch.einsum("brh,bh->br", p_pool_feats, att_h)
    else:
        raise ValueError(f"unknown region_attn_mode {mode!r}")

    scores = scores.masked_fill(att_mask, MIN_VALUE)          # (B, R)
    grd_logits = scores.masked_fill(pnt_mask, MIN_VALUE)
    weight = torch.softmax(scores, dim=1)
    att_res = torch.einsum("br,brd->bd", weight, pool_feats)
    return att_res, grd_logits, att_h


def temporal_attention_beam(p: nn.Module, h: torch.Tensor,
                            att_feats: torch.Tensor,
                            p_att_feats: torch.Tensor) -> torch.Tensor:
    """Beam variant sharing one attention bank across W beams.

    h (B, W, rnn); att_feats (B, T, rnn); p_att_feats (B, T, att_hid).
    Returns (B, W, rnn): ``temporal_attention`` on W-replicated banks,
    without materialising the W copies."""
    att_h = _lin(p.h2att, h)                                  # (B, W, H)
    dot = (p_att_feats[:, None] + att_h[:, :, None]).tanh_()  # (B,W,T,H)
    scores = _lin(p.alpha_net, dot)[..., 0]                   # (B, W, T)
    weight = torch.softmax(scores, dim=-1)
    return torch.einsum("bwt,btd->bwd", weight, att_feats)


def region_attention_beam(p: nn.Module, h: torch.Tensor,
                          pool_feats: torch.Tensor,
                          p_pool_feats: torch.Tensor,
                          att_mask: torch.Tensor, pnt_mask: torch.Tensor, *,
                          mode: str
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam variant of ``region_attention`` with banks shared by the W
    beams, in plain torch for every mode (the JAX package's beam runs its
    XLA attention, not the kernel).

    h (B, W, rnn); pool_feats / p_pool_feats (B, R, *); masks (B, R).
    Returns (att_res (B, W, rnn), grd_logits (B, W, R), att_h)."""
    att_h = _lin(p.h2att, h)                                  # (B, W, H)
    if mode in ("add", "mix"):
        dot = (p_pool_feats[:, None] + att_h[:, :, None]).tanh_()
        scores = _lin(p.alpha_net, dot)[..., 0]               # (B, W, R)
    elif mode == "mix_mul":
        dot = (p_pool_feats[:, None] * att_h[:, :, None]).tanh_()
        scores = _lin(p.alpha_net, dot)[..., 0]
    elif mode == "cat":
        B, W, H = att_h.shape
        R = p_pool_feats.shape[1]
        dot = torch.cat([p_pool_feats[:, None].expand(B, W, R, H),
                         att_h[:, :, None].expand(B, W, R, H)], dim=-1)
        scores = _lin(p.alpha_net, dot.tanh_())[..., 0]
    elif mode == "dp":
        scores = torch.einsum("brh,bwh->bwr", p_pool_feats, att_h)
    else:
        raise ValueError(f"unknown region_attn_mode {mode!r}")

    scores = scores.masked_fill(att_mask[:, None], MIN_VALUE)
    grd_logits = scores.masked_fill(pnt_mask[:, None], MIN_VALUE)
    weight = torch.softmax(scores, dim=-1)
    att_res = torch.einsum("bwr,brd->bwd", weight, pool_feats)
    return att_res, grd_logits, att_h


def grounder(xt: torch.Tensor, att_feats: torch.Tensor, mask: torch.Tensor,
             bias: Optional[torch.Tensor] = None, *,
             alpha_net: Optional[nn.Linear] = None,
             additive_cat: bool = False) -> torch.Tensor:
    """Word <-> region scorer (misc/model.py:243-280).

    xt (B, S, E) word side; att_feats (B, R, E) region side; mask (B, R)
    or (B, S, R) bool, True == masked; bias broadcastable to (B, S, R),
    added before the mask.  With ``alpha_net``: additive scores through
    that head, else dot product.  Returns (B, S, R) masked logits."""
    if alpha_net is not None:
        B, S, E = xt.shape
        R = att_feats.shape[1]
        if additive_cat:
            dot = torch.cat([xt[:, :, None, :].expand(B, S, R, E),
                             att_feats[:, None, :, :].expand(B, S, R, E)],
                            dim=-1)
        else:
            dot = xt[:, :, None, :] + att_feats[:, None, :, :]
        logits = _lin(alpha_net, torch.tanh(dot))[..., 0]     # (B, S, R)
    else:
        if xt.shape[-1] != att_feats.shape[-1]:
            raise ValueError("dot-product grounder needs equal widths")
        logits = torch.einsum("bse,bre->bsr", xt, att_feats)

    if bias is not None:
        logits = logits + bias
    if mask.dim() == 2:
        mask = mask[:, None, :]
    return logits.masked_fill(mask, MIN_VALUE)
