"""K1: one post-LN obj_interact encoder layer at inference.

Replaces ``grounded_video_description_tpu/ops/pallas/encoder_layer.py
::fused_encoder_layer`` / ``encoder_apply_fused``.  The CUDA source is
``csrc/encoder_layer.cu``: a tiled GEMM (QKV, output and FFN projections),
an attention kernel whose (R, R) scores stay in shared memory, and a
residual + unbiased-std LayerNorm kernel.  The TPU kernel packed the six
uneven heads into zero-padded slots for its matrix unit; here a head is a
column range of the QKV buffer, so no packing is needed.

``fused_encoder_layer_plain`` is the same layer in plain PyTorch, with the
kernel's numerics (scores, softmax and LayerNorm statistics in f32;
activations stored in the input dtype between the pieces).  It serves CPU
tensors, is the model's plain path (``models/transformer.py::
encoder_apply`` without the kernel) and is the reference on the card.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from grounded_video_description_torch.nn.core import layer_norm_affine
from grounded_video_description_torch.ops.kernels import _build

LN_EPS = 1e-6


class EncoderLayerWeights(NamedTuple):
    """One layer's tensors, linear weights in (out, in) layout."""
    wq: torch.Tensor        # (D, D)
    wk: torch.Tensor        # (D, D)
    wv: torch.Tensor        # (D, D)
    wo: torch.Tensor        # (D, D)
    w1: torch.Tensor        # (F, D)
    b1: torch.Tensor        # (F,)
    w2: torch.Tensor        # (D, F)
    b2: torch.Tensor        # (D,)
    g1: torch.Tensor        # (D,) LayerNorm after attention
    be1: torch.Tensor
    g2: torch.Tensor        # (D,) LayerNorm after the FFN
    be2: torch.Tensor


def head_slices(d: int, n_heads: int) -> List[slice]:
    """torch.chunk boundaries: ceil-sized chunks, the last one smaller."""
    size = -(-d // n_heads)
    return [slice(s, min(s + size, d)) for s in range(0, d, size)]


def fused_encoder_layer_plain(x: torch.Tensor, w: EncoderLayerWeights, *,
                              n_heads: int) -> torch.Tensor:
    """x (B, R, D) -> (B, R, D) in x's dtype."""
    dt, f32 = x.dtype, torch.float32
    D = x.shape[-1]
    inv_scale = 1.0 / math.sqrt(D)           # one shared scale sqrt(D)
    q = F.linear(x, w.wq.to(dt))
    k = F.linear(x, w.wk.to(dt))
    v = F.linear(x, w.wv.to(dt))
    heads = []
    for sl in head_slices(D, n_heads):
        s = (q[..., sl].to(f32) @ k[..., sl].to(f32).transpose(1, 2)) \
            * inv_scale
        heads.append((torch.softmax(s, dim=-1) @ v[..., sl].to(f32)).to(dt))
    return layer_tail(x, F.linear(torch.cat(heads, dim=-1), w.wo.to(dt)), w)


def layer_tail(x: torch.Tensor, a: torch.Tensor,
               w: EncoderLayerWeights) -> torch.Tensor:
    """The layer after its self-attention ``a`` (output projection
    applied): residual + LayerNorm, ReLU FFN, residual + LayerNorm, with
    the statistics in f32."""
    dt, f32 = x.dtype, torch.float32
    x1 = layer_norm_affine(w.g1, w.be1, x.to(f32) + a.to(f32), LN_EPS,
                           use_std=True).to(dt)
    hdn = F.relu(F.linear(x1, w.w1.to(dt), w.b1.to(dt)))
    f = F.linear(hdn, w.w2.to(dt), w.b2.to(dt))
    return layer_norm_affine(w.g2, w.be2, x1.to(f32) + f.to(f32), LN_EPS,
                             use_std=True).to(dt)


def _gemm(a: torch.Tensor, w: torch.Tensor, bias, relu: bool):
    """(M, K) x (N, K)^T (+ bias, ReLU) -> (M, N), on the card."""
    a, w = _build.aligned16(a), _build.aligned16(w)
    M, K = a.shape
    N = w.shape[0]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    code = _build.lib().gvd_gemm(
        _build.dtype_code(a), a.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, c.data_ptr(),
        M, N, K, int(relu), _build.stream_of(a))
    _build.check(code, "gemm")
    return c


def _residual_ln(x: torch.Tensor, y: torch.Tensor, gamma, beta):
    rows, D = x.shape
    out = torch.empty_like(x)
    code = _build.lib().gvd_residual_layer_norm(
        _build.dtype_code(x), x.data_ptr(), y.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), out.data_ptr(), rows, D, LN_EPS,
        _build.stream_of(x))
    _build.check(code, "residual_layer_norm")
    return out


def fused_encoder_layer(x: torch.Tensor, w: EncoderLayerWeights, *,
                        n_heads: int) -> torch.Tensor:
    """Same contract as ``fused_encoder_layer_plain``.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernels.  No backward:
    an input that requires grad raises under grad mode."""
    _build.refuse_grad("fused_encoder_layer", x, *w)
    if not x.is_cuda:
        return fused_encoder_layer_plain(x, w, n_heads=n_heads)
    req = _build.require
    req(x.dim() == 3, f"x must be (B, R, D), got {tuple(x.shape)}")
    B, R, D = x.shape
    Fh = w.w1.shape[0]
    req(-(-D // n_heads) <= 256, "a head is at most 256 wide")
    shapes = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D),
              "w1": (Fh, D), "b1": (Fh,), "w2": (D, Fh), "b2": (D,),
              "g1": (D,), "be1": (D,), "g2": (D,), "be2": (D,)}
    for name, shape in shapes.items():
        t = getattr(w, name)
        req(tuple(t.shape) == shape, f"{name} {tuple(t.shape)} != {shape}")
        req(t.device == x.device, f"{name} is on {t.device}")
    dt, f32 = x.dtype, torch.float32

    def mat(t):
        return t.to(dt).contiguous()

    def vec(t):
        return t.to(f32).contiguous()

    x2 = x.contiguous().reshape(B * R, D)
    wqkv = torch.cat([w.wq, w.wk, w.wv], dim=0).to(dt).contiguous()
    qkv = _gemm(x2, wqkv, None, relu=False)                    # (M, 3D)
    attn = torch.empty((B * R, D), dtype=dt, device=x.device)
    code = _build.lib().gvd_attention(
        _build.dtype_code(x), qkv.data_ptr(), attn.data_ptr(), B, R, D,
        n_heads, 1.0 / math.sqrt(D), _build.stream_of(x))
    _build.check(code, "attention")
    a = _gemm(attn, mat(w.wo), None, relu=False)
    x1 = _residual_ln(x2, a, vec(w.g1), vec(w.be1))
    hdn = _gemm(x1, mat(w.w1), vec(w.b1), relu=True)
    f = _gemm(hdn, mat(w.w2), vec(w.b2), relu=False)
    out = _residual_ln(x1, f, vec(w.g2), vec(w.be2))
    _build.launches["encoder_layer"] += 1
    return out.reshape(B, R, D)
