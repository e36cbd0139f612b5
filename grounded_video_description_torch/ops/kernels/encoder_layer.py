"""K1: one post-LN obj_interact encoder layer at inference.

Replaces ``grounded_video_description_tpu/ops/pallas/encoder_layer.py
::fused_encoder_layer`` / ``encoder_apply_fused``.  The CUDA source is
``csrc/encoder_layer.cu``: a GEMM (QKV, output and FFN projections on the
tensor cores through a cp.async ring: bf16 on mma.sync, f32 in 3xTF32),
the attention and a residual + unbiased-std LayerNorm kernel.  The
attention is K7's tensor-core forward (``csrc/attention_mma.cu`` in bf16,
``csrc/attention_tf32x3.cu`` in f32), whose repack reads q, k and v from
the (B, R, 3D) QKV buffer at column offsets 0, D, 2D with a row stride of
3D into zero-padded head slots, as the TPU kernel packed its six uneven
heads (``qkv_heads_plain`` is that repack in plain PyTorch).  An f32 head
past the widest packed width (193-256) takes a SIMT kernel instead
(``attention_route``).

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
# The launch count of each attention route, beside ``encoder_layer``'s own
# (``tf32x3`` also counts ``attention_train.TF32_ROUTE``)
ATTENTION_ROUTES = {"mma": "encoder_layer_attention_mma",
                    "tf32x3": "encoder_layer_attention_tf32x3",
                    "simt": "encoder_layer_attention_simt"}
WIDEST_F32_HEAD = 256   # the SIMT route's widest head


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
    dt = x.dtype
    D = x.shape[-1]
    inv_scale = 1.0 / math.sqrt(D)           # one shared scale sqrt(D)
    q = F.linear(x, w.wq.to(dt))
    k = F.linear(x, w.wk.to(dt))
    v = F.linear(x, w.wv.to(dt))
    a = self_attention_plain(q, k, v, n_heads, inv_scale)
    return layer_tail(x, F.linear(a, w.wo.to(dt)), w)


def self_attention_plain(q, k, v, n_heads: int,
                         inv_scale: float) -> torch.Tensor:
    """softmax(q_h k_h^T * inv_scale) v_h per head (the ``torch.chunk``
    column ranges), scores and softmax in f32, the heads concatenated
    back in q's dtype."""
    f32 = torch.float32
    heads = []
    for sl in head_slices(q.shape[-1], n_heads):
        s = (q[..., sl].to(f32) @ k[..., sl].to(f32).transpose(1, 2)) \
            * inv_scale
        heads.append((torch.softmax(s, dim=-1) @ v[..., sl].to(f32))
                     .to(q.dtype))
    return torch.cat(heads, dim=-1)


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


def qkv_heads_plain(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """qkv (B, R, 3D) as K1's QKV GEMM writes it -> (3, B, H, Rt, dp): q,
    k and v (columns from 0, D and 2D, rows 3D apart) each packed as
    ``pack_heads_plain``: what the bf16 attention's repack writes into its
    scratch before the tensor-core forward."""
    from grounded_video_description_torch.ops.kernels.attention_train import (
        pack_heads_plain)
    D = qkv.shape[-1] // 3
    return torch.stack([pack_heads_plain(qkv[..., i * D:(i + 1) * D],
                                         n_heads) for i in range(3)])


def pack_qkv(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``qkv_heads_plain`` on the card: one launch of the bf16 repack
    kernel, reading the (B, R, 3D) buffer in place at the column offsets
    and row stride of K1's bf16 attention.  For the tests; counts no
    launch.  CPU tensors take the plain version."""
    if not qkv.is_cuda:
        return qkv_heads_plain(qkv, n_heads)
    from grounded_video_description_torch.ops.kernels.attention_train import (
        _pack_scratch)
    _build.require(qkv.dtype == torch.bfloat16 and qkv.dim() == 3
                   and qkv.shape[-1] % 3 == 0, "qkv must be bf16 (B, R, 3D)")
    qkv = qkv.contiguous()
    B, R, D3 = qkv.shape
    D = D3 // 3
    out = _pack_scratch(3, B, R, D, n_heads, qkv.device)
    p, step = qkv.data_ptr(), D * qkv.element_size()
    code = _build.lib().gvd_pack_heads(
        1, 3, p, p + step, p + 2 * step, None, out.data_ptr(), B, R, D,
        n_heads, 3 * D, _build.stream_of(qkv))
    _build.check(code, "pack_heads")
    return out


def attention_route(dtype: torch.dtype, head: int) -> str:
    """The attention kernel that K1 runs for heads ``head`` wide in
    ``dtype`` (a key of ``ATTENTION_ROUTES``): the tensor-core forward up
    to the widest packed width (``attention_train.MAX_HEAD``), ``mma`` in
    bf16 and ``tf32x3`` in f32; past it, in f32 only and up to
    ``WIDEST_F32_HEAD``, the SIMT kernel.  Raises on a head that no route
    takes."""
    from grounded_video_description_torch.ops.kernels.attention_train import (
        MAX_HEAD)
    if head <= MAX_HEAD:
        return "mma" if dtype == torch.bfloat16 else "tf32x3"
    widest = MAX_HEAD if dtype == torch.bfloat16 else WIDEST_F32_HEAD
    _build.require(head <= widest, f"a head is at most {widest} wide")
    return "simt"


def _gemm(a: torch.Tensor, w: torch.Tensor, bias, relu: bool):
    """(M, K) x (N, K)^T (+ bias, ReLU) -> (M, N), on the card.  A K that
    is no multiple of 16 bytes (8 elements in bf16, 4 in f32) is
    zero-padded to one (16-byte rows for cp.async), which changes no
    product."""
    per16 = 16 // a.element_size()
    if a.shape[1] % per16:
        pad = (0, -a.shape[1] % per16)
        a, w = F.pad(a, pad), F.pad(w, pad)
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


def _attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The layer's attention on the card: qkv (B, R, 3D) as the QKV GEMM
    writes it -> (B, R, D), ``self_attention_plain`` of its q, k, v at the
    layer's scale 1 / sqrt(D), on ``attention_route``'s kernel: one count
    of its ``ATTENTION_ROUTES`` name (``tf32x3`` also one of
    ``TF32_ROUTE``)."""
    from grounded_video_description_torch.ops.kernels.attention_train import (
        _pack_scratch, count_route)
    B, R, D3 = qkv.shape
    D = D3 // 3
    route = attention_route(qkv.dtype, -(-D // n_heads))
    attn = torch.empty((B, R, D), dtype=qkv.dtype, device=qkv.device)
    scratch = (None if route == "simt" else
               _pack_scratch(3, B, R, D, n_heads, qkv.device, qkv.dtype))
    code = _build.lib().gvd_attention(
        _build.dtype_code(qkv), qkv.data_ptr(), attn.data_ptr(),
        _build.ptr(scratch), B, R, D, n_heads, 1.0 / math.sqrt(D),
        _build.stream_of(qkv))
    _build.check(code, "attention")
    _build.launches[ATTENTION_ROUTES[route]] += 1
    if route == "tf32x3":
        count_route(qkv)
    return attn


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
    the plain version; a CUDA tensor launches the kernels (one count of
    ``encoder_layer`` a call, and those of its attention's route, see
    ``_attention``).  No backward: an input that requires grad raises
    under grad mode."""
    _build.refuse_grad("fused_encoder_layer", x, *w)
    if not x.is_cuda:
        return fused_encoder_layer_plain(x, w, n_heads=n_heads)
    req = _build.require
    req(x.dim() == 3, f"x must be (B, R, D), got {tuple(x.shape)}")
    B, R, D = x.shape
    Fh = w.w1.shape[0]
    attention_route(x.dtype, -(-D // n_heads))
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
    attn = _attention(qkv.view(B, R, 3 * D), n_heads)
    a = _gemm(attn.view(B * R, D), mat(w.wo), None, relu=False)
    x1 = _residual_ln(x2, a, vec(w.g1), vec(w.be1))
    hdn = _gemm(x1, mat(w.w1), vec(w.b1), relu=True)
    f = _gemm(hdn, mat(w.w2), vec(w.b2), relu=False)
    out = _residual_ln(x1, f, vec(w.g2), vec(w.be2))
    _build.launches["encoder_layer"] += 1
    return out.reshape(B, R, D)
