"""K7: unmasked self-attention softmax(q k^T) v per leading index, at
inference.

Replaces ``grounded_video_description_tpu/ops/pallas/mha.py
::flash_self_attention``.  No second attention body: on the card this is
K4's forward kernel with dropout compiled out, one head as wide as the
input (n_heads 1), no score scale (the caller pre-scales q) and no
log-sum-exp written; the C entry is ``gvd_flash_self_attention``.  q,
k, v are repacked to (N, 1, Rt, dp) in scratch first; f32 then runs the
3xTF32 tensor-core forward of ``csrc/attention_tf32x3.cu`` (one count
of ``TF32_ROUTE`` beside the kernel's), bf16 the tensor-core forward of
``csrc/attention_mma.cu``.  The obj_interact encoder calls it with
q, k, v of (B * 6, R, 171): its heads zero-padded to one width, as the
JAX package splits them.

``flash_self_attention_plain`` is the same function in plain PyTorch
(scores and softmax in f32, output in q's dtype).  CPU tensors take it,
and it is the reference on the card.
"""

from __future__ import annotations

import torch

from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.ops.kernels.attention_train import (
    MAX_HEAD, count_route, packed_scratch)


def flash_self_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """q, k, v (N, R, d), q pre-scaled.  Returns (N, R, d) in q's
    dtype."""
    s = q.float() @ k.float().transpose(1, 2)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def flash_self_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Same contract as ``flash_self_attention_plain``.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel.  No
    backward: an input that requires grad raises under grad mode."""
    _build.refuse_grad("flash_self_attention", q, k, v)
    req = _build.require
    req(q.dim() == 3, f"q must be (N, R, d), got {tuple(q.shape)}")
    req(q.shape == k.shape == v.shape, "self-attention: q, k, v of one shape")
    req(k.device == q.device and v.device == q.device,
        "all inputs must be on one device")
    if not q.is_cuda:
        return flash_self_attention_plain(q, k, v)
    req(q.dtype == k.dtype == v.dtype, "q, k, v must share one dtype")
    N, R, d = q.shape
    req(d <= MAX_HEAD, f"a head is at most {MAX_HEAD} wide, got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    scratch = packed_scratch(3, q, 1)
    code = _build.lib().gvd_flash_self_attention(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), N, R, d, _build.stream_of(q))
    _build.check(code, "flash_self_attention")
    _build.launches["flash_self_attention"] += 1
    count_route(q)
    return out
