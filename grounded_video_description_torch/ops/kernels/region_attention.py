"""K3: per-token additive region attention, one fused kernel.

Replaces ``grounded_video_description_tpu/ops/pallas/region_attention.py
::fused_region_attention`` and keeps its public layout.  The CUDA source
is ``csrc/region_attention.cu``; ``fused_region_attention_plain`` is the
same function in plain PyTorch (f32 arithmetic, outputs in the input
dtype), used for CPU tensors and as the reference on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from grounded_video_description_torch.ops import MIN_VALUE
from grounded_video_description_torch.ops.kernels import _build


def fused_region_attention_plain(p_pool_feats, att_h, pool_feats, alpha_w,
                                 alpha_b, att_mask, pnt_mask
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p_pool_feats (B, R, H); att_h (B, H); pool_feats (B, R, D);
    alpha_w with H elements; alpha_b with one; masks (B, R) bool, True =
    masked.  Returns (att_res (B, D), grd_logits (B, R)) in
    p_pool_feats' dtype."""
    f32 = torch.float32
    H = p_pool_feats.shape[-1]
    dot = torch.tanh(p_pool_feats.to(f32) + att_h.to(f32)[:, None, :])
    scores = dot @ alpha_w.to(f32).reshape(H) + alpha_b.to(f32).reshape(())
    scores = scores.masked_fill(att_mask, MIN_VALUE)
    grd = scores.masked_fill(pnt_mask, MIN_VALUE)
    weight = torch.softmax(scores, dim=1)
    att_res = torch.einsum("br,brd->bd", weight, pool_feats.to(f32))
    out_dtype = p_pool_feats.dtype
    return att_res.to(out_dtype), grd.to(out_dtype)


def fused_region_attention(p_pool_feats, att_h, pool_feats, alpha_w,
                           alpha_b, att_mask, pnt_mask
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``fused_region_attention_plain``.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel.  No
    backward: an input that requires grad raises under grad mode."""
    _build.refuse_grad("region_attention", p_pool_feats, att_h, pool_feats,
                       alpha_w, alpha_b)
    if not p_pool_feats.is_cuda:
        return fused_region_attention_plain(
            p_pool_feats, att_h, pool_feats, alpha_w, alpha_b, att_mask,
            pnt_mask)
    B, R, H = p_pool_feats.shape
    D = pool_feats.shape[-1]
    dt = p_pool_feats.dtype
    req = _build.require
    req(att_h.shape == (B, H), f"att_h {tuple(att_h.shape)} != {(B, H)}")
    req(pool_feats.shape[:2] == (B, R), "pool_feats batch/ROI shape")
    req(att_mask.shape == (B, R) and pnt_mask.shape == (B, R), "mask shape")
    req(att_mask.dtype == torch.bool and pnt_mask.dtype == torch.bool,
        "masks must be bool")
    req(att_h.dtype == dt and pool_feats.dtype == dt,
        "p_pool_feats, att_h and pool_feats must share one dtype")
    req(alpha_w.numel() == H and alpha_b.numel() == 1, "alpha shapes")
    req(H % 4 == 0 and D % 4 == 0, "the kernel loads 4 elements at a time: "
        f"H={H} and D={D} must be multiples of 4")
    dev = p_pool_feats.device
    for t in (att_h, pool_feats, alpha_w, alpha_b, att_mask, pnt_mask):
        req(t.device == dev, "all inputs must be on one device")

    p_pool_feats = _build.aligned16(p_pool_feats)
    att_h = att_h.contiguous()
    pool_feats = _build.aligned16(pool_feats)
    aw = alpha_w.to(torch.float32).reshape(H).contiguous()
    ab = alpha_b.to(torch.float32).reshape(1).contiguous()
    am = att_mask.contiguous()
    pm = pnt_mask.contiguous()
    att_res = torch.empty((B, D), dtype=dt, device=dev)
    grd = torch.empty((B, R), dtype=dt, device=dev)
    code = _build.lib().gvd_region_attention(
        _build.dtype_code(p_pool_feats), p_pool_feats.data_ptr(),
        att_h.data_ptr(), pool_feats.data_ptr(), aw.data_ptr(),
        ab.data_ptr(), am.data_ptr(), pm.data_ptr(), att_res.data_ptr(),
        grd.data_ptr(), B, R, H, D, _build.stream_of(p_pool_feats))
    _build.check(code, "region_attention")
    _build.launches["region_attention"] += 1
    return att_res, grd
