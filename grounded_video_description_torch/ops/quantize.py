"""int8 attention banks for greedy decoding (``--quantize_banks``).

The port's copy of ``grounded_video_description_tpu/ops/quantize.py``:
symmetric int8 with abs-max / 127 scales along the last axis, one f32
scale per 128-column group (``group_size``), or one per row where the
group size is 0, does not divide the width or is not below it.  Scales
are ``max(amax, 1e-8) / 127``; values round half to even, as
``jnp.round`` does, and clip to [-127, 127].

``GVDModel.sample_greedy`` quantizes the four attention banks of one
encode and dequantizes each once per decode into the compute dtype; the
values are the JAX package's, which dequantizes inside every step.  The
attentions of ``ops/attention.py`` also accept a ``QuantBank`` and
dequantize it into their query's dtype, as the JAX ones do.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch


class QuantBank(NamedTuple):
    values: torch.Tensor   # int8, the source's shape
    scale: torch.Tensor    # f32, the source's shape with last dim n_groups


def quantize_rows(x: torch.Tensor, group_size: int = 128) -> QuantBank:
    """Symmetric int8 quantization of ``x`` along its last axis,
    ``group_size`` columns to a scale (0: one scale per row)."""
    xf = x.float()
    d = x.shape[-1]
    if group_size and d % group_size == 0 and d > group_size:
        xg = xf.reshape(*x.shape[:-1], d // group_size, group_size)
        scale = xg.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
        q = torch.round(xg / scale[..., None]).clamp(-127, 127)
        return QuantBank(q.reshape(x.shape).to(torch.int8), scale)
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127)
    return QuantBank(q.to(torch.int8), scale)


def dequantize(bank: Union[QuantBank, torch.Tensor],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A ``QuantBank`` as values of ``dtype`` (values times scales, both in
    ``dtype``); a tensor as it is."""
    if not isinstance(bank, QuantBank):
        return bank
    v, scale = bank.values, bank.scale.to(dtype)
    g = scale.shape[-1]
    if g == 1:
        return v.to(dtype) * scale
    vg = v.to(dtype).reshape(*v.shape[:-1], g, v.shape[-1] // g)
    return (vg * scale[..., None]).reshape(v.shape)
