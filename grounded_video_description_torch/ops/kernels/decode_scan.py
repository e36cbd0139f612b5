"""K6: the whole greedy caption decode, one kernel launch.

Replaces ``grounded_video_description_tpu/ops/pallas/decode_scan.py
::greedy_decode_fused``.  The CUDA source is ``csrc/decode_scan.cu``: a
persistent cooperative kernel that runs every step (both LSTM cells, the
temporal and region attentions, the vocab log-softmax, the UNK-suppressed
pick and the next token's embedding) with grid-wide barriers between its
phases.  The TPU kernel kept each batch tile's banks in VMEM across the
steps; on the card they stream from device memory every step, and what
the kernel removes is the step loop's host launches (see the source).

``greedy_decode_fused_plain`` is the port's step loop, the one
``GVDModel.sample_greedy`` runs without K6 (K3 inside it where the model's
``use_pallas`` asks for it).  CPU tensors take it, and it is the reference
on the card.  Both return (seq (B, L) int32, logprobs (B, L) f32, att2
(B, L, R) in the model's compute dtype: the pnt-masked region logits of
each step).

The kernel applies where the JAX package's does: ``att_input_mode`` both
and ``region_attn_mode`` add or mix (``GVDModel.sample_greedy`` checks).
The TPU kernel also needed a batch that its tile of 4 divides; this one
takes any batch size.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from grounded_video_description_torch.ops import MIN_VALUE
from grounded_video_description_torch.ops.kernels import _build


def greedy_decode_fused_plain(model, enc: Dict[str, torch.Tensor],
                              pnt_mask: torch.Tensor
                              ) -> Tuple[torch.Tensor, ...]:
    """UNK-suppressed greedy decode of ``model`` (a ``GVDModel``) over the
    banks ``enc`` of ``GVDModel.encode``: ``cfg.seq_length`` steps of
    ``core_step`` from BOS = token 0, two first-index argmaxes per step
    (model.py:589-594)."""
    B = pnt_mask.shape[0]
    dev = pnt_mask.device
    state = model.init_state(B, dev)
    tok = torch.zeros((B,), dtype=torch.long, device=dev)
    toks, lps, att2s = [], [], []
    for _ in range(model.cfg.seq_length):
        xt = model.embed_words(tok)
        out, state, att2_w, _ = model.core_step(
            xt, enc["fc_feats"], enc["conv_feats"], enc["p_conv_feats"],
            enc["pool_feats"], enc["p_pool_feats"], pnt_mask, pnt_mask,
            state)
        logprobs = model.logit_logprobs(out)
        i1 = logprobs.argmax(dim=1)
        v1 = logprobs.gather(1, i1[:, None])[:, 0]
        masked = logprobs.scatter(1, i1[:, None], MIN_VALUE)
        i2 = masked.argmax(dim=1)
        v2 = masked.gather(1, i2[:, None])[:, 0]
        use_first = i1 != model.unk_idx
        tok = torch.where(use_first, i1, i2)
        toks.append(tok)
        lps.append(torch.where(use_first, v1, v2))
        att2s.append(att2_w)
    seq = torch.stack(toks, dim=1).to(torch.int32)
    return seq, torch.stack(lps, dim=1), torch.stack(att2s, dim=1)


def greedy_decode_fused(model, enc: Dict[str, torch.Tensor],
                        pnt_mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Same contract as ``greedy_decode_fused_plain``.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (one count per
    decode).  No backward: under grad mode, banks or weights that require
    grad raise."""
    core = model.core
    att, lang = core.att_lstm, core.lang_lstm
    banks = [enc[k] for k in ("fc_feats", "conv_feats", "p_conv_feats",
                              "pool_feats", "p_pool_feats")]
    _build.refuse_grad("greedy_decode", *banks, *model.parameters())
    if not pnt_mask.is_cuda:
        return greedy_decode_fused_plain(model, enc, pnt_mask)
    cfg = model.cfg
    fc, conv, p_conv, pool, p_pool = banks
    dt = conv.dtype
    B, Tf, H = conv.shape
    R, A = pool.shape[1], p_pool.shape[2]
    E, L = cfg.input_encoding_size, cfg.seq_length
    V, Vp = cfg.vocab_size, model.logit.weight.shape[0]
    dev = pnt_mask.device
    req = _build.require
    req(fc.shape == (B, H) and p_conv.shape == (B, Tf, A)
        and pool.shape == (B, R, H) and pnt_mask.shape == (B, R + 1),
        "bank shapes")
    req(all(t.dtype == dt for t in banks), "banks must share one dtype")
    req(all(t.device == dev for t in banks)
        and model.logit.weight.device == dev,
        "banks, mask and model must be on one device")
    req(H % 8 == 0 and A % 4 == 0, f"the kernel takes rnn_size {H} in "
        f"tiles of 8 units and att_hid {A} in loads of 4")
    _build.dtype_code(conv)

    def mat(w):
        return _build.aligned16(w.detach().to(dt))

    def vec(*ts):
        return sum(t.detach().float() for t in ts).contiguous()

    w_ih = att.weight_ih.detach().to(dt)
    g0 = F.linear(fc.float(), w_ih[:, :H].float()) + vec(att.bias_ih,
                                                          att.bias_hh)
    weights = [
        mat(w_ih[:, H:]), mat(att.weight_hh), g0.contiguous(),
        mat(lang.weight_ih), mat(lang.weight_hh),
        vec(lang.bias_ih, lang.bias_hh),
        mat(torch.cat([core.attention.h2att.weight,
                       core.attention2.h2att.weight])),
        vec(torch.cat([core.attention.h2att.bias,
                       core.attention2.h2att.bias])),
        vec(torch.stack([core.attention.alpha_net.weight.reshape(A),
                         core.attention2.alpha_net.weight.reshape(A)])),
        vec(torch.cat([core.attention.alpha_net.bias.reshape(1),
                       core.attention2.alpha_net.bias.reshape(1)])),
        mat(model.logit.weight), vec(model.logit.bias),
        mat(model.embed[0].weight)]

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    xt = F.relu(weights[-1][0].float()).expand(B, E).contiguous()
    state = [xt, torch.zeros(2, B, H, device=dev), torch.zeros(B, H,
                                                               device=dev),
             torch.zeros(2, B, H, device=dev), torch.zeros(B, H, device=dev),
             f32(B, 2 * A), f32(B, Tf + R), f32(B, 2, H), f32(B, Vp),
             torch.zeros(2, dtype=torch.int32, device=dev)]
    seq = torch.empty((B, L), dtype=torch.int32, device=dev)
    logprobs = f32(B, L)
    att2 = torch.empty((B, L, R), dtype=dt, device=dev)
    args = ([_build.aligned16(t) for t in (conv, p_conv, pool, p_pool)]
            + [pnt_mask[:, 1:].contiguous()] + weights + state
            + [seq, logprobs, att2])
    with torch.cuda.device(dev):
        code = _build.lib().gvd_greedy_decode(
            _build.dtype_code(conv), *[t.data_ptr() for t in args], B, Tf,
            R, H, A, E, V, Vp, L, model.unk_idx, _build.stream_of(conv))
    _build.check(code, "greedy_decode")
    _build.launches["decode_scan"] += 1
    return seq, logprobs, att2
