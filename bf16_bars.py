#!/usr/bin/env python3
"""Read the errors behind the bf16 bars of the tensor-core attention on one
NVIDIA GPU.

    python3 bf16_bars.py [--out DIR]

1. The bf16 attention (K4's output and q, k, v gradients at the flagship
   (30, 1000, 1024) in six heads and at the card tests' shapes; K7's
   output at (600, 1000, 171) and (4, 300, 171)).  For each result it
   prints max |got - ref| / max |ref| against the plain twin (``ref``,
   f32 inside, rounded to bf16 at the end) for three ``got``:
   - the kernel;
   - the same function in plain bf16 arithmetic (each product, the
     softmax and the dropout rounded to bf16; autograd in bf16): a
     reference computed in lower precision;
   - the kernel's result with one head's columns 5% off: a fault that the
     bar must catch.
   chip_smoke.py and tests/test_torch_cuda.py hold the kernel to
   ``chip_smoke.ATTN_BF16_TOL`` of max |ref|: above the first two readings
   (which sit at about one bf16 ulp of the largest values, where the twin
   rounds too) and below the third.
2. K5 in bf16, drop 0.2 and 0, at the flagship with chip_smoke.py's
   layer and bars (``k5_held``) and at the card test's shape with its bar
   (0.02 + 0.02 |ref| on every element): a witness that its tensor-core
   attention differs from an f32 attention by the rounding of P~ and dS
   alone.  K5 runs with its tensor-core attention, and with its attention
   on the f32 kernels (q, k, v, o and dO widened to f32, the results
   rounded to bf16: the numerics of the earlier bf16 SIMT kernels; the
   f32 kernels are 3xTF32, f32-accurate products); each
   is held against the twin that rounds P~ and dS as the tensor cores do
   (the port's) and against a twin that keeps them in f32 (the one before
   the tensor-core kernels, copied here).  It prints each pairing's ratio
   to the bar per result.

With ``--out DIR``, a JSON summary goes to DIR/bf16_bars.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def attention_bf16_arith(q, k, v, seed, *, n_heads, scale, drop):
    """``mha_probs_dropout_plain`` in the inputs' dtype throughout: the
    scores, the softmax, the dropped probs and the output are each
    rounded to bf16 (PyTorch's bf16 products sum in f32)."""
    import torch
    from grounded_video_description_torch.ops.kernels.attention_train import (
        _salts, uniform_hash)
    from grounded_video_description_torch.ops.kernels.encoder_layer import (
        head_slices)
    B, R, D = q.shape
    Rp = -(-R // 128) * 128
    outs = []
    for h, sl in enumerate(head_slices(D, n_heads)):
        p = torch.softmax((q[..., sl] @ k[..., sl].transpose(1, 2))
                          * (1.0 / scale), dim=-1)
        if drop > 0.0:
            u = uniform_hash((Rp, Rp), seed,
                             _salts(B, h, n_heads, q.device))[:, :R, :R]
            p = torch.where(u >= drop, p / (1.0 - drop), 0.0).to(q.dtype)
        outs.append(p @ v[..., sl])
    return torch.cat(outs, dim=-1)


def head_off(t, index, factor=1.05):
    """t with ``t[index]`` (one head) scaled by ``factor``."""
    t = t.clone()
    t[index] *= factor
    return t


def attention_readings(dev, summary):
    import torch
    from chip_smoke import D_RNN, R, scaled_reading
    from grounded_video_description_torch.ops.kernels.attention_train import (
        mha_probs_dropout, mha_probs_dropout_plain)
    from grounded_video_description_torch.ops.kernels.encoder_layer import (
        head_slices)
    from grounded_video_description_torch.ops.kernels.mha import (
        flash_self_attention, flash_self_attention_plain)

    def grads(fn, qkv, w, seed, drop):
        leaves = [t.detach().clone().requires_grad_(True) for t in qkv]
        out = fn(*leaves, seed, n_heads=6, scale=qkv[0].shape[-1] ** 0.5,
                 drop=drop)
        gs = torch.autograd.grad(out, leaves, w)
        return [out.detach()] + list(gs)

    # (name, B, R, D, input seed, dropout seed, drops): chip_smoke's K4
    # phase, then tests/test_torch_cuda.py's K4 shapes
    cases = [("flagship", 30, R, D_RNN, 11, 0x9E3779B9, (0.2, 0.0))] + [
        (f"card D={D}", Bc, 300, D, 5, 0xDEADBEEF, (0.0, 0.3))
        for Bc, D in ((3, 96), (2, 1024), (3, 120))]
    for name, Bc, Rc, D, s_in, s_drop, drops in cases:
        g = torch.Generator(device=dev).manual_seed(s_in)
        base = [torch.randn(Bc, Rc, D, generator=g, device=dev)
                for _ in range(4)]
        qkv = [t.to(torch.bfloat16) for t in base[:3]]
        w = base[3].to(torch.bfloat16)
        seed = torch.tensor([s_drop], device=dev)
        sl0 = head_slices(D, 6)[0]
        for drop in drops:
            ref = grads(mha_probs_dropout_plain, qkv, w, seed, drop)
            got = grads(mha_probs_dropout, qkv, w, seed, drop)
            low = grads(attention_bf16_arith, qkv, w, seed, drop)
            for part, a, lo, r in zip(("out", "dq", "dk", "dv"), got, low,
                                      ref):
                row = dict(kernel=scaled_reading(a, r),
                           bf16_arith=scaled_reading(lo, r),
                           head_off_5pct=scaled_reading(
                               head_off(a, (..., sl0)), r))
                summary.append(dict(of="K4", case=name, drop=drop,
                                    part=part, **row))
                print(f"K4 {name} drop {drop} {part}: max|diff| / max|ref| "
                      + ", ".join(f"{k} {v:.3e}" for k, v in row.items()),
                      flush=True)
            del ref, got, low
        torch.cuda.empty_cache()

    for name, N, Rc, s_in in (("flagship", 600, R, 13), ("card", 4, 300, 9)):
        g = torch.Generator(device=dev).manual_seed(s_in)
        d = -(-D_RNN // 6)
        q, k, v = (torch.randn(N, Rc, d, generator=g, device=dev)
                   for _ in range(3))
        q = q / math.sqrt(D_RNN) if name == "flagship" else q / 32.0
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        ref = flash_self_attention_plain(q, k, v)
        got = flash_self_attention(q, k, v)
        low = torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v
        row = dict(kernel=scaled_reading(got, ref),
                   bf16_arith=scaled_reading(low, ref),
                   head_off_5pct=scaled_reading(head_off(got, 0), ref))
        summary.append(dict(of="K7", case=name, drop=0.0, part="out",
                            **row))
        print(f"K7 {name} out: max|diff| / max|ref| "
              + ", ".join(f"{k} {v:.3e}" for k, v in row.items()),
              flush=True)
        del q, k, v, ref, got, low
        torch.cuda.empty_cache()


def attention_sublayer_f32_probs(x, w, seed, *, n_heads, drop):
    """The twin's attention sublayer as it was before the tensor-core
    kernels: P~ and dS in f32 (only q, k, v and the output rounded)."""
    import torch
    from grounded_video_description_torch.ops.kernels import (
        encoder_layer_train as k5)
    from grounded_video_description_torch.ops.kernels.attention_train import (
        uniform_hash)
    from grounded_video_description_torch.ops.kernels.encoder_layer import (
        head_slices)
    ops = k5._Plain(x, seed, drop)
    dt, R, D = ops.dt, ops.R, ops.D
    Rp = -(-R // 128) * 128
    inv_scale = 1.0 / math.sqrt(D)
    xf = x.float()
    q, k, v = (ops.mm(xf, m).to(dt) for m in (w.wq, w.wk, w.wv))
    heads = []
    for h, sl in enumerate(head_slices(D, n_heads)):
        p = torch.softmax((q[..., sl].float()
                           @ k[..., sl].float().transpose(1, 2)) * inv_scale,
                          dim=-1)
        if drop > 0.0:
            u = uniform_hash((Rp, Rp), seed, k5.SITE_PROBS
                             + ops.rows * k5.SALT_MUL + h)[:, :R, :R]
            p = k5._dropped(p, u, drop)
        heads.append((p @ v[..., sl].float()).to(dt))
    o = torch.cat(heads, dim=-1)
    a = ops.grad_rounded(ops.mm(o, w.wo))
    return ops.ln(xf + ops.resid_drop(a, k5.SITE_RESID1), w.g1, w.be1)


def k5_witness(dev, summary):
    import torch
    from chip_smoke import K5_PARTS, bf16_ratio, k5_held, k5_layer, k5_ties
    from grounded_video_description_torch.ops.kernels import (
        encoder_layer_train as k5)

    real = dict(fwd=k5.attention_forward, bwd=k5.attention_backward,
                twin=k5.attention_sublayer_plain)

    def fwd_f32(q, k, v, seed, **kw):
        out, lse = real["fwd"](q.float(), k.float(), v.float(), seed, **kw)
        return out.to(q.dtype), lse

    def bwd_f32(q, k, v, out, lse, seed, dout, **kw):
        return tuple(t.to(q.dtype) for t in real["bwd"](
            q.float(), k.float(), v.float(), out.float(), lse, seed,
            dout.float(), **kw))

    attentions = {"tensor-core": (real["fwd"], real["bwd"]),
                  "f32": (fwd_f32, bwd_f32)}
    twins = {"rounds P~, dS": real["twin"],
             "f32 P~, dS": attention_sublayer_f32_probs}

    def flagship_bars(got, ref, x, lw, seed, drop, ties):
        res = k5_held(got, ref, "bfloat16", ties)
        return {p: res[p][1] for p in K5_PARTS}

    def card_bar(got, ref, x, lw, seed, drop, ties):
        return {p: bf16_ratio(a, r)[0] for p, a, r in zip(K5_PARTS, got, ref)}

    # chip_smoke's K5 phase with its bars, then tests/test_torch_cuda.py's
    # K5 test with its bar (0.02 + 0.02 |ref| on every element)
    cases = (("flagship", k5_layer(dev), flagship_bars),
             ("card", k5_card_layer(dev), card_bar))
    try:
        for case, (enc, x0, cot, seed), bars in cases:
            lw = enc.layers[0].weights()
            x, w = x0.to(torch.bfloat16), cot.to(torch.bfloat16)
            for drop in (0.2, 0.0):

                def run(fn):
                    xl = x.clone().requires_grad_(True)
                    out = fn(xl, lw, seed, n_heads=6, drop=drop)
                    return [out.detach()] + list(torch.autograd.grad(
                        out, [xl] + list(lw), w))

                for a_name, (fa, ba) in attentions.items():
                    k5.attention_forward, k5.attention_backward = fa, ba
                    got = run(k5.fused_encoder_layer_train)
                    for t_name, twin in twins.items():
                        k5.attention_sublayer_plain = twin
                        ref = run(k5.fused_encoder_layer_train_plain)
                        ties = k5_ties(x, lw, seed, drop)
                        ratios = bars(got, ref, x, lw, seed, drop, ties)
                        worst = max(ratios, key=ratios.get)
                        summary.append(dict(
                            of="K5", case=case, drop=drop, attention=a_name,
                            twin=t_name, tie_tokens=int(ties[0].sum()),
                            ratios=ratios))
                        print(f"K5 {case} bf16 drop {drop}, {a_name} "
                              f"attention vs the twin with {t_name}: ReLU "
                              f"ties {int(ties[0].sum())} tokens; worst "
                              f"ratio to the bar {ratios[worst]:.3f} "
                              f"({worst}); " + ", ".join(
                                  f"{p} {r:.3f}" for p, r in ratios.items()),
                              flush=True)
                        del ref
                    del got
                    torch.cuda.empty_cache()
    finally:
        k5.attention_forward, k5.attention_backward = real["fwd"], real["bwd"]
        k5.attention_sublayer_plain = real["twin"]


def k5_card_layer(dev):
    """tests/test_torch_cuda.py's K5 inputs (``_k5_setup``): R = 300,
    D = 96 in six heads of 16, FFN 48, B = 3, LayerNorm affines away from
    1 and 0, a random output cotangent, the test's dropout seed."""
    import torch
    from grounded_video_description_torch.models.transformer import Encoder
    g = torch.Generator().manual_seed(21)
    enc = Encoder(96, 48, 1)
    enc.reset_parameters(g)
    with torch.no_grad():
        for ln in (enc.layers[0].selfattn.layernorm,
                   enc.layers[0].feedforward.layernorm):
            ln.gamma.add_(0.2 * torch.randn(96, generator=g))
            ln.beta.add_(0.2 * torch.randn(96, generator=g))
    x = torch.randn(3, 300, 96, generator=g).to(dev)
    w = torch.randn(3, 300, 96, generator=g).to(dev)
    return enc.to(dev), x, w, torch.tensor([0xDEADBEEF], device=dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="a directory for the JSON summary")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bf16_bars: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import ATTN_BF16_TOL
    from grounded_video_description_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.lib()
    summary = []
    attention_readings(dev, summary)
    k5_witness(dev, summary)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "bf16_bars.json"), "w") as f:
            json.dump(dict(device=smi, attn_bf16_tol=ATTN_BF16_TOL,
                           readings=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
