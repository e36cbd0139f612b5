#!/usr/bin/env python3
"""Drive the PyTorch port's greedy captioning, its evaluation entry point
and its supervised train step on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It refuses to run without a CUDA device.  It builds the port's CUDA
kernels from ``grounded_video_description_torch/csrc``, holds each kernel
against its plain PyTorch version at the flagship shapes in float32 and
bfloat16 (K4, the training attention, with its gradients and at dropout
0.2 and 0; K6, the whole greedy decode, on the banks of one encoded
batch), then runs ``GVDModel.sample_greedy`` at the flagship
configuration (bench.py's: vocab 4905, 431 detector classes,
obj_interact, BiGRU, mix region attention; batch 100, 1000 ROIs, 480
frames, 20 tokens; random weights from a seeded generator) once through
the kernels and once on the plain path, and compares the two.  Then the
evaluator at the same configuration with the README's eval flags
(``Evaluator.evaluate`` and ``eval_grounding_gt`` over two batches of
100, the reference files made from the batches in a temporary directory)
through K6, K7, K2 and K3 (K1 off by the grounding guard) and on the
plain path, in f32 and bf16.  Last it runs ``Trainer.train_step`` at the
README's training flags (batch 240 in 8 microbatches, w_att2 0.05, w_cls
0.1, Adam at 5e-4, clip 0.1): in f32 with every dropout rate 0, one step
through K4 against one on the plain attention; in bf16 at the flagship
dropout rates, three timed steps on each path.  Any failed check ends
the run with a non-zero exit.

Output: human-readable lines, then the card's name and power limit, then
one JSON line with each kernel's launches on the main path, its error
against the plain version and both times, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B, R, T_FRAMES, H_ATT, D_RNN = 100, 1000, 480, 512, 1024


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, iters: int) -> float:
    """Median device time of ``fn`` in ms over ``iters`` runs, after
    one warm-up run, with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_bf16(got, ref, what: str) -> float:
    """Hold a bf16 result to 0.02 + 0.02 |ref| per element and return the
    max abs error.  The bar grows with the value because one bf16 ulp is
    up to 2**-7 of it (0.0625 at |x| in [8, 16)); at |ref| <= 4 it is at
    most 0.1, the JAX package's own bf16 bar on unit-scale outputs
    (tests/test_pallas.py)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    ratio = diff / (0.02 + 0.02 * r.abs())
    i = int(ratio.argmax())
    check(float(ratio.flatten()[i]) <= 1.0,
          f"{what}: |diff| {float(diff.flatten()[i])} at |ref| "
          f"{float(r.abs().flatten()[i])} over 0.02 + 0.02 |ref|")
    return float(diff.max())


def flagship():
    """The flagship inference configuration (bench.py's) and its random
    weights from a seeded generator, shared by the phases that run the
    model."""
    import torch
    from grounded_video_description_torch.config import GVDConfig
    from grounded_video_description_torch.models import GVDModel
    base = GVDConfig(vocab_size=4905, detect_size=431, seq_per_img=1,
                     drop_prob_lm=0.5, obj_interact=True, use_pallas=True,
                     use_pallas_rnn=True, use_pallas_encoder=True).validate()
    t0 = time.perf_counter()
    state = GVDModel(base).init(torch.Generator().manual_seed(0)).state_dict()
    print(f"flagship weights {time.perf_counter() - t0:.1f} s", flush=True)
    return base, state


def model_of(cfg, state, dev):
    """A model of ``cfg`` with the weights ``state``, on ``dev``."""
    from grounded_video_description_torch.models import GVDModel
    m = GVDModel(cfg)
    m.load_state_dict(state)
    return m.to(dev).eval()


def phase_region_attention(dev, results):
    """K3 at the decode step's shapes: p_pool (B,R,512), att_h (B,512),
    pool (B,R,1024), one fully masked row."""
    import torch
    from grounded_video_description_torch.ops.kernels.region_attention \
        import fused_region_attention, fused_region_attention_plain

    g = torch.Generator(device=dev).manual_seed(3)
    att_mask = torch.rand(B, R, generator=g, device=dev) < 0.2
    pnt_mask = att_mask | (torch.rand(B, R, generator=g, device=dev) < 0.2)
    att_mask[0] = True                       # a fully masked row
    pnt_mask[0] = True
    base = dict(
        p_pool=torch.randn(B, R, H_ATT, generator=g, device=dev),
        att_h=torch.randn(B, H_ATT, generator=g, device=dev),
        pool=torch.randn(B, R, D_RNN, generator=g, device=dev))
    alpha_w = torch.randn(1, H_ATT, generator=g, device=dev) * 0.05
    alpha_b = torch.full((1,), 0.05, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        x = {k: v.to(dt) for k, v in base.items()}
        args = (x["p_pool"], x["att_h"], x["pool"], alpha_w, alpha_b,
                att_mask, pnt_mask)
        res_k, grd_k = fused_region_attention(*args)
        res_p, grd_p = fused_region_attention_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(res_k).all()), "K3 att_res not finite")
        check(bool((grd_k[0].float() <= -1e7).all()),
              "K3 masked row logits not MIN_VALUE")
        if dt == torch.float32:
            e_res, e_grd = max_err(res_k, res_p), max_err(grd_k, grd_p)
            # f32 sums of 512 tanh terms and of 1000 weighted rows, in a
            # different order than the plain version: ~1e-6 expected
            check(e_res <= 1e-4, f"K3 f32 att_res err {e_res}")
            check(e_grd <= 1e-3, f"K3 f32 grd err {e_grd}")
        else:
            e_res = check_bf16(res_k, res_p, "K3 bf16 att_res")
            e_grd = check_bf16(grd_k, grd_p, "K3 bf16 grd")
        ms = time_ms(lambda: fused_region_attention(*args), 20)
        plain_ms = time_ms(lambda: fused_region_attention_plain(*args), 20)
        name = str(dt).replace("torch.", "")
        print(f"K3 region_attention {name}: att_res err {e_res:.3e} "
              f"grd err {e_grd:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms", flush=True)
        results[("region_attention", name)] = dict(
            max_abs_err=max(e_res, e_grd), ms=ms, plain_ms=plain_ms)


def phase_birnn(dev, results):
    """K2 at the temporal encoder's shapes: T=480 steps, B=100, H=512,
    both lanes; GRU and LSTM."""
    import torch
    from grounded_video_description_torch.ops.kernels.birnn import (
        birnn_recurrence, birnn_recurrence_plain)

    g = torch.Generator(device=dev).manual_seed(5)
    H = D_RNN // 2
    bound = 1.0 / H ** 0.5
    for mode, n_gates in (("bigru", 3), ("bilstm", 4)):
        G = n_gates * H
        gi0 = torch.randn(T_FRAMES, 2, B, G, generator=g, device=dev) * 0.5
        wh0 = (torch.rand(2, H, G, generator=g, device=dev) * 2 - 1) * bound
        bh0 = (torch.rand(2, G, generator=g, device=dev) * 2 - 1) * bound
        for dt in (torch.float32, torch.bfloat16):
            gi, wh = gi0.to(dt), wh0.to(dt)
            bh = bh0.to(dt) if mode == "bigru" else None
            kw = dict(mode=mode, hidden=H)
            ys_k = birnn_recurrence(gi, wh, bh, **kw)
            ys_p = birnn_recurrence_plain(gi, wh, bh, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(ys_k).all()), f"K2 {mode} not finite")
            if dt == torch.float32:
                err = max_err(ys_k, ys_p)
                # both carry h in f32 and the step is contractive, so 480
                # steps of ~1e-7 rounding stay far below 1e-4
                check(err <= 1e-4, f"K2 {mode} f32 err {err}")
            else:
                err = check_bf16(ys_k, ys_p, f"K2 {mode} bf16")
            name = str(dt).replace("torch.", "")
            ms = time_ms(lambda: birnn_recurrence(gi, wh, bh, **kw), 5)
            plain_ms = time_ms(lambda: birnn_recurrence_plain(
                gi, wh, bh, **kw), 3)
            print(f"K2 birnn_recurrence {mode} {name}: err {err:.3e}; "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
            results[(f"birnn_recurrence_{mode}", name)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_encoder_layer(dev, results):
    """K1 at the obj_interact shapes: (B, R, D) = (100, 1000, 1024),
    6 uneven heads, FFN 512, two layers."""
    import torch
    import torch.nn.functional as F
    from grounded_video_description_torch.models.transformer import (
        Encoder, encoder_apply)
    from grounded_video_description_torch.ops.kernels.encoder_layer import (
        _gemm, fused_encoder_layer, fused_encoder_layer_plain)

    g = torch.Generator().manual_seed(7)
    enc = Encoder(D_RNN, D_RNN // 2, 2)
    enc.reset_parameters(g)
    with torch.no_grad():          # non-trivial LayerNorm affines
        for lp in enc.layers:
            for ln in (lp.selfattn.layernorm, lp.feedforward.layernorm):
                ln.gamma.add_(0.1 * torch.randn(D_RNN, generator=g))
                ln.beta.add_(0.1 * torch.randn(D_RNN, generator=g))
    enc = enc.to(dev)
    weights = [lp.weights() for lp in enc.layers]
    x0 = torch.relu(torch.randn(B, R, D_RNN, generator=g)).to(dev)
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            # K1's GEMM alone at the QKV shape (M, N, K) = (B*R, 3D, D)
            a = x0.reshape(B * R, D_RNN).to(dt)
            w0 = weights[0]
            wqkv = torch.cat([w0.wq, w0.wk, w0.wv]).to(dt).contiguous()
            c_k = _gemm(a, wqkv, None, relu=False)
            c_p = (a.float() @ wqkv.float().t()).to(dt)
            torch.cuda.synchronize()
            e_gemm = max_err(c_k, c_p)
            if dt == torch.float32:
                # sums of 1024 products of O(0.1) in another order: ~1e-6
                check(e_gemm <= 1e-4, f"K1 f32 GEMM err {e_gemm}")
            else:
                # both sums are f32, rounded once to bf16: at most one bf16
                # ulp of the reference apart, with values below 2**-6 held
                # to the ulp at 2**-6 (1.2e-4) to cover the f32 summation
                # order where the sum cancels
                _, ex = torch.frexp(c_p.float().abs().clamp_min(2.0 ** -6))
                ulp = torch.ldexp(torch.ones_like(c_p, dtype=torch.float32),
                                  ex - 8)
                over = (c_k.float() - c_p.float()).abs() - ulp
                check(float(over.max()) <= 0.0,
                      f"K1 bf16 GEMM off by more than one ulp: {e_gemm}")
            gemm_ms = time_ms(lambda: _gemm(a, wqkv, None, relu=False), 5)
            lib_ms = time_ms(lambda: F.linear(a, wqkv), 5)
            print(f"K1 GEMM {name} (100000 x 3072 x 1024): err "
                  f"{e_gemm:.3e}; kernel {gemm_ms:.3f} ms, cuBLAS "
                  f"{lib_ms:.3f} ms", flush=True)
            del a, c_k, c_p

            x = x0.to(dt)
            errs = []
            for w in weights:      # each layer from the same input
                y_k = fused_encoder_layer(x, w, n_heads=6)
                y_p = fused_encoder_layer_plain(x, w, n_heads=6)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(y_k).all()), "K1 not finite")
                if dt == torch.float32:
                    # the layer ends in a LayerNorm (unit-scale output); its
                    # sums of 1024-wide products in another order: ~1e-5
                    errs.append(max_err(y_k, y_p))
                    check(errs[-1] <= 1e-3, f"K1 f32 layer err {errs[-1]}")
                else:
                    errs.append(check_bf16(y_k, y_p, "K1 bf16 layer"))
                x = y_p
            xin = x0.to(dt)
            ms = time_ms(lambda: encoder_apply(enc, xin, n_heads=6,
                                               use_kernel=True), 3)
            plain_ms = time_ms(lambda: encoder_apply(enc, xin, n_heads=6),
                               3)
            print(f"K1 encoder_layer x2 {name}: per-layer err "
                  f"{[f'{e:.3e}' for e in errs]}; kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms", flush=True)
            results[("encoder_layer", name)] = dict(
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)


def phase_attention_train(dev, results):
    """K4 at the obj_interact training shapes: q/k/v (30, 1000, 1024) in
    6 uneven heads, the microbatch of batch 240 in 8; f32 and bf16, drop
    0.2 (the flagship's enc_drop) and 0.  The kernel's output and its
    q/k/v gradients against the plain twin's autograd on the same seed,
    and both passes timed alone."""
    import torch
    from grounded_video_description_torch.ops.kernels.attention_train \
        import mha_probs_dropout, mha_probs_dropout_plain

    Bm, heads = 30, 6
    g = torch.Generator(device=dev).manual_seed(11)
    base = [torch.randn(Bm, R, D_RNN, generator=g, device=dev)
            for _ in range(4)]
    seed = torch.tensor([0x9E3779B9], device=dev)
    kw = dict(n_heads=heads, scale=D_RNN ** 0.5)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        for drop in (0.2, 0.0):
            q, k, v, w = (t.to(dt) for t in base)
            runs = {}
            for which, fn in (("kernel", mha_probs_dropout),
                              ("plain", mha_probs_dropout_plain)):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                out = fn(*leaves, seed, drop=drop, **kw)
                grads = torch.autograd.grad(out, leaves, w,
                                            retain_graph=True)
                torch.cuda.synchronize()
                fwd_ms = time_ms(lambda: fn(*leaves, seed, drop=drop, **kw),
                                 5)
                bwd_ms = time_ms(lambda: torch.autograd.grad(
                    out, leaves, w, retain_graph=True), 5)
                runs[which] = ([out.detach()] + list(grads), fwd_ms, bwd_ms)
                del out, grads, leaves
            (got, k_fwd, k_bwd), (ref, p_fwd, p_bwd) = (runs["kernel"],
                                                         runs["plain"])
            errs = {}
            for part, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
                check(bool(torch.isfinite(a.float()).all()),
                      f"K4 {name} drop {drop} {part} not finite")
                if dt == torch.float32:
                    # f32 sums over 1000 keys or queries in another
                    # order: ~1e-6 expected
                    errs[part] = max_err(a, b)
                    check(errs[part] <= 1e-4,
                          f"K4 f32 drop {drop} {part} err {errs[part]}")
                else:
                    errs[part] = check_bf16(a, b, f"K4 bf16 drop {drop} {part}")
            print(f"K4 attention_train {name} drop {drop}: err "
                  f"{ {p: f'{e:.3e}' for p, e in errs.items()} }; forward "
                  f"kernel {k_fwd:.3f} ms, plain {p_fwd:.3f} ms; backward "
                  f"kernel {k_bwd:.3f} ms, plain {p_bwd:.3f} ms", flush=True)
            if drop > 0:
                results[("attention_train_fwd", name)] = dict(
                    max_abs_err=errs["out"], ms=k_fwd, plain_ms=p_fwd)
                results[("attention_train_bwd", name)] = dict(
                    max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]),
                    ms=k_bwd, plain_ms=p_bwd)
            del got, ref
            torch.cuda.empty_cache()


def phase_train(dev):
    """Trainer.train_step at the flagship training configuration, through
    K4 ("pallas") and on the plain attention ("xla").  Returns the K4
    launch counts of the bf16 kernel run's three timed steps."""
    import torch
    from grounded_video_description_torch.config import GVDConfig
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.engine.trainer import (
        Trainer, batch_to_device)
    from grounded_video_description_torch.models import GVDModel
    from grounded_video_description_torch.ops.kernels import _build

    BT, ACCUM = 240, 8
    base = GVDConfig(vocab_size=4905, detect_size=431, obj_interact=True,
                     batch_size=BT, grad_accum=ACCUM, w_att2=0.05,
                     w_cls=0.1, drop_prob_lm=0.5, enc_drop=0.2,
                     learning_rate=5e-4, grad_clip=0.1,
                     use_pallas=False).validate()
    t0 = time.perf_counter()
    state = GVDModel(base).init(torch.Generator().manual_seed(0)).state_dict()
    batch = synthetic_batch(base, BT, seed=0)
    print(f"train set-up (weights + batch) {time.perf_counter() - t0:.1f} s",
          flush=True)
    terms = ("loss", "lm_loss", "att2_loss", "ground_loss", "cls_loss")
    per_step = {"attention_train_fwd": 2 * ACCUM,   # 2 layers x 8
                "attention_train_bwd": 2 * ACCUM}

    def trainer_for(cfg):
        model = GVDModel(cfg)
        model.load_state_dict(state)
        return Trainer(cfg, model.to(dev))

    # (a) f32, every dropout rate 0: K4 against the plain attention
    stats = {}
    for impl in ("pallas", "xla"):
        cfg = base.replace(attn_train_impl=impl, drop_prob_lm=0.0,
                           loc_drop=0.0, enc_drop=0.0)
        tr = trainer_for(cfg)
        m = tr.train_step(batch_to_device(cfg, batch, dev),
                          cfg.learning_rate)
        stats[impl] = {k: float(v) for k, v in m.items()}
        del tr
        torch.cuda.empty_cache()
    for k in terms:
        a, b = stats["pallas"][k], stats["xla"][k]
        check(abs(a - b) <= 1e-4 * abs(b), f"f32 step {k}: K4 {a} vs {b}")
    a, b = stats["pallas"]["grad_norm"], stats["xla"]["grad_norm"]
    check(abs(a - b) <= 1e-3 * abs(b), f"f32 step grad norm: K4 {a} vs {b}")
    print("train f32 drop 0, K4 vs plain attention: "
          + ", ".join(f"{k} {stats['pallas'][k]:.6f} / {stats['xla'][k]:.6f}"
                      for k in terms + ("grad_norm",)), flush=True)

    # (b) bf16 at the flagship dropout rates: three timed steps each
    launches, rates = None, {}
    for impl in ("pallas", "xla"):
        cfg = base.replace(attn_train_impl=impl, dtype="bfloat16")
        tr = trainer_for(cfg)
        dev_batch = batch_to_device(cfg, batch, dev)
        tr.train_step(dev_batch, cfg.learning_rate)          # warm-up
        torch.cuda.synchronize()
        counts, times = {}, []
        for step in range(3):
            _build.reset_launches()
            t0 = time.perf_counter()
            m = tr.train_step(dev_batch, cfg.learning_rate)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = dict(_build.launches)
            expect = per_step if impl == "pallas" else {}
            check(got == expect, f"bf16 {impl} step launches {got} != "
                  f"{expect}")
            for name, n in got.items():
                counts[name] = counts.get(name, 0) + n
            losses = {k: float(v) for k, v in m.items()}
            check(all(math.isfinite(v) for v in losses.values()),
                  f"bf16 {impl} step {step} losses {losses}")
            print(f"train bf16 {impl} step {step}: " + ", ".join(
                f"{k} {v:.5f}" for k, v in losses.items())
                + f"; {times[-1]:.3f} s", flush=True)
        rates[impl] = BT / statistics.median(times)
        if impl == "pallas":
            launches = counts
        del tr, dev_batch
        torch.cuda.empty_cache()
    print(f"train bf16 segments/s (median of 3 steps): K4 "
          f"{rates['pallas']:.2f}, plain attention {rates['xla']:.2f}",
          flush=True)
    return launches


def phase_end_to_end(dev, base, state):
    """sample_greedy at the flagship configuration, through the kernels
    and on the plain path.  Returns the launch counts of the f32 kernel
    run."""
    import torch
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.models import batch_to_tensors
    from grounded_video_description_torch.ops.kernels import _build

    batch = batch_to_tensors(synthetic_batch(base, B, seed=0), dev)

    def model_for(dtype: str, kernels: bool):
        return model_of(base.replace(dtype=dtype, use_pallas=kernels,
                                     use_pallas_rnn=kernels,
                                     use_pallas_encoder=kernels), state, dev)

    launches = None
    for dtype in ("float32", "bfloat16"):
        outs, rates = {}, {}
        for kernels in (True, False):
            m = model_for(dtype, kernels)
            _build.reset_launches()
            out = m.sample_greedy(batch)
            torch.cuda.synchronize()
            counts = dict(_build.launches)
            if kernels:
                # K2: 2 BiGRU layers per encode; K1: 2 layers; K3: 20 steps
                expect = {"birnn_recurrence": 2, "encoder_layer": 2,
                          "region_attention": base.seq_length}
                check(counts == expect,
                      f"{dtype} kernel run launches {counts} != {expect}")
                if dtype == "float32":
                    launches = counts
            else:
                check(not counts, f"plain run launched kernels: {counts}")
            for name, t in zip(("seq", "logprobs", "att2", "sim_mat"), out):
                check(bool(torch.isfinite(t.float()).all()),
                      f"{dtype} kernels={kernels} {name} not finite")
            check(tuple(out[0].shape) == (B, base.seq_length),
                  f"seq shape {tuple(out[0].shape)}")
            check(tuple(out[2].shape) == (B, base.seq_length, R),
                  f"att2 shape {tuple(out[2].shape)}")
            outs[kernels] = out
            sec = time_ms(lambda: m.sample_greedy(batch), 3) / 1e3
            rates[kernels] = B / sec
            del m
            torch.cuda.empty_cache()
        agree = float((outs[True][0] == outs[False][0]).float().mean())
        lp0 = max_err(outs[True][1][:, 0], outs[False][1][:, 0])
        print(f"e2e {dtype}: token agreement {agree:.4f}, step-0 logprob "
              f"err {lp0:.3e}; greedy captions/s kernels "
              f"{rates[True]:.2f}, plain {rates[False]:.2f}", flush=True)
        if dtype == "float32":
            check(agree >= 0.99, f"f32 token agreement {agree}")
            check(lp0 <= 1e-3, f"f32 step-0 logprob err {lp0}")
    return launches


def phase_decode_kernel(dev, results, base, state):
    """K6 at the flagship shapes: the banks of one encoded batch of B
    (T = 480 frames, R = 1000 ROIs, a random fifth of them under the pnt
    mask), 20 steps, vocab 4905; the kernel against its plain twin (the
    step loop, K3 off) on the same banks, in f32 and bf16."""
    import torch
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.models import batch_to_tensors
    from grounded_video_description_torch.ops.kernels.decode_scan import (
        greedy_decode_fused, greedy_decode_fused_plain)

    batch = batch_to_tensors(synthetic_batch(base, B, seed=0), dev)
    g = torch.Generator(device=dev).manual_seed(17)
    pnt = batch["pnt_mask"].bool().clone()
    pnt[:, 1:] |= torch.rand(B, R, generator=g, device=dev) < 0.2
    L = base.seq_length
    for dt in ("float32", "bfloat16"):
        m = model_of(base.replace(dtype=dt, use_pallas=False), state, dev)
        with torch.no_grad():
            enc = m.encode(batch)
            got = greedy_decode_fused(m, enc, pnt)
            ref = greedy_decode_fused_plain(m, enc, pnt)
            torch.cuda.synchronize()
            for name, a, b in zip(("seq", "logprobs", "att2"), got, ref):
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"K6 {dt} {name}: {a.dtype} {tuple(a.shape)} vs "
                      f"{b.dtype} {tuple(b.shape)}")
                check(bool(torch.isfinite(a.float()).all()),
                      f"K6 {dt} {name} not finite")
            (seq_k, lp_k, a_k), (seq_p, lp_p, a_p) = got, ref
            same = seq_k == seq_p
            agree = float(same.float().mean())
            masked = pnt[:, None, 1:].expand(B, L, R)
            for side, a in (("kernel", a_k), ("plain", a_p)):
                check(bool((a[masked].float() < -1e7).all()),
                      f"K6 {dt} {side}: a masked grounding logit >= -1e7")
            if dt == "float32":
                # a step's logprob is compared where the tokens agree up to
                # it, its grounding logits where they agree before it
                upto = same.int().cumprod(dim=1).bool()
                before = torch.cat([torch.ones_like(upto[:, :1]),
                                    upto[:, :-1]], dim=1)
                live = before[..., None] & ~masked
                e_lp = max_err(lp_k[upto], lp_p[upto])
                e_grd = max_err(a_k[live], a_p[live])
                # f32 sums of 1024-wide products and softmaxes over 480 and
                # 1000 in another order: ~1e-6 expected
                check(agree >= 0.99, f"K6 f32 token agreement {agree}")
                check(e_lp <= 1e-3, f"K6 f32 logprob err {e_lp}")
                check(e_grd <= 1e-3, f"K6 f32 grounding logit err {e_grd}")
            else:
                e_lp = check_bf16(lp_k[:, 0], lp_p[:, 0], "K6 bf16 step-0 "
                                  "logprob")
                e_grd = check_bf16(a_k[:, 0], a_p[:, 0], "K6 bf16 step-0 "
                                   "grounding logits")
            ms = time_ms(lambda: greedy_decode_fused(m, enc, pnt), 5)
            plain_ms = time_ms(lambda: greedy_decode_fused_plain(m, enc, pnt),
                               3)
        print(f"K6 decode_scan {dt}: token agreement {agree:.4f}, logprob "
              f"err {e_lp:.3e}, grounding logit err {e_grd:.3e}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        results[("decode_scan", dt)] = dict(
            max_abs_err=max(e_lp, e_grd), ms=ms, plain_ms=plain_ms)
        del m, enc, got, ref
        torch.cuda.empty_cache()


def phase_flash_mha(dev, results):
    """K7 at the obj_interact inference shapes: q/k/v (B * 6, R, 171), the
    six heads of 1024 zero-padded to 171 each, q pre-scaled by
    1/sqrt(1024); f32 and bf16."""
    import torch
    from grounded_video_description_torch.ops.kernels.mha import (
        flash_self_attention, flash_self_attention_plain)

    N, d = B * 6, -(-D_RNN // 6)
    g = torch.Generator(device=dev).manual_seed(13)
    base = [torch.randn(N, R, d, generator=g, device=dev) for _ in range(3)]
    base[0] /= math.sqrt(D_RNN)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        q, k, v = (t.to(dt) for t in base)
        got = flash_self_attention(q, k, v)
        ref = flash_self_attention_plain(q, k, v)
        torch.cuda.synchronize()
        check(got.dtype == dt and got.shape == (N, R, d), "K7 output")
        check(bool(torch.isfinite(got.float()).all()), "K7 not finite")
        if dt == torch.float32:
            err = max_err(got, ref)
            # softmax-weighted means of unit-scale rows over 1000 keys, in
            # f32 in another order: ~1e-7 expected
            check(err <= 1e-5, f"K7 f32 err {err}")
        else:
            err = check_bf16(got, ref, "K7 bf16")
        ms = time_ms(lambda: flash_self_attention(q, k, v), 5)
        plain_ms = time_ms(lambda: flash_self_attention_plain(q, k, v), 5)
        print(f"K7 flash_self_attention {name} ({N} x {R} x {d}): err "
              f"{err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms",
              flush=True)
        results[("flash_self_attention", name)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del got, ref, q, k, v
    torch.cuda.empty_cache()


def eval_vocab(cfg):
    """A synthetic dic_anet.json of the flagship's sizes: words w1 ..
    w4903 and UNK (ids 1 .. 4904), the first 431 words the detection
    classes, every word its own lemma."""
    from grounded_video_description_torch.data.vocab import VocabTables
    words = [f"w{i}" for i in range(1, cfg.vocab_size - 1)] + ["UNK"]
    return VocabTables({
        "ix_to_word": {str(i + 1): w for i, w in enumerate(words)},
        "wtod": {w: i for i, w in enumerate(words[:cfg.detect_size])},
        "wtol": {w: w for w in words}})


def eval_references(root, cfg, vocab, batches):
    """The files the evaluator reads, made from the batches: the grounding
    reference (timestamps and, per GT box, its class, frame, box and word
    position), the split file and one densecap reference (the GT
    captions).  Returns the config fields that name them."""
    ann, dense = {}, {}
    for batch in batches:
        for b, seg_id in enumerate(batch["seg_id"]):
            vid, seg = seg_id.split("_segment_")
            seg = str(int(seg))
            iseq = batch["input_seq"][b, 0, 1:]
            objs = [(j, int(iseq[j, 0]) - cfg.vocab_size)
                    for j in range(iseq.shape[0])
                    if iseq[j, 0] > cfg.vocab_size]
            boxes = {int(box[5]): box for box in batch["gt_boxes"][b][::-1]
                     if box[5] > 0}
            ts = [float(b), float(b) + 10.0]
            ann.setdefault(vid, {"segments": {}})["segments"][seg] = {
                "timestamps": ts,
                "process_clss": [vocab.itod[c] for _, c in objs],
                "frame_ind": [int(boxes[c][4]) for _, c in objs],
                "process_bnd_box": [boxes[c][:4].tolist() for _, c in objs],
                "process_idx": [j for j, _ in objs]}
            words = [vocab.itow[str(int(w))] for w in batch["gt_seq"][b, 0]
                     if w > 0]
            d = dense.setdefault(vid, {"duration": 200.0, "timestamps": [],
                                       "sentences": []})
            d["timestamps"].append(ts)
            d["sentences"].append(" ".join(words))
    paths = {}
    for key, obj in (("grd_reference", {"annotations": ann}),
                     ("split_file", {"validation": sorted(ann)}),
                     ("densecap_reference", dense)):
        paths[key] = os.path.join(root, f"{key}.json")
        with open(paths[key], "w") as f:
            json.dump(obj, f)
    return {"grd_reference": paths["grd_reference"],
            "split_file": paths["split_file"],
            "densecap_references": [paths["densecap_reference"]],
            "data_path": root}


def phase_eval(dev, base, state):
    """The evaluation entry point at the flagship configuration with the
    README's eval flags (language_eval, eval_obj_grounding,
    eval_obj_grounding_gt; the port has no training loop to skip, so no
    inference_only) and the grounding guard on:
    ``Evaluator.evaluate`` and ``Evaluator.eval_grounding_gt`` over two
    batches of B, through the kernels (K6, K7, K2, K3; K1 off by the
    guard) and with every kernel flag off, in f32 and bf16.  Returns the
    launch counts of the f32 kernel run."""
    import tempfile
    import torch
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.engine.evaluator import (
        Evaluator, grounding_eval_cfg)
    from grounded_video_description_torch.ops.kernels import _build

    vocab = eval_vocab(base)
    batches = []
    for i in range(2):
        batch = synthetic_batch(base, B, seed=i)
        batch["seg_id"] = [f"v_EVAL{i * B + b:04d}_segment_{b % 3:02d}"
                           for b in range(B)]
        batch["n_valid"] = B
        batches.append(batch)
    seg_ids = [s for batch in batches for s in batch["seg_id"]]
    vids = {s.split("_segment_")[0] for s in seg_ids}
    per_batch = {"evaluate": {"decode_scan": 1, "flash_self_attention": 2,
                              "birnn_recurrence": 2},
                 "grounding_gt": {"flash_self_attention": 2,
                                  "region_attention": base.seq_length,
                                  "birnn_recurrence": 2}}

    def counted(counts):
        """The batches, with the launch counts of each batch's work."""
        for batch in batches:
            _build.reset_launches()
            yield batch
            counts.append(dict(_build.launches))

    launches = None
    with tempfile.TemporaryDirectory() as root:
        cfg0 = grounding_eval_cfg(base.replace(
            language_eval=True, eval_obj_grounding=True,
            eval_obj_grounding_gt=True, use_pallas_encoder=True,
            pallas_encoder_grounding_guard=True, id="smoke",
            **eval_references(root, base, vocab, batches)))
        check(not cfg0.use_pallas_encoder, "the grounding guard left K1 on")
        for dtype in ("float32", "bfloat16"):
            runs = {}
            for kernels in (True, False):
                flags = dict(use_pallas=kernels, use_pallas_rnn=kernels,
                             use_pallas_decode=kernels, use_pallas_mha=kernels)
                m = model_of(cfg0.replace(dtype=dtype, **flags), state, dev)
                ev = Evaluator(m.cfg, m, vocab)
                gen, grd = [], []
                generate, forward = ev.generate, m.forward

                def recorded_generate(arrays):
                    out = generate(arrays)
                    gen.append(out)
                    return out

                def recorded_forward(batch, **kw):
                    out = forward(batch, **kw)
                    grd.append({k: out[k].cpu() for k in ("att2_ind",
                                                          "grd_ind")})
                    return out

                ev.generate, m.forward = recorded_generate, recorded_forward
                warm = {k: v for k, v in batches[0].items()
                        if k not in ("seg_id", "n_valid")}
                generate(warm)                       # warm-up, not counted
                torch.cuda.synchronize()
                out_dir = os.path.join(root, f"{dtype}-{kernels}")
                counts = {"evaluate": [], "grounding_gt": []}
                stats = ev.evaluate(counted(counts["evaluate"]),
                                    out_dir=out_dir)
                rate = stats["captions_per_sec"]
                stats.update(ev.eval_grounding_gt(
                    counted(counts["grounding_gt"]), out_dir=out_dir))
                for call, got in counts.items():
                    want = per_batch[call] if kernels else {}
                    check(got == [want] * len(batches),
                          f"{dtype} kernels={kernels} {call} launches per "
                          f"batch {got} != {want}")
                if kernels and dtype == "float32":
                    launches = {}
                    for got in counts.values():
                        for c in got:
                            for k, n in c.items():
                                launches[k] = launches.get(k, 0) + n
                for k, v in stats.items():
                    check(isinstance(v, str) or math.isfinite(v),
                          f"{dtype} kernels={kernels} stat {k} = {v}")
                for key in ("CIDEr", "Bleu_4", "box_accu_att", "box_accu_grd",
                            "cls_accu", "grd_f1_all"):
                    check(key in stats, f"stat {key} missing")
                check_eval_files(out_dir, m.cfg, seg_ids, vids)
                runs[kernels] = (gen, grd, rate, stats)
                print(f"eval {dtype} kernels={kernels}: captions/s "
                      f"{rate:.2f}; CIDEr {stats['CIDEr']:.4f}, box_accu_att "
                      f"{stats['box_accu_att']:.4f}, box_accu_grd "
                      f"{stats['box_accu_grd']:.4f}, cls_accu "
                      f"{stats['cls_accu']:.4f}", flush=True)
                del m, ev
                torch.cuda.empty_cache()
            agree = eval_agreement(base, runs[True], runs[False])
            print(f"eval {dtype} kernels vs plain agreement: " + ", ".join(
                f"{k} {v:.4f}" for k, v in agree.items()), flush=True)
            if dtype == "float32":
                for k, v in agree.items():
                    check(v >= 0.99, f"eval f32 {k} agreement {v}")
    return launches


def check_eval_files(out_dir, cfg, seg_ids, vids):
    """The four JSONs parse and hold every segment."""
    tag = f"{cfg.val_split}-{cfg.id}.json"
    with open(os.path.join(out_dir, "densecap_results",
                           f"densecap-{tag}")) as f:
        dense = json.load(f)["results"]
    check(set(dense) == vids
          and sum(len(v) for v in dense.values()) == len(seg_ids),
          "densecap JSON does not hold every segment")
    for kind in ("attn-gen", "attn-gt", "grd-gt"):
        with open(os.path.join(out_dir, "results",
                               f"{kind}-sent-results-{tag}")) as f:
            res = json.load(f)["results"]
        got = {f"{v}_segment_{int(s):02d}" for v in res for s in res[v]}
        check(got == set(seg_ids), f"{kind} JSON does not hold every segment")


def eval_agreement(cfg, kernel_run, plain_run):
    """Shares of equal caption tokens, per-frame argmax ROIs of the
    generated words (att2_ind of evaluate) and GT-sentence att2_ind and
    grd_ind between two evaluator runs."""
    import numpy as np
    frames = (-1, cfg.seq_length, cfg.num_sampled_frm, cfg.num_prop_per_frm)
    out = {}
    for key, get in (
            ("tokens", lambda g, _: g["seq"]),
            ("gen att2_ind",
             lambda g, _: g["att2_weights"].reshape(frames).argmax(-1)),
            ("gt att2_ind", lambda _, r: r["att2_ind"].numpy()),
            ("gt grd_ind", lambda _, r: r["grd_ind"].numpy())):
        a = np.concatenate([get(g, r) for g, r in
                            zip(kernel_run[0], kernel_run[1])])
        b = np.concatenate([get(g, r) for g, r in
                            zip(plain_run[0], plain_run[1])])
        out[key] = float((a == b).mean())
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from grounded_video_description_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"build {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(so, ROOT)}", flush=True)

    results = {}
    phase_region_attention(dev, results)
    phase_birnn(dev, results)
    phase_encoder_layer(dev, results)
    phase_attention_train(dev, results)
    base, state = flagship()
    phase_decode_kernel(dev, results, base, state)
    phase_flash_mha(dev, results)
    launches = phase_end_to_end(dev, base, state)
    # K2 and K3 keep the greedy path's counts; K6 and K7 run on the eval
    for name, n in phase_eval(dev, base, state).items():
        launches.setdefault(name, n)
    launches.update(phase_train(dev))

    rows = [("region_attention", "region_attention",
             "grounded_video_description_torch/csrc/region_attention.cu",
             "grounded_video_description_tpu/ops/pallas/"
             "region_attention.py:128"),
            ("birnn_recurrence", "birnn_recurrence_bigru",
             "grounded_video_description_torch/csrc/birnn.cu",
             "grounded_video_description_tpu/ops/pallas/birnn.py:135"),
            ("encoder_layer", "encoder_layer",
             "grounded_video_description_torch/csrc/encoder_layer.cu",
             "grounded_video_description_tpu/ops/pallas/"
             "encoder_layer.py:184"),
            ("attention_train_fwd", "attention_train_fwd",
             "grounded_video_description_torch/csrc/attention_train.cu",
             "grounded_video_description_tpu/ops/pallas/"
             "attention_train.py:163"),
            ("attention_train_bwd", "attention_train_bwd",
             "grounded_video_description_torch/csrc/attention_train.cu",
             "grounded_video_description_tpu/ops/pallas/"
             "attention_train.py:185"),
            ("decode_scan", "decode_scan",
             "grounded_video_description_torch/csrc/decode_scan.cu",
             "grounded_video_description_tpu/ops/pallas/decode_scan.py:325"),
            ("flash_self_attention", "flash_self_attention",
             "grounded_video_description_torch/csrc/attention_train.cu",
             "grounded_video_description_tpu/ops/pallas/mha.py:70")]
    kernels = []
    for name, key, source, replaces in rows:
        r = results[(key, "float32")]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "dtype": "float32"})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
