#!/usr/bin/env python3
"""Drive the PyTorch port's greedy-captioning path on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It refuses to run without a CUDA device.  It builds the port's CUDA
kernels from ``grounded_video_description_torch/csrc``, holds each kernel
against its plain PyTorch version at the flagship shapes in float32 and
bfloat16, then runs ``GVDModel.sample_greedy`` at the flagship
configuration (bench.py's: vocab 4905, 431 detector classes,
obj_interact, BiGRU, mix region attention; batch 100, 1000 ROIs, 480
frames, 20 tokens; random weights from a seeded generator) once through
the kernels and once on the plain path, and compares the two.  Any failed
check ends the run with a non-zero exit.

Output: human-readable lines, then the card's name and power limit, then
one JSON line with each kernel's launches on the main path, its error
against the plain version and both times, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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


def phase_end_to_end(dev):
    """sample_greedy at the flagship configuration, through the kernels
    and on the plain path.  Returns the launch counts of the f32 kernel
    run."""
    import torch
    from grounded_video_description_torch.config import GVDConfig
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.models import (
        GVDModel, batch_to_tensors)
    from grounded_video_description_torch.ops.kernels import _build

    base = GVDConfig(vocab_size=4905, detect_size=431, seq_per_img=1,
                     drop_prob_lm=0.5, obj_interact=True, use_pallas=True,
                     use_pallas_rnn=True, use_pallas_encoder=True).validate()
    t0 = time.perf_counter()
    state = GVDModel(base).init(torch.Generator().manual_seed(0)).state_dict()
    batch = batch_to_tensors(synthetic_batch(base, B, seed=0), dev)
    print(f"e2e set-up (weights + batch) {time.perf_counter() - t0:.1f} s",
          flush=True)

    def model_for(dtype: str, kernels: bool):
        cfg = base.replace(dtype=dtype, use_pallas=kernels,
                           use_pallas_rnn=kernels,
                           use_pallas_encoder=kernels)
        m = GVDModel(cfg)
        m.load_state_dict(state)
        return m.to(dev).eval()

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
    launches = phase_end_to_end(dev)

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
             "encoder_layer.py:184")]
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
