#!/usr/bin/env python3
"""Drive the PyTorch port's greedy captioning, its evaluation entry point,
its supervised train step and its training driver on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It refuses to run without a CUDA device.  It builds the port's CUDA
kernels from ``grounded_video_description_torch/csrc``, holds each kernel
against its plain PyTorch version at the flagship shapes in float32 and
bfloat16 (K4, the training attention, and K5, the whole obj_interact
training layer, with their gradients and at dropout 0.2 and 0; K6, the
whole greedy decode, on the banks of one encoded batch), each with its
bound and, where one PyTorch call computes the same function, that
call's time, then runs ``GVDModel.sample_greedy`` at the flagship
configuration (bench.py's: vocab 4905, 431 detector classes,
obj_interact, BiGRU, mix region attention; batch 100, 1000 ROIs, 480
frames, 20 tokens; random weights from a seeded generator) once through
the kernels and once on the plain path, and compares the two; then
``GVDModel.sample_beam`` on the same weights and batch at beam widths 3
and 5, in f32 and bf16, through K1 and K2 (its attentions are plain) and
on the plain path.  Then the evaluator at the same configuration with
the README's eval flags (``Evaluator.evaluate`` and
``eval_grounding_gt`` over two batches of 100, the reference files made
from the batches in a temporary directory) through K6, K7, K2 and K3 (K1
off by the grounding guard) and on the plain path, in f32 and bf16, and
``evaluate`` at beam 3 over one batch.  Last it runs
``Trainer.train_step`` at the README's training flags (batch 240 in 8
microbatches, w_att2 0.05, w_cls 0.1, Adam at 5e-4, clip 0.1): in f32
with every dropout rate 0, one step through K5 and one through K4
against one on the plain attention; in bf16 at the flagship dropout
rates, two timed steps on each path, in turns.  Last the training
driver (``grounded_video_description_torch.main.run``): two epochs of one
bf16 step through K5, each validated over one batch of 100, checkpointed
into a temporary directory, then resumed from the latest checkpoint by a
second run.  Then the Masked-Transformer captioner (``att_model``
"transformer", ``phase_transformer``) at the same width: greedy through K1
and K2 against plain, a train step through K5 against the plain
attention, segments/s, the evaluator; and greedy over int8 attention
banks (``quantize_banks``) on the TopDown weights.  Last the data
parallelism of ``grounded_video_description_torch.parallel``
(``phase_data_parallel``): K4 and K5 at a row offset, the train step and
the sharded evaluator on two gloo ranks sharing the card (one process
each) against one device, the same on a model axis (mesh (1, 2): the two
ranks split the padded vocab head), and one epoch of the driver's path on
one NCCL rank.  Then ``utils/params_io.py`` (the flagship model saved in
the JAX tools' npz format and loaded into a fresh model: a greedy decode
gives the same tokens) and ``utils/logging.py::ProfilerHooks`` around one
bf16 train step through K5 (its trace names K5's kernels).  Any failed
check, in this process or in a rank's, ends the run with a non-zero
exit.

Output: human-readable lines, then the card's name and power limit, then
one JSON line with a row per kernel and dtype (f32, bf16): its launches
on the main path in that dtype, its error against the plain version, its
time, its plain version's, its bound and the library call's (K3's rows
also the device time of a call queued back to back, ``queued_ms``; the
K4 rows also the time of the repack that its tensor-core kernels run
first; f32 K4, K5's attention, K7 and K1's attention run in 3xTF32, and
their launches also count that route, ``attention_tf32x3``; K1's rows
also its QKV GEMM's TFLOP/s beside cuBLAS's; K6's rows also the
streaming floor and the split of a decode by phase), and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
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


# H100 SXM, dense: f32 on the SIMT units, bf16 on the tensor cores, and
# f32-accurate products on the tensor cores in 3xTF32 (three TF32 products
# each, at 494.7 TFLOP/s TF32)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 494.7e12 / 3}
PEAK_BYTES = 3.35e12
# the f32 attention's route (K4, K5's attention, K7, K1's attention),
# counted per launch
TF32_ROUTE = "attention_tf32x3"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops, n_bytes: float, dtype: str) -> dict:
    """The least time the card could take for work of ``flops`` operations
    (at the peak rate of ``dtype``: f32 outside the tensor cores, bf16 on
    them, ``tf32x3`` f32 products on them in 3xTF32; or a dict of
    operations per rate, whose times add, for work whose parts depend on
    each other) moving ``n_bytes`` (each input read once, each output
    written once), which of the two bounds it, and the rates that the
    operations were counted at (``bound_rates``)."""
    if not isinstance(flops, dict):
        flops = {dtype: flops}
    t_ops = sum(f / PEAK_FLOPS[rate] for rate, f in flops.items())
    t_bytes = n_bytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_rates="+".join(sorted(flops)))


def attention_rate(name: str) -> str:
    """The peak rate that bounds the attention kernels in dtype ``name``:
    f32 runs them in 3xTF32."""
    return "tf32x3" if name == "float32" else name


def bf16_ratio(got, ref):
    """The largest |got - ref| / (0.02 + 0.02 |ref|) over the elements:
    (that ratio, the diff and the |ref| where it is reached, the max abs
    error)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    ratio = diff / (0.02 + 0.02 * r.abs())
    i = int(ratio.argmax())
    return (float(ratio.flatten()[i]), float(diff.flatten()[i]),
            float(r.abs().flatten()[i]), float(diff.max()))


def check_bf16(got, ref, what: str) -> float:
    """Hold a bf16 result to 0.02 + 0.02 |ref| per element and return the
    max abs error.  The bar grows with the value because one bf16 ulp is
    up to 2**-7 of it (0.0625 at |x| in [8, 16)); at |ref| <= 4 it is at
    most 0.1, the JAX package's own bf16 bar on unit-scale outputs
    (tests/test_pallas.py)."""
    ratio, d, r, err = bf16_ratio(got, ref)
    check(ratio <= 1.0, f"{what}: |diff| {d} at |ref| {r} over 0.02 + "
          "0.02 |ref|")
    return err


def scaled_reading(got, ref) -> float:
    """max |got - ref| as a fraction of max |ref|."""
    return max_err(got, ref) / float(ref.float().abs().max())


# The bf16 attention's (K4's output and gradients, K7's output) bar on
# max |got - ref| as a fraction of max |ref|.  Their values are ~0.01-0.2
# (softmax-weighted means over ~1000 keys), where 0.02 + 0.02 |ref| would
# pass a result that is wrong by its own size.  bf16_bars.py reads the
# kernels, and plain bf16 arithmetic, at about one bf16 ulp of the
# largest values (under 0.008), and a head 5% off at over 0.035.
ATTN_BF16_TOL = 0.02


def check_attention_bf16(got, ref, what: str) -> float:
    """Hold a bf16 attention result to 0.02 + 0.02 |ref| per element and
    to max |got - ref| <= ATTN_BF16_TOL max |ref|; return the reading
    max |got - ref| / max |ref|."""
    check_bf16(got, ref, what)
    reading = scaled_reading(got, ref)
    check(reading <= ATTN_BF16_TOL, f"{what}: max |diff| is {reading:.4g} "
          f"of max |ref|, over {ATTN_BF16_TOL}")
    return reading


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


def time_ms_queued(fn, calls: int, reps: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around
    ``calls`` calls queued back to back (so that the host's time to issue a
    call overlaps the card's work), median over ``reps``, after a warm-up
    call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def argmax_agreement(got, ref, gap: float = 1e-4):
    """(share of rows whose argmax of ``got`` equals ``ref``'s, among the
    rows whose top two values of ``ref`` are more than ``gap`` apart; that
    number of rows)."""
    top2 = ref.float().topk(2, dim=1).values
    rows = (top2[:, 0] - top2[:, 1]) > gap
    same = got.float().argmax(dim=1) == ref.float().argmax(dim=1)
    n = int(rows.sum())
    return (float(same[rows].float().mean()) if n else 1.0), n


def phase_region_attention(dev, results):
    """K3 at the decode step's shapes: p_pool (B,R,512), att_h (B,512),
    pool (B,R,1024), one fully masked row, the masks as the [:, 1:] views
    the model passes.  Besides the bars: two launches give the same bits,
    the f32 grounding argmaxes equal the plain version's on every row
    whose top two logits are more than 1e-4 apart, the launch plan, the
    achieved GB/s and share of the bound.  ``ms`` is a lone call's time
    with its host side (``time_ms``, as every kernel's row is timed);
    ``queued_ms`` is the device time of a call queued back to back
    (``time_ms_queued``), where the host's time to issue it overlaps the
    card's work."""
    import torch
    from grounded_video_description_torch.ops.kernels.region_attention \
        import card_plan, fused_region_attention, fused_region_attention_plain

    g = torch.Generator(device=dev).manual_seed(3)
    att_full = torch.rand(B, R + 1, generator=g, device=dev) < 0.2
    pnt_full = att_full | (torch.rand(B, R + 1, generator=g, device=dev)
                           < 0.2)
    att_full[0] = True                       # a fully masked row
    pnt_full[0] = True
    att_mask, pnt_mask = att_full[:, 1:], pnt_full[:, 1:]
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
        plan = card_plan(B, R, H_ATT, D_RNN, dt)
        res_k, grd_k = fused_region_attention(*args)
        res_2, grd_2 = fused_region_attention(*args)
        res_p, grd_p = fused_region_attention_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(res_k).all()), "K3 att_res not finite")
        check(bool((grd_k[0].float() <= -1e7).all()),
              "K3 masked row logits not MIN_VALUE")
        check(torch.equal(res_k, res_2) and torch.equal(grd_k, grd_2),
              "K3: two launches gave different bits")
        if dt == torch.float32:
            e_res, e_grd = max_err(res_k, res_p), max_err(grd_k, grd_p)
            # f32 sums of 512 tanh terms and of 1000 weighted rows, in a
            # different order than the plain version: ~1e-6 expected
            check(e_res <= 1e-4, f"K3 f32 att_res err {e_res}")
            check(e_grd <= 1e-3, f"K3 f32 grd err {e_grd}")
            agree, rows = argmax_agreement(grd_k, grd_p)
            check(agree == 1.0 and rows > 0,
                  f"K3 f32 grounding argmax agreement {agree} over {rows} "
                  "rows")
            print(f"K3 f32 grounding argmax: equal on all {rows} rows with "
                  "a top-two gap over 1e-4", flush=True)
        else:
            e_res = check_bf16(res_k, res_p, "K3 bf16 att_res")
            e_grd = check_bf16(grd_k, grd_p, "K3 bf16 grd")
        ms = time_ms(lambda: fused_region_attention(*args), 20)
        queued_ms = time_ms_queued(lambda: fused_region_attention(*args), 20)
        plain_ms = time_ms(lambda: fused_region_attention_plain(*args), 20)
        name = str(dt).replace("torch.", "")
        # per ROI: tanh(p_pool + att_h) . alpha_w (4 ops a column), then the
        # weighted sum of its pool row
        n_bytes = nbytes(*args, res_k, grd_k)
        b = bound(B * R * (4 * H_ATT + 2 * D_RNN), n_bytes, name)
        print(f"K3 region_attention {name}: plan splits {plan.splits} x "
              f"{plan.groups} streams of {plan.group_warps} warp(s), "
              f"{plan.slot_rois} ROI(s) a slot, {plan.ring_slots} slots, "
              f"{plan.copy} copies, {plan.smem} B smem, {plan.resident} "
              f"blocks resident, {plan.waves} wave(s); att_res err "
              f"{e_res:.3e} grd err {e_grd:.3e}; kernel {ms:.4f} ms "
              f"({n_bytes / ms / 1e6:.1f} GB/s, {b['bound_ms'] / ms:.3f} of "
              f"the bound), queued {queued_ms:.4f} ms ("
              f"{n_bytes / queued_ms / 1e6:.1f} GB/s, "
              f"{b['bound_ms'] / queued_ms:.3f} of the bound), plain "
              f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})", flush=True)
        results[("region_attention", name)] = dict(
            max_abs_err=max(e_res, e_grd), ms=ms, plain_ms=plain_ms,
            library_ms=None, queued_ms=queued_ms, **b)


def birnn_inputs(dev, g, T, Bn, H, mode):
    """gi (T, 2, Bn, G), wh (2, H, G) and bh (2, G) (None for the LSTM)
    in f32: gi ~ N(0, 0.25), W_hh and b_hh uniform in +-1/sqrt(H) (the
    initial scale of PyTorch's GRU and LSTM)."""
    import torch
    G = (3 if mode == "bigru" else 4) * H
    limit = 1.0 / H ** 0.5
    gi = torch.randn(T, 2, Bn, G, generator=g, device=dev) * 0.5
    wh = (torch.rand(2, H, G, generator=g, device=dev) * 2 - 1) * limit
    bh = (torch.rand(2, G, generator=g, device=dev) * 2 - 1) * limit
    return gi, wh, (bh if mode == "bigru" else None)


def check_birnn(got, ref, dt, what: str) -> float:
    """K2's bars: f32 within 1e-4 (both carry h in f32 and the step is
    contractive, so 480 steps of ~1e-7 rounding stay far below it); bf16
    on ``check_bf16``.  Returns the max abs error."""
    import torch
    check(bool(torch.isfinite(got.float()).all()), f"{what} not finite")
    if dt == torch.float32:
        err = max_err(got, ref)
        check(err <= 1e-4, f"{what} err {err}")
        return err
    return check_bf16(got, ref, what)


def phase_birnn(dev, results):
    """K2 at the temporal encoder's shapes: T=480 steps, B=100, H=512,
    both lanes; GRU and LSTM; with its cluster plan, the time of its
    per-step exchange and barrier alone, and ragged shapes (B = 7, H = 40
    and H = 520, which no cluster size divides)."""
    import torch
    from grounded_video_description_torch.ops.kernels.birnn import (
        birnn_exchange, birnn_recurrence, birnn_recurrence_plain, card_plan)

    H = D_RNN // 2
    gr = torch.Generator(device=dev).manual_seed(6)
    for mode in ("bigru", "bilstm"):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            for T_, Bn, Hr in ((30, 7, 40), (30, 7, 520)):
                gi, wh, bh = (
                    t.to(dt) if t is not None else None
                    for t in birnn_inputs(dev, gr, T_, Bn, Hr, mode))
                kw = dict(mode=mode, hidden=Hr)
                err = check_birnn(birnn_recurrence(gi, wh, bh, **kw),
                                  birnn_recurrence_plain(gi, wh, bh, **kw),
                                  dt, f"K2 {mode} {name} (T, B, H) = "
                                  f"({T_}, {Bn}, {Hr})")
                print(f"K2 {mode} {name} ragged (T, B, H) = ({T_}, {Bn}, "
                      f"{Hr}): err {err:.3e}; plan "
                      f"{card_plan(Bn, Hr, mode, dt).describe()}",
                      flush=True)
    g = torch.Generator(device=dev).manual_seed(5)
    for mode, n_gates in (("bigru", 3), ("bilstm", 4)):
        G = n_gates * H
        gi0, wh0, bh0 = birnn_inputs(dev, g, T_FRAMES, B, H, mode)
        for dt in (torch.float32, torch.bfloat16):
            gi, wh = gi0.to(dt), wh0.to(dt)
            bh = bh0.to(dt) if mode == "bigru" else None
            kw = dict(mode=mode, hidden=H)
            ys_k = birnn_recurrence(gi, wh, bh, **kw)
            ys_p = birnn_recurrence_plain(gi, wh, bh, **kw)
            torch.cuda.synchronize()
            name = str(dt).replace("torch.", "")
            err = check_birnn(ys_k, ys_p, dt, f"K2 {mode} {name}")
            plan = card_plan(B, H, mode, dt)
            print(f"K2 plan {mode} {name} (T, B, H) = ({T_FRAMES}, {B}, "
                  f"{H}): {plan.describe()}", flush=True)
            print(f"K2 max_clusters {mode} {name}: {plan.max_clusters} "
                  f"clusters of {plan.C} resident at once", flush=True)
            ms = time_ms(lambda: birnn_recurrence(gi, wh, bh, **kw), 5)
            exchange_ms = time_ms(lambda: birnn_exchange(gi, wh, bh, **kw),
                                  5)
            plain_ms = time_ms(lambda: birnn_recurrence_plain(
                gi, wh, bh, **kw), 3)
            # h W_hh for both lanes at every step
            b = bound(2 * T_FRAMES * 2 * B * H * G,
                      nbytes(gi, wh, ys_k, *([bh] if bh is not None else [])),
                      name)
            # cuDNN's bidirectional GRU or LSTM over the same sequence,
            # timed only; it also computes the input projection that gi
            # holds
            rnn = (torch.nn.GRU if mode == "bigru" else torch.nn.LSTM)(
                D_RNN, H, bidirectional=True).to(dev, dt)
            # one weight buffer; PyTorch skips this for bf16, whose weights
            # it then compacts at every call
            rnn.flatten_parameters()
            xs = torch.randn(T_FRAMES, B, D_RNN, generator=g, device=dev,
                             dtype=dt)
            with torch.no_grad():
                library_ms = time_ms(lambda: rnn(xs), 5)
            del rnn, xs
            print(f"K2 birnn_recurrence {mode} {name}: err {err:.3e}; "
                  f"kernel {ms:.3f} ms (its exchange and barrier alone "
                  f"{exchange_ms:.3f} ms, {1e3 * exchange_ms / T_FRAMES:.2f} "
                  f"us a step), plain {plain_ms:.3f} ms, bound "
                  f"{b['bound_ms']:.3f} ms ({b['bound_by']}), cuDNN "
                  f"{mode[2:].upper()} {library_ms:.3f} ms", flush=True)
            results[(f"birnn_recurrence_{mode}", name)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, exchange_ms=exchange_ms, **b)


def phase_encoder_layer(dev, results):
    """K1 at the obj_interact shapes: (B, R, D) = (100, 1000, 1024),
    6 uneven heads, FFN 512, two layers."""
    import torch
    import torch.nn.functional as F
    from grounded_video_description_torch.models.transformer import (
        Encoder, encoder_apply)
    from grounded_video_description_torch.ops.kernels import _build
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
            qkv_flops = 2 * a.shape[0] * wqkv.shape[0] * a.shape[1]
            gemm_tflops = qkv_flops / gemm_ms / 1e9
            lib_tflops = qkv_flops / lib_ms / 1e9
            print(f"K1 GEMM {name} (100000 x 3072 x 1024): err "
                  f"{e_gemm:.3e}; kernel {gemm_ms:.3f} ms "
                  f"({gemm_tflops:.1f} TFLOP/s), cuBLAS "
                  f"{lib_ms:.3f} ms ({lib_tflops:.1f} TFLOP/s)", flush=True)
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
            _build.reset_launches()
            encoder_apply(enc, xin, n_heads=6, use_kernel=True)
            route = dict(_build.launches)
            want = k1_counts(name, 2)
            check(route == want, f"K1 {name} launches {route} != {want}")
            ms = time_ms(lambda: encoder_apply(enc, xin, n_heads=6,
                                               use_kernel=True), 3)
            plain_ms = time_ms(lambda: encoder_apply(enc, xin, n_heads=6),
                               3)
            library_ms = time_ms(lambda: k1_library(xin, weights, 6), 3)
            n_w = sum(nbytes(*w) for w in weights)
            # f32: the products and the attention in 3xTF32
            b = bound(2 * layer_flops(B, R, D_RNN, D_RNN // 2),
                      2 * nbytes(xin) * 2 + n_w, attention_rate(name))
            print(f"K1 encoder_layer x2 {name}: per-layer err "
                  f"{[f'{e:.3e}' for e in errs]}; kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
                  f"({b['bound_by']}), library (F.linear, "
                  f"scaled_dot_product_attention, the twin's LayerNorm) "
                  f"{library_ms:.3f} ms; launches {route}", flush=True)
            results[("encoder_layer", name)] = dict(
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, gemm_tflops=gemm_tflops,
                library_gemm_tflops=lib_tflops, **b)


def k1_counts(dtype: str, layers: int) -> dict:
    """K1's launch counts for ``layers`` layer calls at the flagship's
    heads of 171: each layer, and its attention's route (the tensor-core
    forward in either dtype; f32 also counts the 3xTF32 route)."""
    from grounded_video_description_torch.ops.kernels.encoder_layer import (
        ATTENTION_ROUTES)
    route = "mma" if dtype == "bfloat16" else "tf32x3"
    counts = {"encoder_layer": layers, ATTENTION_ROUTES[route]: layers}
    if dtype == "float32":
        counts[TF32_ROUTE] = layers
    return counts


def k1_library(x, weights, heads):
    """K1's two layers by library calls, timed only (the port never calls
    this): per layer ``F.linear`` for QKV (one product, N = 3D),
    ``scaled_dot_product_attention`` over the heads of ceil(D / heads)
    zero-padded to a multiple of 8 (176 at D = 1024; a zero pad changes
    no output column), ``F.linear`` for Wo, then the twin's residual +
    unbiased-std LayerNorm, ReLU FFN (``F.linear``) and residual +
    LayerNorm (``layer_tail``)."""
    import torch
    import torch.nn.functional as F
    from grounded_video_description_torch.ops.kernels.encoder_layer import (
        layer_tail)
    Bq, Rq, D = x.shape
    hs = -(-D // heads)
    hp = -(-hs // 8) * 8

    def split(t):
        t = F.pad(t, (0, heads * hs - D)).view(Bq, Rq, heads, hs)
        return F.pad(t, (0, hp - hs)).transpose(1, 2)

    dt = x.dtype
    with torch.no_grad():
        for w in weights:
            wqkv = torch.cat([w.wq, w.wk, w.wv]).to(dt)
            q, k, v = F.linear(x, wqkv).split(D, dim=-1)
            o = F.scaled_dot_product_attention(split(q), split(k), split(v),
                                               scale=1.0 / math.sqrt(D))
            o = o.transpose(1, 2)[..., :hs].reshape(Bq, Rq, heads * hs)
            x = layer_tail(x, F.linear(o[..., :D], w.wo.to(dt)), w)
    return x


def phase_attention_train(dev, results):
    """K4 at the obj_interact training shapes: q/k/v (30, 1000, 1024) in
    6 uneven heads, the microbatch of batch 240 in 8; f32 and bf16, drop
    0.2 (the flagship's enc_drop) and 0.  The kernel's output and its
    q/k/v gradients against the plain twin's autograd on the same seed,
    and both passes timed alone."""
    import torch
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.ops.kernels.attention_train \
        import mha_probs_dropout, mha_probs_dropout_plain, pack_heads

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
                _build.reset_launches()
                out = fn(*leaves, seed, drop=drop, **kw)
                grads = torch.autograd.grad(out, leaves, w,
                                            retain_graph=True)
                torch.cuda.synchronize()
                if which == "kernel":
                    want = {"attention_train_fwd": 1,
                            "attention_train_bwd": 1}
                    if dt == torch.float32:
                        want[TF32_ROUTE] = 2
                    check(dict(_build.launches) == want,
                          f"K4 {name} launches {dict(_build.launches)}")
                fwd_ms = time_ms(lambda: fn(*leaves, seed, drop=drop, **kw),
                                 5)
                bwd_ms = time_ms(lambda: torch.autograd.grad(
                    out, leaves, w, retain_graph=True), 5)
                runs[which] = ([out.detach()] + list(grads), fwd_ms, bwd_ms)
                del out, grads, leaves
            (got, k_fwd, k_bwd), (ref, p_fwd, p_bwd) = (runs["kernel"],
                                                         runs["plain"])
            errs, readings = {}, {}
            for part, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
                check(bool(torch.isfinite(a.float()).all()),
                      f"K4 {name} drop {drop} {part} not finite")
                errs[part] = max_err(a, b)
                if dt == torch.float32:
                    # f32 sums over 1000 keys or queries in another
                    # order: ~1e-6 expected
                    check(errs[part] <= 1e-4,
                          f"K4 f32 drop {drop} {part} err {errs[part]}")
                else:
                    readings[part] = check_attention_bf16(
                        a, b, f"K4 bf16 drop {drop} {part}")
            scaled = (f"; max |diff| / max |ref| "
                      f"{ {p: f'{e:.3e}' for p, e in readings.items()} } "
                      f"(bar {ATTN_BF16_TOL})" if readings else "")
            print(f"K4 attention_train {name} drop {drop}: err "
                  f"{ {p: f'{e:.3e}' for p, e in errs.items()} }{scaled}; "
                  "forward "
                  f"kernel {k_fwd:.3f} ms, plain {p_fwd:.3f} ms; backward "
                  f"kernel {k_bwd:.3f} ms, plain {p_bwd:.3f} ms", flush=True)
            if drop > 0:
                act = nbytes(q)
                # forward: QK^T and PV; backward: QK^T again, dV, dP, dQ, dK
                rate = attention_rate(name)
                results[("attention_train_fwd", name)] = dict(
                    max_abs_err=errs["out"], ms=k_fwd, plain_ms=p_fwd,
                    **bound(4 * Bm * R * R * D_RNN, 4 * act, rate))
                results[("attention_train_bwd", name)] = dict(
                    max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]),
                    ms=k_bwd, plain_ms=p_bwd,
                    **bound(10 * Bm * R * R * D_RNN, 8 * act, rate))
                # the kernels first repack q, k, v (and dO in the
                # backward) head-major; inside k_fwd and k_bwd
                for part, xs in (("fwd", [q, k, v]), ("bwd", [q, k, v, w])):
                    rp = time_ms(lambda: pack_heads(xs, heads), 5)
                    results[(f"attention_train_{part}", name)][
                        "repack_ms"] = rp
                    print(f"K4 {name} repack of {len(xs)} tensors "
                          f"({part}): {rp:.3f} ms", flush=True)
                print(f"K4 {name}: bound forward " + ", backward ".join(
                    f"{results[(k, name)]['bound_ms']:.3f} ms "
                    f"({results[(k, name)]['bound_by']})" for k in (
                        "attention_train_fwd", "attention_train_bwd")),
                      flush=True)
            else:
                lib_fwd, lib_bwd = sdpa_ms(q, k, v, w, heads, D_RNN ** -0.5)
                results[("attention_train_fwd", name)]["library_ms"] = lib_fwd
                results[("attention_train_bwd", name)]["library_ms"] = lib_bwd
                print(f"K4 {name}: scaled_dot_product_attention at drop 0, "
                      f"forward {lib_fwd:.3f} ms, backward {lib_bwd:.3f} ms",
                      flush=True)
            del got, ref
            torch.cuda.empty_cache()


def sdpa_ms(q, k, v, w, heads, scale):
    """Forward and backward ms of one ``scaled_dot_product_attention`` on
    q, k, v (B, R, D) cut into ``heads`` heads of ceil(D / heads) (the
    last one zero-padded, which changes no output column), with the
    cotangent w.  The library call is timed only, never used by the
    port."""
    import torch
    import torch.nn.functional as F
    Bq, Rq, D = q.shape
    hs = -(-D // heads)

    def split(t):
        t = F.pad(t, (0, heads * hs - D))
        return t.view(Bq, Rq, heads, hs).transpose(1, 2).contiguous()

    leaves = [split(t).requires_grad_(True) for t in (q, k, v)]
    cot = split(w)

    def fwd():
        return F.scaled_dot_product_attention(*leaves, scale=scale)

    out = fwd()
    fwd_ms = time_ms(fwd, 5)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, cot,
                                                 retain_graph=True), 5)
    return fwd_ms, bwd_ms


def layer_gemm_flops(Bm, R_, D, F_):
    """Operations of the QKV, Wo and FFN products of one obj_interact
    layer on (Bm, R_, D): 2 per multiply-add."""
    return 2 * Bm * R_ * (4 * D * D + 2 * D * F_)


def layer_flops(Bm, R_, D, F_):
    """One layer's forward: its products and QK^T and PV over every head
    (the heads tile D)."""
    return layer_gemm_flops(Bm, R_, D, F_) + 4 * Bm * R_ * R_ * D


K5_PARTS = ("out", "dx") + tuple(
    f"d{n}" for n in ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2", "g1",
                      "be1", "g2", "be2"))


def k5_layer(dev, Bm: int = 30):
    """The K5 phase's inputs: one obj_interact training layer at flagship
    width (FFN 512) with seeded weights and LayerNorm affines away from 1
    and 0, x and an output cotangent (Bm, 1000, 1024) in f32, and a
    dropout seed."""
    import torch
    from grounded_video_description_torch.models.transformer import Encoder
    g = torch.Generator().manual_seed(19)
    enc = Encoder(D_RNN, D_RNN // 2, 1)
    enc.reset_parameters(g)
    with torch.no_grad():
        for ln in (enc.layers[0].selfattn.layernorm,
                   enc.layers[0].feedforward.layernorm):
            ln.gamma.add_(0.1 * torch.randn(D_RNN, generator=g))
            ln.beta.add_(0.1 * torch.randn(D_RNN, generator=g))
    x0 = torch.randn(Bm, R, D_RNN, generator=g).to(dev)
    cot = torch.randn(Bm, R, D_RNN, generator=g).to(dev)
    return enc.to(dev), x0, cot, torch.tensor([0x9E3779B9], device=dev)


def k5_ties(x, lw, seed, drop, row0=0):
    """ReLU ties: an FFN pre-activation within rounding of 0 can take the
    other branch in the kernel's summation order than in the twin's,
    which changes that token's dx row and that unit's dW1 row and db1
    entry by a whole term, not a rounding.  They are found by comparing
    the two sides' branches (the kernel's saved FFN activation against
    the twin's pre-activation): (tokens (B, R, 1), units (F,)) that hold
    one."""
    import torch
    import torch.nn.functional as F
    from grounded_video_description_torch.ops.kernels import (
        encoder_layer_train as k5)
    dt = x.dtype
    with torch.no_grad():
        hid_k = k5._kernel_forward(x, lw, seed, 6, drop, row0)[1].hid
        x1 = k5.attention_sublayer_plain(x, lw, seed, n_heads=6, drop=drop,
                                         row0=row0)
        z = F.linear(x1.to(dt).float(), lw.w1.to(dt).float()) + lw.b1
        tie = ((hid_k.float() > 0) != (z.flatten(0, 1) > 0)).view(
            *x.shape[:2], -1)
    return tie.any(-1, keepdim=True), tie.flatten(0, 1).any(0)


def k5_held(got, ref, dt, ties):
    """Hold K5's output and 13 gradients (``K5_PARTS``) to their bars:
    {part: (max abs error, its ratio to the bar, relative norm error)},
    the ReLU ties' rows (``k5_ties``) held only in the relative norm.
    f32: sums of 1024-wide products (and of 30000 rows for the weight
    gradients) in another order, so max |diff| <= 1e-4 (the output) or
    1e-3 (a gradient) of the tensor's max |ref|, and the whole tensor
    within the same in relative norm.  bf16: the output at 0.02 + 0.02
    |ref|; a gradient sums up to 30000 rows of bf16 products, so the same
    bar on the tensor scaled to a largest magnitude of 1."""
    tie_tokens, tie_units = ties
    held = {"dx": ~tie_tokens, "dw1": ~tie_units[:, None],
            "db1": ~tie_units}
    res = {}
    for part, a, b in zip(K5_PARTS, got, ref):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        keep = held.get(part)
        if keep is not None:
            keep = keep.expand_as(a)
            a, b = a[keep], b[keep]
        err, scale = max_err(a, b), float(b.float().abs().max())
        if dt == "float32":
            tol = 1e-4 if part == "out" else 1e-3
            res[part] = (err, max(err / (tol * scale), rel / tol), rel)
        elif part == "out":
            res[part] = (err, bf16_ratio(a, b)[0], rel)
        else:
            res[part] = (err, bf16_ratio(a / scale, b / scale)[0], rel)
    return res


def k5_library(x, lw, heads, drop):
    """K5's layer by library calls, timed only (the port never calls
    this): ``F.linear`` for QKV (one product, N = 3D),
    ``scaled_dot_product_attention`` with ``dropout_p`` = drop over the
    heads of ceil(D / heads) zero-padded to a multiple of 8 (176 at
    D = 1024), ``F.linear`` for Wo, then the twin's dropout (the
    library's masks, not K5's: only the time compares), residual and
    unbiased-std LayerNorm, the ReLU FFN (``F.linear``) and its dropout,
    residual and LayerNorm.  Differentiable by autograd."""
    import torch
    import torch.nn.functional as F
    from grounded_video_description_torch.nn.core import layer_norm_affine
    from grounded_video_description_torch.ops.kernels.encoder_layer import (
        LN_EPS)
    Bq, Rq, D = x.shape
    hs = -(-D // heads)
    hp = -(-hs // 8) * 8

    def split(t):
        t = F.pad(t, (0, heads * hs - D)).view(Bq, Rq, heads, hs)
        return F.pad(t, (0, hp - hs)).transpose(1, 2)

    def ln(y, g, b):
        return layer_norm_affine(g, b, y, LN_EPS, use_std=True)

    dt = x.dtype
    wqkv = torch.cat([lw.wq, lw.wk, lw.wv]).to(dt)
    q, k, v = F.linear(x, wqkv).split(D, dim=-1)
    o = F.scaled_dot_product_attention(split(q), split(k), split(v),
                                       dropout_p=drop,
                                       scale=1.0 / math.sqrt(D))
    o = o.transpose(1, 2)[..., :hs].reshape(Bq, Rq, heads * hs)[..., :D]
    a = F.linear(o, lw.wo.to(dt)).float()
    x1 = ln(x.float() + F.dropout(a, drop), lw.g1, lw.be1)
    hid = F.relu(F.linear(x1.to(dt), lw.w1.to(dt), lw.b1.to(dt)))
    f = F.linear(hid, lw.w2.to(dt), lw.b2.to(dt)).float()
    return ln(x1 + F.dropout(f, drop), lw.g2, lw.be2).to(dt)


# K5's GEMM layouts at the flagship training layer's shapes: (layout name,
# (M, N, K)) for Wo (x W^T), dattn (dY W) and dWo (A^T B over the rows)
K5_GEMM_SHAPES = (("NT", (30000, 1024, 1024)), ("NN", (30000, 1024, 1024)),
                  ("TN", (1024, 1024, 30000)))


def k5_gemm_rates(dev, dt):
    """Each K5 GEMM layout alone at ``K5_GEMM_SHAPES`` in ``dt``, f32 out:
    held to 1e-4 of max |ref| against the f32 product of the same
    operands (the sums in another order), its ms and TFLOP/s beside
    ``torch.matmul``'s on the same operands (timed only).  Returns
    {layout: (TFLOP/s, torch.matmul's)}."""
    import torch
    from grounded_video_description_torch.ops.kernels import (
        encoder_layer_train as k5)
    g = torch.Generator(device=dev).manual_seed(23)
    rates = {}
    for name, (M, N, K) in K5_GEMM_SHAPES:
        layout = getattr(k5, name)
        a_shape = (K, M) if layout == k5.TN else (M, K)
        b_shape = (N, K) if layout == k5.NT else (K, N)
        a = (0.1 * torch.randn(a_shape, generator=g, device=dev)).to(dt)
        b = (0.1 * torch.randn(b_shape, generator=g, device=dev)).to(dt)
        op_a = a.t() if layout == k5.TN else a
        op_b = b.t() if layout == k5.NT else b
        got = k5._mm(layout, a, b, M, N, K, out_f32=True)
        ref = op_a.float() @ op_b.float()
        torch.cuda.synchronize()
        err = scaled_reading(got, ref)
        check(err <= 1e-4, f"K5 GEMM {name} {dt}: err {err} of max |ref|")
        del got, ref
        ms = time_ms(lambda: k5._mm(layout, a, b, M, N, K, out_f32=True), 5)
        lib_ms = time_ms(lambda: torch.matmul(op_a, op_b), 5)
        flops = 2 * M * N * K
        rates[name] = (flops / ms / 1e9, flops / lib_ms / 1e9)
        print(f"K5 GEMM {name} {str(dt)[6:]} ({M} x {N} x {K}): err "
              f"{err:.2e} of max |ref|; kernel {ms:.3f} ms "
              f"({rates[name][0]:.1f} TFLOP/s), torch.matmul {lib_ms:.3f} "
              f"ms ({rates[name][1]:.1f} TFLOP/s)", flush=True)
    return rates


def k5_library_ms(x, enc, w, drop):
    """Forward and backward (autograd, cotangent w) ms of ``k5_library``
    on x and the layer's tensors."""
    import torch
    xl = x.clone().requires_grad_(True)
    leaves = [xl] + list(enc.layers[0].weights())

    def fwd():
        return k5_library(xl, enc.layers[0].weights(), 6, drop)

    out = fwd()
    fwd_ms = time_ms(fwd, 3)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, w,
                                                 retain_graph=True), 3)
    return fwd_ms, bwd_ms


def k5_gemm_counts(dt: str, calls: int) -> dict:
    """The GEMM launches of ``calls`` K5 forward and backward passes in
    dtype ``dt``: every product on the tensor-core route in bf16 (none on
    the SIMT route), on the SIMT route in f32, where the attention counts
    its 3xTF32 route each way too."""
    from grounded_video_description_torch.ops.kernels import (
        encoder_layer_train as k5)
    route = "k5_gemm_tc" if dt == "bfloat16" else "k5_gemm_simt"
    counts = {route: calls * (k5.FWD_GEMMS + k5.BWD_GEMMS)}
    if dt == "float32":             # its attention, forward and backward
        counts[TF32_ROUTE] = 2 * calls
    return counts


def phase_encoder_layer_train(dev, results):
    """K5 at the obj_interact training shapes: x (30, 1000, 1024), six
    uneven heads, FFN 512, the microbatch of batch 240 in 8; f32 and bf16,
    drop 0.2 (the flagship's enc_drop) and 0.  The output and the 13
    gradients (x and the 12 layer tensors) against the plain twin's
    autograd on the same seed and masks (``k5_held``), both passes timed
    alone beside the library chain ``k5_library``, the peak memory of one
    forward + backward on each side, the launches of one pass each way
    (every product on the dtype's GEMM route), and the GEMM's three
    layouts alone (``k5_gemm_rates``)."""
    import torch
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.ops.kernels.encoder_layer_train \
        import fused_encoder_layer_train, fused_encoder_layer_train_plain

    Bm, Fh = 30, D_RNN // 2
    enc, x0, cot, seed = k5_layer(dev, Bm)
    lw = list(enc.layers[0].weights())
    # the backward: two products per forward product (q, k, v and o are
    # saved), and the attention's five (QK^T again, dV, dP, dQ, dK)
    # (in f32 the products on the SIMT units, the attention in 3xTF32)
    gemm_fwd = layer_gemm_flops(Bm, R, D_RNN, Fh)
    attn_fwd = layer_flops(Bm, R, D_RNN, Fh) - gemm_fwd
    attn_bwd = 10 * Bm * R * R * D_RNN
    w_bytes = nbytes(*lw)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        act = nbytes(x0.to(dt))
        # forward: x in, out; backward: x and the cotangent in, dx out;
        # each with the f32 weights in (and their f32 gradients out)
        rate = attention_rate(name)
        bound_fwd = bound({name: gemm_fwd, rate: attn_fwd} if rate != name
                          else gemm_fwd + attn_fwd, 2 * act + w_bytes, name)
        bound_bwd = bound({name: 2 * gemm_fwd, rate: attn_bwd}
                          if rate != name else 2 * gemm_fwd + attn_bwd,
                          3 * act + 2 * w_bytes, name)
        rates = k5_gemm_rates(dev, dt)
        for drop in (0.2, 0.0):
            x, w = x0.to(dt), cot.to(dt)
            runs = {}
            for which, fn in (("kernel", fused_encoder_layer_train),
                              ("plain", fused_encoder_layer_train_plain)):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                xl = x.clone().requires_grad_(True)
                leaves = [xl] + lw

                def fwd():
                    return fn(xl, enc.layers[0].weights(), seed, n_heads=6,
                              drop=drop)

                _build.reset_launches()
                out = fwd()
                grads = torch.autograd.grad(out, leaves, w,
                                            retain_graph=True)
                torch.cuda.synchronize()
                peak_mb = (torch.cuda.max_memory_allocated() - held) / 2**20
                if which == "kernel":
                    # one pass each way, every product on dt's route
                    want = {"encoder_layer_train_fwd": 1,
                            "encoder_layer_train_bwd": 1,
                            **k5_gemm_counts(name, 1)}
                    route = dict(_build.launches)
                    check(route == want,
                          f"K5 {name} launches {route} != {want}")
                fwd_ms = time_ms(fwd, 3)
                bwd_ms = time_ms(lambda: torch.autograd.grad(
                    out, leaves, w, retain_graph=True), 3)
                runs[which] = ([out.detach()] + list(grads), fwd_ms, bwd_ms,
                               peak_mb)
                del out, grads, xl, leaves
            (got, k_fwd, k_bwd, k_mb), (ref, p_fwd, p_bwd, p_mb) = (
                runs["kernel"], runs["plain"])
            if drop > 0:
                lib_fwd, lib_bwd = k5_library_ms(x, enc, w, drop)
            for part, a, b in zip(K5_PARTS, got, ref):
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"K5 {name} drop {drop} {part}: {a.dtype} "
                      f"{tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
                check(bool(torch.isfinite(a.float()).all()),
                      f"K5 {name} drop {drop} {part} not finite")
            ties = k5_ties(x, enc.layers[0].weights(), seed, drop)
            n_tok, n_unit = int(ties[0].sum()), int(ties[1].sum())
            # f32: the branches differ only where z is within ~1e-6 of 0;
            # bf16: also where x1 rounds to the other side of a bf16 value
            # (one in ~2000 elements), which moves z by ~1e-4
            tie_cap = 1000 if dt == torch.float32 else 20
            check(n_tok <= Bm * R // tie_cap,
                  f"K5 {name} drop {drop}: {n_tok} tokens at a ReLU tie")
            res = k5_held(got, ref, name, ties)
            for part, (err, ratio, rel) in res.items():
                check(ratio <= 1.0, f"K5 {name} drop {drop} {part}: err "
                      f"{err}, relative norm {rel}: {ratio:.3g} of its bar")
            errs = {p: r[0] for p, r in res.items()}
            rel = {p: r[2] for p, r in res.items()}
            worst = max(res, key=lambda p: res[p][1])
            print(f"K5 encoder_layer_train {name} drop {drop}: ReLU ties "
                  f"{n_tok} tokens, {n_unit} units; max err out "
                  f"{errs['out']:.3e}, grads {max(errs.values()):.3e} "
                  f"({max(errs, key=errs.get)}), relative norm "
                  f"{max(rel.values()):.2e} ({max(rel, key=rel.get)}); "
                  f"worst ratio to its bar {res[worst][1]:.3f} ({worst}); "
                  f"forward kernel {k_fwd:.3f} "
                  f"ms, plain {p_fwd:.3f} ms (bound "
                  f"{bound_fwd['bound_ms']:.3f}); backward kernel "
                  f"{k_bwd:.3f} ms, plain {p_bwd:.3f} ms (bound "
                  f"{bound_bwd['bound_ms']:.3f}); peak MB of forward + "
                  f"backward: kernel {k_mb:.0f}, plain {p_mb:.0f}",
                  flush=True)
            if drop > 0:
                print(f"K5 {name} drop {drop}: library chain (F.linear, "
                      f"scaled_dot_product_attention with dropout, the "
                      f"twin's LayerNorm) forward {lib_fwd:.3f} ms, "
                      f"backward {lib_bwd:.3f} ms", flush=True)
                tflops = {k: round(v[0], 1) for k, v in rates.items()}
                results[("encoder_layer_train_fwd", name)] = dict(
                    max_abs_err=errs["out"], ms=k_fwd, plain_ms=p_fwd,
                    library_ms=lib_fwd, peak_mb=k_mb, plain_peak_mb=p_mb,
                    gemm_tflops=tflops, **bound_fwd)
                results[("encoder_layer_train_bwd", name)] = dict(
                    max_abs_err=max(v for k, v in errs.items()
                                    if k != "out"),
                    ms=k_bwd, plain_ms=p_bwd, library_ms=lib_bwd,
                    gemm_tflops=tflops, **bound_bwd)
            del got, ref
            torch.cuda.empty_cache()


# phase_train's timed bf16 steps a path (3 until the data-parallel phase
# came; 2 keeps the whole script near half its time limit)
TRAIN_TIMED_STEPS = 2
TRAIN_PATHS = {                 # name: the config fields that choose it
    "K5": dict(use_pallas_encoder_train=True),
    "K4": dict(attn_train_impl="pallas"),
    "plain": dict(attn_train_impl="xla"),
}


def train_config():
    """The README's training flags at flagship width: batch 240 in 8
    microbatches, w_att2 0.05, w_cls 0.1, Adam at 5e-4, clip 0.1, the
    flagship dropout rates."""
    from grounded_video_description_torch.config import GVDConfig
    return GVDConfig(vocab_size=4905, detect_size=431, obj_interact=True,
                     batch_size=240, grad_accum=8, w_att2=0.05, w_cls=0.1,
                     drop_prob_lm=0.5, enc_drop=0.2, learning_rate=5e-4,
                     grad_clip=0.1, use_pallas=False).validate()


@functools.lru_cache(maxsize=None)
def train_batch():
    """The flagship train batch, ``synthetic_batch(train_config(), 240,
    seed=0)``, made once a run (~27 s of host time) for the train,
    driver and data-parallel phases: none of the fields their configs
    change (caption family, dtype, kernel and eval flags) is read by
    ``synthetic_batch``, and none of them writes to it."""
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    cfg = train_config()
    return synthetic_batch(cfg, cfg.batch_size, seed=0)


def phase_train(dev, state, family="topdown", paths=None):
    """Trainer.train_step at the flagship training configuration of
    caption family ``family`` (``att_model``) through ``paths`` (default
    ``TRAIN_PATHS``: K5, ``use_pallas_encoder_train``; K4,
    ``attn_train_impl="pallas"``; the plain attention): in f32 with every
    dropout 0 one step each, each kernel path against plain; in bf16 at
    the flagship rates a warm-up and two timed steps each, taken in
    turns (in order, then the reverse), with each step's launch counts
    checked.  Returns the launch counts of the kernel paths per dtype (the
    f32 step's, and the bf16 timed steps') and the bf16 segments/s per
    path."""
    import torch
    from grounded_video_description_torch.engine.trainer import (
        Trainer, batch_to_device)
    from grounded_video_description_torch.models import GVDModel
    from grounded_video_description_torch.ops.kernels import _build

    paths = paths or TRAIN_PATHS
    base = train_config().replace(att_model=family)
    BT, ACCUM = base.batch_size, base.grad_accum
    t0 = time.perf_counter()
    batch = train_batch()
    print(f"train set-up (batch) {time.perf_counter() - t0:.1f} s",
          flush=True)
    terms = ("loss", "lm_loss", "att2_loss", "ground_loss", "cls_loss")
    per_step = {                    # 2 layers x 8 microbatches
        "K5": {"encoder_layer_train_fwd": 2 * ACCUM,
               "encoder_layer_train_bwd": 2 * ACCUM},
        "K4": {"attention_train_fwd": 2 * ACCUM,
               "attention_train_bwd": 2 * ACCUM},
        "plain": {}}

    def step_counts(name, dt):
        if name == "K5":
            return {**per_step[name], **k5_gemm_counts(dt, 2 * ACCUM)}
        if name == "K4" and dt == "float32":
            return {**per_step[name], TF32_ROUTE: 4 * ACCUM}
        return per_step[name]

    def trainer_for(cfg):
        model = GVDModel(cfg)
        model.load_state_dict(state)
        return Trainer(cfg, model.to(dev))

    # (a) f32, every dropout rate 0: K5 and K4 against the plain attention
    stats, f32_counts = {}, {}
    for name, flags in paths.items():
        cfg = base.replace(drop_prob_lm=0.0, loc_drop=0.0, enc_drop=0.0,
                           **flags)
        tr = trainer_for(cfg)
        _build.reset_launches()
        m = tr.train_step(batch_to_device(cfg, batch, dev),
                          cfg.learning_rate)
        stats[name] = {k: float(v) for k, v in m.items()}
        check(dict(_build.launches) == step_counts(name, "float32"),
              f"f32 {name} step launches {dict(_build.launches)}")
        f32_counts.update(_build.launches)
        del tr
        torch.cuda.empty_cache()
    for name in (n for n in paths if n != "plain"):
        for k in terms:
            a, b = stats[name][k], stats["plain"][k]
            check(abs(a - b) <= 1e-4 * abs(b),
                  f"f32 step {k}: {name} {a} vs {b}")
        a, b = stats[name]["grad_norm"], stats["plain"]["grad_norm"]
        check(abs(a - b) <= 1e-3 * abs(b),
              f"f32 step grad norm: {name} {a} vs {b}")
        print(f"train {family} f32 drop 0, {name} vs plain attention: "
              + ", ".join(f"{k} {stats[name][k]:.6f} / "
                          f"{stats['plain'][k]:.6f}"
                          for k in terms + ("grad_norm",)), flush=True)

    # (b) bf16 at the flagship dropout rates, the timed steps in turns
    runs = {}
    for name, flags in paths.items():
        cfg = base.replace(dtype="bfloat16", **flags)
        tr = trainer_for(cfg)
        dev_batch = batch_to_device(cfg, batch, dev)
        tr.train_step(dev_batch, cfg.learning_rate)          # warm-up
        torch.cuda.synchronize()
        runs[name] = (cfg, tr, dev_batch, [], {})
    order = list(paths)
    for step in range(TRAIN_TIMED_STEPS):
        for name in (order if step % 2 == 0 else order[::-1]):
            cfg, tr, dev_batch, times, counts = runs[name]
            _build.reset_launches()
            t0 = time.perf_counter()
            m = tr.train_step(dev_batch, cfg.learning_rate)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = dict(_build.launches)
            want = step_counts(name, "bfloat16")
            check(got == want, f"bf16 {name} step launches {got} != {want}")
            for k, n in got.items():
                counts[k] = counts.get(k, 0) + n
            losses = {k: float(v) for k, v in m.items()}
            check(all(math.isfinite(v) for v in losses.values()),
                  f"bf16 {name} step {step} losses {losses}")
            print(f"train {family} bf16 {name} step {step}: " + ", ".join(
                f"{k} {v:.5f}" for k, v in losses.items())
                + f"; {times[-1]:.3f} s", flush=True)
    rates = {name: BT / statistics.median(r[3]) for name, r in runs.items()}
    print(f"train {family} bf16 segments/s (median of {TRAIN_TIMED_STEPS} "
          "steps, in turns): "
          + ", ".join(f"{name} {rate:.2f}" for name, rate in rates.items()),
          flush=True)
    launches = {"float32": f32_counts, "bfloat16": {}}
    for name in paths:
        launches["bfloat16"].update(runs[name][4])
    del runs
    torch.cuda.empty_cache()
    return launches, rates


def phase_end_to_end(dev, base, state):
    """sample_greedy at the flagship configuration, through the kernels
    and on the plain path.  Returns the launch counts of the kernel run
    per dtype."""
    import torch
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.models import batch_to_tensors
    from grounded_video_description_torch.ops.kernels import _build

    batch = batch_to_tensors(synthetic_batch(base, B, seed=0), dev)

    def model_for(dtype: str, kernels: bool):
        return model_of(base.replace(dtype=dtype, use_pallas=kernels,
                                     use_pallas_rnn=kernels,
                                     use_pallas_encoder=kernels), state, dev)

    launches = {}
    for dtype in ("float32", "bfloat16"):
        outs, rates = {}, {}
        for kernels in (True, False):
            m = model_for(dtype, kernels)
            _build.reset_launches()
            out = m.sample_greedy(batch)
            torch.cuda.synchronize()
            counts = dict(_build.launches)
            if kernels:
                # K2: 2 BiGRU layers per encode; K1: 2 layers, each on its
                # tensor-core attention; K3: 20 steps
                expect = {"birnn_recurrence": 2,
                          "region_attention": base.seq_length,
                          **k1_counts(dtype, 2)}
                check(counts == expect,
                      f"{dtype} kernel run launches {counts} != {expect}")
                launches[dtype] = counts
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


def host_s(fn, iters: int) -> float:
    """Median host-clock seconds of ``fn`` ending in a synchronize, over
    ``iters`` runs after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


BEAM_WIDTHS = (3, 5)


def phase_beam(dev, base, state):
    """``sample_beam`` at the flagship configuration (the e2e phase's
    weights and batch) at each of BEAM_WIDTHS, f32 and bf16, through the
    inference kernels of its encode (K1, K2; its attentions are plain, as
    the JAX package's beam) and on the plain path.  f32: tokens and, on
    the live positions (the same word in both runs), the per-frame
    grounding argmaxes >= 0.99 equal; bf16: printed and finite.  Prints
    beam captions/s per width and dtype (host clock)."""
    import torch
    from grounded_video_description_torch.data.synthetic import (
        synthetic_batch)
    from grounded_video_description_torch.models import batch_to_tensors
    from grounded_video_description_torch.ops.kernels import _build

    batch = batch_to_tensors(synthetic_batch(base, B, seed=0), dev)
    L, F = base.seq_length, base.num_sampled_frm
    rates = {}
    for dtype in ("float32", "bfloat16"):
        outs = {}
        for kernels in (True, False):
            # the width is sample_beam's argument: one model serves both
            m = model_of(base.replace(
                dtype=dtype, use_pallas=kernels, use_pallas_rnn=kernels,
                use_pallas_encoder=kernels), state, dev)
            for width in BEAM_WIDTHS:
                _build.reset_launches()
                out = m.sample_beam(batch, beam_size=width)
                torch.cuda.synchronize()
                counts = dict(_build.launches)
                # one encode: K2's two BiGRU layers, K1's two layers
                want = ({"birnn_recurrence": 2, **k1_counts(dtype, 2)}
                        if kernels else {})
                check(counts == want, f"beam {width} {dtype} kernels="
                      f"{kernels} launches {counts} != {want}")
                shapes = [tuple(t.shape) for t in out]
                check(shapes == [(B, L), (B, L), (B, L), (B, L, F)],
                      f"beam {width} {dtype} shapes {shapes}")
                check(bool(torch.isfinite(out[1]).all()),
                      f"beam {width} {dtype} kernels={kernels} logprobs "
                      "not finite")
                check(int(out[2].min()) >= 0 and int(out[2].max()) < R,
                      f"beam {width} {dtype} att2_ind out of range")
                outs[(width, kernels)] = out
                sec = host_s(lambda: m.sample_beam(batch, beam_size=width),
                             3)
                rates[(dtype, width, kernels)] = B / sec
            del m
            torch.cuda.empty_cache()
        for width in BEAM_WIDTHS:
            seq, _, _, frm = outs[(width, True)]
            rseq, _, _, rfrm = outs[(width, False)]
            agree = float((seq == rseq).float().mean())
            live = (seq == rseq) & (rseq > 0)
            frm_agree = float((frm == rfrm)[live].float().mean())
            print(f"beam {width} {dtype}: token agreement {agree:.4f}, "
                  f"att2_frm_ind agreement on {int(live.sum())} live "
                  f"positions {frm_agree:.4f}; beam captions/s kernels "
                  f"{rates[(dtype, width, True)]:.2f}, plain "
                  f"{rates[(dtype, width, False)]:.2f}", flush=True)
            if dtype == "float32":
                check(agree >= 0.99, f"beam {width} f32 token agreement "
                      f"{agree}")
                check(frm_agree >= 0.99, f"beam {width} f32 att2_frm_ind "
                      f"agreement {frm_agree}")


def phase_decode_kernel(dev, results, base, state):
    """K6 at the flagship shapes: the banks of one encoded batch of B
    (T = 480 frames, R = 1000 ROIs, a random fifth of them under the pnt
    mask), 20 steps, vocab 4905; the kernel against its plain twin (the
    step loop, K3 off) on the same banks, in f32 and bf16."""
    import torch
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.models import batch_to_tensors
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.ops.kernels.decode_scan import (
        GEMM_ROUTES, greedy_decode_fused, greedy_decode_fused_plain)

    batch = batch_to_tensors(synthetic_batch(base, B, seed=0), dev)
    g = torch.Generator(device=dev).manual_seed(17)
    pnt = batch["pnt_mask"].bool().clone()
    pnt[:, 1:] |= torch.rand(B, R, generator=g, device=dev) < 0.2
    L = base.seq_length
    for dt in ("float32", "bfloat16"):
        m = model_of(base.replace(dtype=dt, use_pallas=False), state, dev)
        with torch.no_grad():
            enc = m.encode(batch)
            _build.reset_launches()
            got = greedy_decode_fused(m, enc, pnt)
            ref = greedy_decode_fused_plain(m, enc, pnt)
            torch.cuda.synchronize()
            # one launch, its GEMM phases on the dtype's tensor-core route
            want = {"decode_scan": 1, GEMM_ROUTES[getattr(torch, dt)]: 1}
            check(dict(_build.launches) == want,
                  f"K6 {dt} launches {dict(_build.launches)} != {want}")
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
            banks = [enc[k] for k in ("conv_feats", "p_conv_feats",
                                      "pool_feats", "p_pool_feats")]
            gemm_f, attn_f, weights = decode_work(m, B, T_FRAMES, R, L)
            # the products at the tensor cores' rate for the dtype (f32 in
            # 3xTF32), the attention terms at the SIMT f32 rate
            b = bound({attention_rate(dt): gemm_f, "float32": attn_f},
                      nbytes(*banks, pnt, *m.core.parameters(),
                             *m.logit.parameters(), *m.embed.parameters(),
                             *got), dt)
            # what the kernel streams: the banks and the products' weights
            # once a step
            floor_ms = 1e3 * L * (nbytes(*banks) + weights
                                  * banks[0].element_size()) / PEAK_BYTES
            phases, split = decode_phase_split(m, enc, pnt)
        print(f"K6 decode_scan {dt}: token agreement {agree:.4f}, logprob "
              f"err {e_lp:.3e}, grounding logit err {e_grd:.3e}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b['bound_ms']:.3f} ms ({b['bound_by']}), streaming floor "
              f"{floor_ms:.3f} ms; launches {want}", flush=True)
        print(f"K6 {dt} split of a decode (ms, block 0's %globaltimer, "
              f"median of 3): " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in split.items()),
              flush=True)
        print(f"K6 {dt} by phase (ms a decode, its barriers taken out): "
              + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
              flush=True)
        results[("decode_scan", dt)] = dict(
            max_abs_err=max(e_lp, e_grd), ms=ms, plain_ms=plain_ms,
            library_ms=None, stream_floor_ms=floor_ms, phase_ms=split, **b)
        del m, enc, got, ref
        torch.cuda.empty_cache()


def decode_work(model, B_, T_, R_, L):
    """A greedy decode of L steps: (the products' operations, the
    attentions' operations, the products' weight elements).  Per step and
    row the two LSTM cells (the fc part of the attention LSTM's input is
    computed once, before the steps), both h2att projections and the
    vocabulary head, 2 per multiply-add; the temporal and region
    attentions, 3 ops per score column and 2 per weighted-sum column.  The
    next-token embedding is a gather, not counted."""
    core, H = model.core, model.cfg.rnn_size
    A = model.cfg.att_hid_size
    mats = (core.att_lstm.weight_ih.numel() - 4 * H * H
            + core.att_lstm.weight_hh.numel()
            + core.lang_lstm.weight_ih.numel()
            + core.lang_lstm.weight_hh.numel()
            + core.attention.h2att.weight.numel()
            + core.attention2.h2att.weight.numel()
            + model.cfg.vocab_size * H)
    return (L * 2 * B_ * mats, L * B_ * (T_ + R_) * (3 * A + 2 * H), mats)


# K6's ten phases a step (csrc/decode_scan.cu), and how the split groups
# them: the four products, their split sums' epilogues, the two bank
# phases and the finish
DECODE_PHASES = ("att GEMM", "att cell", "h2att GEMM", "h2att bias",
                 "scores", "sums", "lang GEMM", "lang cell", "logit GEMM",
                 "finish")
DECODE_GROUPS = {"GEMM": (0, 2, 6, 8), "GEMM epilogues": (1, 3, 7),
                 "banks": (4, 5), "finish": (9,)}


def decode_phase_split(m, enc, pnt, runs: int = 3):
    """K6's decode split by phase from block 0's %globaltimer stamps
    (``greedy_decode_timed``): each phase's interval ends at the barrier
    after it, so a second launch that runs only the barriers gives their
    cost, taken out of every interval.  Returns (ms a decode by phase, ms
    by group with the barriers and the whole), medians of ``runs``."""
    import torch
    from grounded_video_description_torch.ops.kernels.decode_scan import (
        PHASES, greedy_decode_timed)
    L = m.cfg.seq_length

    def per_phase(barriers_only):
        runs_ms = []
        for _ in range(runs):
            st = greedy_decode_timed(m, enc, pnt,
                                     barriers_only=barriers_only).cpu()
            d = (st[1:] - st[:-1]).double().reshape(L, PHASES) / 1e6
            runs_ms.append(d.sum(0))
        return torch.stack(runs_ms).median(0).values

    full, bars = per_phase(False), per_phase(True)
    work = full - bars
    phases = {name: float(work[i]) for i, name in enumerate(DECODE_PHASES)}
    split = {k: sum(float(work[i]) for i in idx)
             for k, idx in DECODE_GROUPS.items()}
    split[f"{PHASES * L} barriers"] = float(bars.sum())
    split["whole"] = float(full.sum())
    return phases, split


def phase_flash_mha(dev, results):
    """K7 at the obj_interact inference shapes: q/k/v (B * 6, R, 171), the
    six heads of 1024 zero-padded to 171 each, q pre-scaled by
    1/sqrt(1024); f32 and bf16."""
    import torch
    import torch.nn.functional as F
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.ops.kernels.mha import (
        flash_self_attention, flash_self_attention_plain)

    N, d = B * 6, -(-D_RNN // 6)
    g = torch.Generator(device=dev).manual_seed(13)
    base = [torch.randn(N, R, d, generator=g, device=dev) for _ in range(3)]
    base[0] /= math.sqrt(D_RNN)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        q, k, v = (t.to(dt) for t in base)
        _build.reset_launches()
        got = flash_self_attention(q, k, v)
        ref = flash_self_attention_plain(q, k, v)
        torch.cuda.synchronize()
        want = {"flash_self_attention": 1}
        if dt == torch.float32:
            want[TF32_ROUTE] = 1
        check(dict(_build.launches) == want,
              f"K7 {name} launches {dict(_build.launches)}")
        check(got.dtype == dt and got.shape == (N, R, d), "K7 output")
        check(bool(torch.isfinite(got.float()).all()), "K7 not finite")
        err, scaled = max_err(got, ref), ""
        if dt == torch.float32:
            # softmax-weighted means of unit-scale rows over 1000 keys, in
            # f32 in another order: ~1e-7 expected
            check(err <= 1e-5, f"K7 f32 err {err}")
        else:
            scaled = (f" ({check_attention_bf16(got, ref, 'K7 bf16'):.3e} "
                      f"of max |ref|, bar {ATTN_BF16_TOL})")
        ms = time_ms(lambda: flash_self_attention(q, k, v), 5)
        plain_ms = time_ms(lambda: flash_self_attention_plain(q, k, v), 5)
        q4, k4, v4 = (t[:, None] for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0), 5)
        b = bound(4 * N * R * R * d, nbytes(q, k, v, got),
                  attention_rate(name))
        print(f"K7 flash_self_attention {name} ({N} x {R} x {d}): err "
              f"{err:.3e}{scaled}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, "
              f"scaled_dot_product_attention {lib_ms:.3f} ms, bound "
              f"{b['bound_ms']:.3f} ms ({b['bound_by']})", flush=True)
        results[("flash_self_attention", name)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            **b)
        del got, ref, q, k, v
    torch.cuda.empty_cache()


def phase_eval(dev, base, state):
    """The evaluation entry point at the flagship configuration with the
    README's eval flags (language_eval, eval_obj_grounding,
    eval_obj_grounding_gt; the port has no training loop to skip, so no
    inference_only) and the grounding guard on:
    ``Evaluator.evaluate`` and ``Evaluator.eval_grounding_gt`` over two
    batches of B, through the kernels (K6, K7, K2, K3; K1 off by the
    guard) and with every kernel flag off, in f32 and bf16.  Returns the
    launch counts of the kernel runs per dtype."""
    import tempfile
    import torch
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.engine.evaluator import (
        Evaluator, grounding_eval_cfg)
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.ops.kernels.decode_scan import (
        GEMM_ROUTES)
    from grounded_video_description_torch.tools.eval_files import (
        eval_references, eval_vocab)

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

    def counted(counts, items=batches):
        """The batches, with the launch counts of each batch's work."""
        for batch in items:
            _build.reset_launches()
            yield batch
            counts.append(dict(_build.launches))

    launches = {}
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
                    want = dict(per_batch[call]) if kernels else {}
                    if kernels and dtype == "float32":   # K7's route
                        want[TF32_ROUTE] = want["flash_self_attention"]
                    if kernels and "decode_scan" in want:   # K6's GEMMs
                        want[GEMM_ROUTES[getattr(torch, dtype)]] = 1
                    check(got == [want] * len(batches),
                          f"{dtype} kernels={kernels} {call} launches per "
                          f"batch {got} != {want}")
                if kernels:
                    total = launches.setdefault(dtype, {})
                    for got in counts.values():
                        for c in got:
                            for k, n in c.items():
                                total[k] = total.get(k, 0) + n
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

        # beam 3 through the evaluator, f32, over the first batch: the
        # densecap JSON and the words grounded by the best beam's
        # per-frame argmaxes (K7 and K2 in its encode)
        m = model_of(cfg0.replace(
            beam_size=3, use_pallas=True, use_pallas_rnn=True,
            use_pallas_decode=True, use_pallas_mha=True), state, dev)
        counts = []
        stats = Evaluator(m.cfg, m, vocab).evaluate(
            counted(counts, batches[:1]),
            out_dir=os.path.join(root, "beam3"))
        want = {"flash_self_attention": 2, TF32_ROUTE: 2,
                "birnn_recurrence": 2}
        check(counts == [want], f"beam-3 evaluate launches {counts} != "
              f"{[want]}")
        check(all(isinstance(v, str) or math.isfinite(v)
                  for v in stats.values()), f"beam-3 stats {stats}")
        check_eval_files(os.path.join(root, "beam3"), m.cfg,
                         batches[0]["seg_id"],
                         {s.split("_segment_")[0]
                          for s in batches[0]["seg_id"]},
                         kinds=("attn-gen",))
        print(f"eval beam 3 float32 kernels=True: captions/s "
              f"{stats['captions_per_sec']:.2f}; CIDEr "
              f"{stats['CIDEr']:.4f}, grd_f1_all {stats['grd_f1_all']:.4f}",
              flush=True)
        del m
        torch.cuda.empty_cache()
    return launches


def phase_driver(dev, state):
    """The port's training entry point, ``grounded_video_description_torch
    .main.run``, at flagship width with in-memory loaders (the card's
    machine has no h5py for the on-disk dataset): bf16, K5 on, the
    README's training flags; two epochs of one 240-segment step each,
    each validated over one batch of 100 through ``evaluate`` (K6, K7,
    K2) and ``eval_grounding_gt`` (K7, K2, K3; K1 off by the grounding
    guard), with the eval phase's synthetic vocabulary and references,
    checkpoints into a temporary directory.  Then a second trainer of
    other weights restores the latest checkpoint (model, optimizer and
    generator state bit-identical to the saved ones) and a second ``run``
    goes on from epoch 2.  Returns the first run's launch counts."""
    import tempfile
    import torch
    from grounded_video_description_torch import main as driver
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.engine.checkpoint import (
        STATE_FILE, CheckpointManager)
    from grounded_video_description_torch.engine.evaluator import (
        Evaluator, grounding_eval_cfg)
    from grounded_video_description_torch.engine.trainer import Trainer
    from grounded_video_description_torch.models import GVDModel
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.ops.kernels.decode_scan import (
        GEMM_ROUTES)
    from grounded_video_description_torch.tools.eval_files import (
        eval_references, eval_vocab)
    from grounded_video_description_torch.utils.logging import MetricLogger

    base = train_config().replace(
        dtype="bfloat16", use_pallas_encoder_train=True, use_pallas=True,
        use_pallas_rnn=True, use_pallas_decode=True, use_pallas_mha=True,
        use_pallas_encoder=True, pallas_encoder_grounding_guard=True,
        language_eval=True, eval_obj_grounding=True,
        eval_obj_grounding_gt=True, id="driver", val_every_epoch=1,
        max_epochs=2)
    batch = train_batch()
    val = synthetic_batch(base, B, seed=1)
    val["seg_id"] = [f"v_DRV{b:04d}_segment_{b % 3:02d}" for b in range(B)]
    val["n_valid"] = B
    vocab = eval_vocab(base)
    layers = 2 * base.grad_accum          # 2 layers x 8 microbatches
    per_epoch = {"encoder_layer_train_fwd": layers,
                 "encoder_layer_train_bwd": layers, "decode_scan": 1,
                 GEMM_ROUTES[torch.bfloat16]: 1,
                 "flash_self_attention": 4, "birnn_recurrence": 4,
                 "region_attention": base.seq_length,
                 **k5_gemm_counts("bfloat16", layers)}

    def trainer_for(cfg, weights):
        model = GVDModel(cfg)
        model.load_state_dict(weights)
        return Trainer(cfg, model.to(dev))

    with tempfile.TemporaryDirectory() as root:
        cfg = base.replace(checkpoint_path=os.path.join(root, "save"),
                           **eval_references(root, base, vocab, [val]))
        eval_cfg = grounding_eval_cfg(cfg)
        check(not eval_cfg.use_pallas_encoder, "the grounding guard left K1 on")
        out_dir = os.path.join(root, "out")
        ckpt = CheckpointManager(cfg.checkpoint_path)

        def run(cfg, trainer, infos):
            evaluator = Evaluator(eval_cfg, driver.sharing_model(
                trainer.model, eval_cfg), vocab)
            return driver.run(cfg, trainer, evaluator, [batch], [val],
                              ckpt, MetricLogger(), infos, out_dir=out_dir)

        trainer = trainer_for(cfg, state)
        _build.reset_launches()
        records = run(cfg, trainer, {"epoch": 0, "best_val_score": None})
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        want = {k: 2 * n for k, n in per_epoch.items()}
        check(launches == want, f"driver launches {launches} != {want}")
        check([r["epoch"] for r in records] == [0, 1]
              and records[0]["best"], f"driver records {records}")
        for r in records:
            stats = r["stats"]
            for key in ("CIDEr", "Bleu_4", "box_accu_att", "box_accu_grd",
                        "cls_accu"):
                check(key in stats and math.isfinite(stats[key]),
                      f"driver epoch {r['epoch']} stat {key}")
            print(f"driver epoch {r['epoch']}: train {r['train_s']:.3f} s, "
                  f"validation {r['val_s']:.3f} s, save {r['save_s']:.3f} s;"
                  f" CIDEr {stats['CIDEr']:.4f}, best {r['best']}",
                  flush=True)
        check_eval_files(out_dir, eval_cfg, val["seg_id"],
                         {s.split("_segment_")[0] for s in val["seg_id"]})
        with open(os.path.join(cfg.checkpoint_path, "infos.json")) as f:
            infos = json.load(f)
        check(infos["epoch"] == 2 and infos["step"] == 2
              and sorted(infos["histories"]["val"]) == ["0", "1"],
              f"driver infos {infos}")
        check(os.path.isdir(os.path.join(cfg.checkpoint_path, "model-best")),
              "no model-best")

        # crash recovery: other weights, then the latest checkpoint
        other = GVDModel(cfg).init(torch.Generator().manual_seed(1))
        resumed = trainer_for(cfg, other.state_dict())
        t0 = time.perf_counter()
        infos = CheckpointManager(cfg.checkpoint_path).restore(
            resumed, load_best=False)
        restore_s = time.perf_counter() - t0
        blob = torch.load(os.path.join(cfg.checkpoint_path, "model",
                                       STATE_FILE), map_location=dev,
                          weights_only=True)
        for (k, a), b, c in zip(resumed.model.state_dict().items(),
                                blob["model"].values(),
                                trainer.model.state_dict().values()):
            check(torch.equal(a, b) and torch.equal(a, c),
                  f"restored {k} differs")
        sa, sb = (resumed.optimizer.state_dict(),
                  trainer.optimizer.state_dict())
        check(sa["param_groups"] == sb["param_groups"], "optimizer groups")
        for i, st in sb["state"].items():
            for k, v in st.items():
                check(torch.equal(sa["state"][i][k], v),
                      f"restored optimizer state {i} {k} differs")
        check(torch.equal(resumed.generator.get_state(),
                          trainer.generator.get_state()), "generator state")
        check(resumed.step == 2 and infos["epoch"] == 2,
              f"restored step {resumed.step}, infos {infos}")
        del trainer, other, blob
        torch.cuda.empty_cache()
        records = run(cfg.replace(max_epochs=3), resumed, infos)
        check([r["epoch"] for r in records] == [2],
              f"resumed run records {records}")
        print(f"driver resumed at epoch 2 (restore {restore_s:.3f} s, model, "
              f"optimizer and generator bit-identical): train "
              f"{records[0]['train_s']:.3f} s, validation "
              f"{records[0]['val_s']:.3f} s, save {records[0]['save_s']:.3f} "
              f"s", flush=True)
        del resumed
        torch.cuda.empty_cache()
    return launches


def sharpen_decoder(state):
    """The transformer weights ``state`` with every decoder attention
    projection and FFN output times 6: at random weights the input token's
    own embedding wins every argmax (all EOS); scaled sublayers make the
    encodings and the positions decide, so that the captions hold words
    (tests/test_torch_transformer.py does the same)."""
    state = dict(state)
    for k in state:
        if k.startswith("cap_model.decoder.layers.") and (
                k.endswith(("wq.weight", "wk.weight", "wv.weight",
                            "wo.weight", "linear2.weight"))):
            state[k] = state[k] * 6.0
    return state


def phase_transformer(dev, base, state):
    """The Masked-Transformer captioner (``att_model`` "transformer") at
    flagship width (rnn 1024; its decoder 2 layers of 6 heads, d_hidden
    512, cross-attending the conv (B, 480, 1024) and pool (B, 1000, 1024)
    encodings), on seeded random weights with the decoder sharpened
    (``sharpen_decoder``): ``sample_greedy`` at B = 100 in f32 and bf16
    through K1 and K2 and on the plain path (f32 tokens >= 0.99 equal,
    captions/s from CUDA events); ``phase_train`` through K5 and the plain
    attention (an f32 step at dropout 0 each, losses 1e-4 relative, grad
    norm 1e-3; three bf16 steps each, in turns, for segments/s);
    ``Evaluator.evaluate`` over one batch of 100 (densecap and attn-gen
    JSONs whole).  Then ``quantize_banks`` greedy on the TopDown
    flagship's weights (``state``; the transformer refuses the flag) in
    f32 and bf16, through K1, K2 and K3, beside the same decode over the
    unquantized banks: captions/s and token agreement."""
    import tempfile
    import torch
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.engine.evaluator import (
        Evaluator, grounding_eval_cfg)
    from grounded_video_description_torch.models import (
        GVDModel, batch_to_tensors)
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.tools.eval_files import (
        eval_references, eval_vocab)

    tf = base.replace(att_model="transformer")
    t0 = time.perf_counter()
    tf_state = sharpen_decoder(GVDModel(tf).init(
        torch.Generator().manual_seed(0)).state_dict())
    print(f"transformer weights {time.perf_counter() - t0:.1f} s",
          flush=True)
    L = base.seq_length
    arrays = synthetic_batch(base, B, seed=0)
    batch = batch_to_tensors(arrays, dev)

    def greedy(cfg, weights, want, tag):
        """sample_greedy of a model of ``cfg``: its outputs (finite, the
        launches ``want``) and captions/s."""
        m = model_of(cfg, weights, dev)
        _build.reset_launches()
        out = m.sample_greedy(batch)
        torch.cuda.synchronize()
        got = dict(_build.launches)
        check(got == want, f"{tag} launches {got} != {want}")
        check(tuple(out[0].shape) == (B, L), f"{tag} seq shape")
        check(all(bool(torch.isfinite(t.float()).all()) for t in out),
              f"{tag} outputs not finite")
        rate = B / (time_ms(lambda: m.sample_greedy(batch), 3) / 1e3)
        del m
        torch.cuda.empty_cache()
        return out, rate

    # (a) greedy, f32 and bf16, K1 and K2 in the encode, and plain
    for dtype in ("float32", "bfloat16"):
        outs, rates = {}, {}
        for kernels in (True, False):
            outs[kernels], rates[kernels] = greedy(
                tf.replace(dtype=dtype, use_pallas=kernels,
                           use_pallas_rnn=kernels,
                           use_pallas_encoder=kernels), tf_state,
                ({"birnn_recurrence": 2, **k1_counts(dtype, 2)} if kernels
                 else {}), f"transformer greedy {dtype} kernels={kernels}")
        seq, lp, att2, _ = outs[True]
        check(tuple(att2.shape) == (B, L, R) and not att2.any()
              and not lp.any(), "transformer greedy: logprobs and att2 "
              "must be zeros")
        agree = float((seq == outs[False][0]).float().mean())
        words = int(torch.unique(seq[seq > 0]).numel())
        print(f"transformer greedy {dtype}: token agreement {agree:.4f} "
              f"({words} distinct words, {float((seq > 0).float().mean()):.3f}"
              f" of tokens not EOS); captions/s kernels {rates[True]:.2f}, "
              f"plain {rates[False]:.2f}", flush=True)
        if dtype == "float32":
            check(agree >= 0.99, f"transformer f32 token agreement {agree}")

    # (b) the train step through K5 and the plain attention: f32 at
    # dropout 0 against each other, bf16 segments/s
    phase_train(dev, tf_state, "transformer",
                {name: TRAIN_PATHS[name] for name in ("K5", "plain")})

    # (c) the evaluator over one batch of B, f32, its JSONs whole
    arrays["seg_id"] = [f"v_TF{b:04d}_segment_{b % 3:02d}" for b in range(B)]
    arrays["n_valid"] = B
    vocab = eval_vocab(base)
    with tempfile.TemporaryDirectory() as root:
        cfg = grounding_eval_cfg(tf.replace(
            language_eval=True, eval_obj_grounding=True, id="transformer",
            **eval_references(root, base, vocab, [arrays])))
        m = model_of(cfg, tf_state, dev)
        _build.reset_launches()
        stats = Evaluator(cfg, m, vocab).evaluate(
            [arrays], out_dir=os.path.join(root, "out"))
        got = dict(_build.launches)
        want = {"birnn_recurrence": 2}
        if cfg.use_pallas_encoder:
            want.update(k1_counts("float32", 2))
        check(got == want, f"transformer evaluate launches {got} != {want}")
        check(all(isinstance(v, str) or math.isfinite(v)
                  for v in stats.values()), f"evaluate stats {stats}")
        check_eval_files(os.path.join(root, "out"), cfg, arrays["seg_id"],
                         {s.split("_segment_")[0] for s in arrays["seg_id"]},
                         kinds=("attn-gen",))
        print(f"transformer evaluate float32: captions/s "
              f"{stats['captions_per_sec']:.2f}; CIDEr "
              f"{stats['CIDEr']:.4f}, grd_f1_all "
              f"{stats['grd_f1_all']:.4f}", flush=True)
        del m
        torch.cuda.empty_cache()

    # (d) int8 banks: the TopDown flagship's step loop (K1, K2, K3) over
    # quantized and over unquantized banks
    for dtype in ("float32", "bfloat16"):
        want = {"birnn_recurrence": 2, "region_attention": L,
                **k1_counts(dtype, 2)}
        outs, rates = {}, {}
        for q in (True, False):
            outs[q], rates[q] = greedy(
                base.replace(dtype=dtype, quantize_banks=q), state, want,
                f"greedy {dtype} quantize_banks={q}")
        agree = float((outs[True][0] == outs[False][0]).float().mean())
        print(f"quantize_banks greedy {dtype} (group 128): token agreement "
              f"with unquantized banks {agree:.4f}; captions/s int8 banks "
              f"{rates[True]:.2f}, unquantized {rates[False]:.2f}",
              flush=True)

# --------------------------------------------------------------------- #
# data parallelism (grounded_video_description_torch/parallel)
# --------------------------------------------------------------------- #

DP_WORLD = 2
DP_TIMEOUT_S = 480      # of each spawned group
# (train path, dtype, steps): f32 at dropout 0 through K5 and K4 (one step
# each, held against one device), bf16 at the flagship rates through K5
# (step 0 held, steps 1-2 timed)
DP_RUNS = (("K5", "float32", 1), ("K4", "float32", 1),
           ("K5", "bfloat16", 3))
# the model axis: two ranks on cuda:0 that split the vocab head (padded
# to 4906 rows), each on the whole batch; bf16 step 0 held, step 1 timed
TP_SHAPE = (1, 2)
TP_RUNS = (("K5", "float32", 1), ("K4", "float32", 1),
           ("K5", "bfloat16", 2))


def train_step_counts(path: str, dt: str, accum: int) -> dict:
    """The kernel launches of one train step through ``path`` (2 layers
    a microbatch), on one device or on each rank."""
    if path == "K5":
        return {"encoder_layer_train_fwd": 2 * accum,
                "encoder_layer_train_bwd": 2 * accum,
                **k5_gemm_counts(dt, 2 * accum)}
    counts = {"attention_train_fwd": 2 * accum,
              "attention_train_bwd": 2 * accum}
    if dt == "float32":
        counts[TF32_ROUTE] = 4 * accum
    return counts


def save_batch(directory, batch):
    """A batch's arrays as .npy files (and its seg_id list) under
    ``directory``, for the ranks to load."""
    import numpy as np
    os.makedirs(directory, exist_ok=True)
    for k, v in batch.items():
        if k == "seg_id":
            with open(os.path.join(directory, "seg_id.json"), "w") as f:
                json.dump(list(v), f)
        elif k != "n_valid":
            np.save(os.path.join(directory, f"{k}.npy"), v)


def load_batch(directory):
    import numpy as np
    batch = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if name == "seg_id.json":
            with open(path) as f:
                batch["seg_id"] = json.load(f)
                batch["n_valid"] = len(batch["seg_id"])
        else:
            batch[name[:-4]] = np.load(path)
    return batch


def dp_train_runs(dev, state, batch, mesh, runs=DP_RUNS, vocab_pad_to=1):
    """``runs`` from the weights ``state`` on ``batch`` (the whole batch
    on one device, the rank's rows under ``mesh``): per run each step's
    metrics, seconds and launches (held to ``train_step_counts``), the
    peak device memory, and in bf16 under a mesh the time of the gradient
    all-reduce alone over the data axis (``all_reduce_sum_`` of one f32
    tensor per parameter, as ``all_reduce_grads_sum`` runs it) or, on a
    model axis, of one all-gather of a microbatch's logits
    (``parallel.tensor.gather_model``)."""
    import torch
    from grounded_video_description_torch.engine.trainer import (
        Trainer, batch_to_device)
    from grounded_video_description_torch.models import GVDModel
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.parallel import tensor as tp
    from grounded_video_description_torch.parallel.mesh import (
        all_reduce_sum_, barrier)

    base = train_config().replace(vocab_pad_to=vocab_pad_to)
    out = {}
    for path, dt, steps in runs:
        cfg = base.replace(dtype=dt, **TRAIN_PATHS[path])
        if dt == "float32":
            cfg = cfg.replace(drop_prob_lm=0.0, loc_drop=0.0, enc_drop=0.0)
        model = GVDModel(cfg)
        model.load_state_dict(state)
        tr = Trainer(cfg, model.to(dev), mesh=mesh)
        dev_batch = batch_to_device(cfg, batch, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"metrics": [], "s": []}
        want = train_step_counts(path, dt, cfg.grad_accum)
        for i in range(steps):
            _build.reset_launches()
            t0 = time.perf_counter()
            m = tr.train_step(dev_batch, cfg.learning_rate)
            torch.cuda.synchronize()
            rec["s"].append(time.perf_counter() - t0)
            got = dict(_build.launches)
            check(got == want, f"{path} {dt} step {i} launches {got} != "
                  f"{want}")
            rec["metrics"].append({k: float(v) for k, v in m.items()})
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if mesh is not None and mesh.data > 1 and dt == "bfloat16":
            grads = [torch.ones_like(p) for p in tr.params]
            rec["allreduce_mb"] = nbytes(*grads) / 2 ** 20
            times = []
            for _ in range(3):
                barrier(mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                all_reduce_sum_(mesh.data_group, grads)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            rec["allreduce_ms"] = statistics.median(times)
            del grads
        if mesh is not None and mesh.model > 1 and dt == "bfloat16":
            shard = tp.shard_of(tr.model)
            rows = cfg.batch_size // cfg.grad_accum * cfg.seq_length
            part = torch.ones(rows, tr.model.logit.weight.shape[0],
                              dtype=tr.model.dtype, device=dev)
            rec["gather_mb"] = mesh.model * nbytes(part) / 2 ** 20
            times = []
            for _ in range(3):
                barrier(mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tp.gather_model(part, -1, shard)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            rec["gather_ms"] = statistics.median(times)
            del part
        out[f"{path} {dt}"] = rec
        del tr, model, dev_batch
        torch.cuda.empty_cache()
    return out


def dp_eval_cfg(base, refs):
    """The eval phase's configuration (the README's eval flags, the
    grounding guard, so K1 is off) with the reference files ``refs``."""
    from grounded_video_description_torch.engine.evaluator import (
        grounding_eval_cfg)
    return grounding_eval_cfg(base.replace(
        language_eval=True, eval_obj_grounding=True,
        eval_obj_grounding_gt=True, use_pallas_encoder=True,
        pallas_encoder_grounding_guard=True, id="dp", **refs))


def dp_eval_runs(dev, cfg0, state, vocab, val, mesh, out_root):
    """``Evaluator.evaluate`` (greedy) and ``eval_grounding_gt`` over the
    batch ``val`` in f32 through the kernels (K6, K7, K2, K3) and on the
    plain path, on one device or sharded over ``mesh``: each call's
    outputs as host arrays (``generate``, ``ground``; rank 0 gets the
    whole batch's), its seconds after a warm-up decode, its launches (held
    to a decode and a grounding forward of the rank's rows), and the
    stats."""
    import torch
    from grounded_video_description_torch.engine.evaluator import Evaluator
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.ops.kernels.decode_scan import (
        GEMM_ROUTES)
    from grounded_video_description_torch.parallel import shard_model

    arrays = {k: v for k, v in val.items() if k not in ("seg_id", "n_valid")}
    out = {}
    for kernels in (True, False):
        flags = dict(use_pallas=kernels, use_pallas_rnn=kernels,
                     use_pallas_decode=kernels, use_pallas_mha=kernels)
        m = model_of(cfg0.replace(**flags), state, dev)
        # as the driver's trainer holds it: on a model axis, its slice of
        # the head (the evaluator gathers it whole)
        shard_model(m, mesh)
        ev = Evaluator(m.cfg, m, vocab, mesh)
        rec = {"gen": [], "grd": []}
        generate, ground = ev.generate, ev.ground

        def recorded_generate(a):
            rec["gen"].append(generate(a))
            return rec["gen"][-1]

        def recorded_ground(a):
            rec["grd"].append(ground(a))
            return rec["grd"][-1]

        generate(arrays)                          # warm-up, not counted
        torch.cuda.synchronize()
        ev.generate, ev.ground = recorded_generate, recorded_ground
        out_dir = os.path.join(out_root, f"kernels-{kernels}")
        _build.reset_launches()
        t0 = time.perf_counter()
        stats = ev.evaluate([val], out_dir=out_dir)
        t1 = time.perf_counter()
        stats.update(ev.eval_grounding_gt([val], out_dir=out_dir))
        rec["evaluate_s"] = t1 - t0
        rec["grounding_s"] = time.perf_counter() - t1
        got = dict(_build.launches)
        want = {}
        if kernels:
            want = {"decode_scan": 1, GEMM_ROUTES[torch.float32]: 1,
                    "flash_self_attention": 4, TF32_ROUTE: 4,
                    "birnn_recurrence": 4,
                    "region_attention": cfg0.seq_length}
        check(got == want, f"eval kernels={kernels} launches {got} != "
              f"{want}")
        for k, v in stats.items():
            check(isinstance(v, str) or math.isfinite(v),
                  f"eval kernels={kernels} stat {k} = {v}")
        rec["stats"], rec["out_dir"] = stats, out_dir
        out[kernels] = rec
        del m, ev
        torch.cuda.empty_cache()
    return out


def dp_rank(rank, tmp, cfg0, vocab):
    """Rank ``rank`` of ``DP_WORLD`` on cuda:0 over gloo: ``dp_train_runs``
    on its rows, then ``dp_eval_runs`` on the shared validation batch;
    its results to ``tmp``."""
    sys.path.insert(0, ROOT)
    import torch
    from grounded_video_description_torch.parallel import (
        close_mesh, init_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # NCCL refuses two ranks on one device; gloo runs the collectives on
    # CUDA tensors by staging them through the host
    mesh = init_mesh(dev, shape=(DP_WORLD, 1), rank=rank,
                     init_method=f"file://{tmp}/rdzv", backend="gloo")
    try:
        state = torch.load(os.path.join(tmp, "state.pt"), weights_only=True)
        out = {"train": dp_train_runs(dev, state, load_batch(
            os.path.join(tmp, f"rows{rank}")), mesh)}
        out["eval"] = dp_eval_runs(dev, cfg0, state, vocab, load_batch(
            os.path.join(tmp, "val")), mesh, os.path.join(tmp, "dp"))
    finally:
        close_mesh(mesh)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def tp_rank(rank, tmp, cfg0, vocab):
    """Rank ``rank`` of the (1, 2) mesh ``TP_SHAPE`` on cuda:0 over gloo:
    ``dp_train_runs`` of ``TP_RUNS`` on the whole batch (one data index)
    with the vocab head split in two, then ``dp_eval_runs`` on the
    validation batch; its results to ``tmp``."""
    sys.path.insert(0, ROOT)
    import torch
    from grounded_video_description_torch.parallel import (
        close_mesh, init_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = init_mesh(dev, shape=TP_SHAPE, rank=rank,
                     init_method=f"file://{tmp}/rdzv-tp", backend="gloo")
    try:
        state = torch.load(os.path.join(tmp, "state-tp.pt"),
                           weights_only=True)
        out = {"train": dp_train_runs(
            dev, state, whole_batch(tmp, train_config().grad_accum), mesh,
            runs=TP_RUNS, vocab_pad_to=TP_SHAPE[1])}
        out["eval"] = dp_eval_runs(dev, cfg0, state, vocab, load_batch(
            os.path.join(tmp, "val")), mesh, os.path.join(tmp, "tp"))
    finally:
        close_mesh(mesh)
    torch.save(out, os.path.join(tmp, f"tp{rank}.pt"))


def dp_nccl(rank, tmp, cfg, vocab):
    """The driver's path on one NCCL rank (world size 1) on cuda:0:
    ``main.run`` for one epoch of one bf16 step through K5, validated
    over the validation batch (K6, K7, K2, K3) and checkpointed, every
    collective of the trainer, evaluator and checkpoint on NCCL."""
    sys.path.insert(0, ROOT)
    import torch
    from grounded_video_description_torch import main as driver
    from grounded_video_description_torch.engine.checkpoint import (
        CheckpointManager)
    from grounded_video_description_torch.engine.evaluator import (
        Evaluator, grounding_eval_cfg)
    from grounded_video_description_torch.engine.trainer import Trainer
    from grounded_video_description_torch.models import GVDModel
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.parallel import (
        close_mesh, init_mesh)
    from grounded_video_description_torch.utils.logging import MetricLogger

    dev = torch.device("cuda", 0)
    mesh = init_mesh(dev, shape=(1, 1), rank=0,
                     init_method=f"file://{tmp}/rdzv-nccl")
    try:
        check(torch.distributed.get_backend() == "nccl", "not on NCCL")
        model = GVDModel(cfg)
        model.load_state_dict(torch.load(os.path.join(tmp, "state.pt"),
                                         weights_only=True))
        trainer = Trainer(cfg, model.to(dev), mesh=mesh)
        eval_cfg = grounding_eval_cfg(cfg)
        evaluator = Evaluator(eval_cfg, driver.sharing_model(
            trainer.model, eval_cfg), vocab, mesh)
        _build.reset_launches()
        t0 = time.perf_counter()
        records = driver.run(
            cfg, trainer, evaluator, [whole_batch(tmp, cfg.grad_accum)],
            [load_batch(os.path.join(tmp, "val"))],
            CheckpointManager(cfg.checkpoint_path, mesh), MetricLogger(),
            {"epoch": 0, "best_val_score": None},
            out_dir=os.path.join(tmp, "nccl"))
        torch.cuda.synchronize()
        out = {"records": records, "s": time.perf_counter() - t0,
               "launches": dict(_build.launches)}
    finally:
        close_mesh(mesh)
    torch.save(out, os.path.join(tmp, "nccl.pt"))


def whole_batch(tmp, accum):
    """The train batch from the ranks' rows: each microbatch is rank 0's
    slice of it, then rank 1's (``shard_rows``)."""
    import numpy as np
    parts = [load_batch(os.path.join(tmp, f"rows{r}"))
             for r in range(DP_WORLD)]
    return {k: np.concatenate([
        np.stack(np.split(p[k], accum)) for p in parts], axis=1).reshape(
            (-1,) + parts[0][k].shape[1:]) for k in parts[0]}


def dp_row0(dev, results):
    """K4 and K5 on rank 1's rows of a flagship microbatch at D = 2: 15
    rows from row0 = 15, drop 0.2, f32 and bf16, the kernel against its
    plain version at the same row0 (output and gradients, at the K4 and
    K5 phases' bars); the errors go to the kernels' rows as
    ``row0_max_abs_err``."""
    import torch
    from grounded_video_description_torch.ops.kernels.attention_train \
        import mha_probs_dropout, mha_probs_dropout_plain
    from grounded_video_description_torch.ops.kernels.encoder_layer_train \
        import fused_encoder_layer_train, fused_encoder_layer_train_plain

    Bm, row0, drop = 15, 15, 0.2
    g = torch.Generator(device=dev).manual_seed(13)
    base = [torch.randn(Bm, R, D_RNN, generator=g, device=dev)
            for _ in range(4)]
    seed = torch.tensor([0x9E3779B9], device=dev)
    enc, x0, cot, _ = k5_layer(dev, Bm)
    lw = list(enc.layers[0].weights())
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        q, k, v, w = (t.to(dt) for t in base)
        runs = []
        for fn in (mha_probs_dropout, mha_probs_dropout_plain):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = fn(*leaves, seed, n_heads=6, scale=D_RNN ** 0.5, drop=drop,
                   row0=row0)
            runs.append([o.detach()] + list(torch.autograd.grad(
                o, leaves, w)))
        errs = {}
        for part, a, b in zip(("out", "dq", "dk", "dv"), *runs):
            check(bool(torch.isfinite(a.float()).all()),
                  f"K4 {name} row0 {part} not finite")
            errs[part] = max_err(a, b)
            if dt == torch.float32:
                check(errs[part] <= 1e-4,
                      f"K4 f32 row0 {part} err {errs[part]}")
            else:
                check_attention_bf16(a, b, f"K4 bf16 row0 {part}")
        results[("attention_train_fwd", name)]["row0_max_abs_err"] = \
            errs["out"]
        results[("attention_train_bwd", name)]["row0_max_abs_err"] = max(
            errs["dq"], errs["dk"], errs["dv"])
        x, w5 = x0.to(dt), cot.to(dt)
        runs = []
        for fn in (fused_encoder_layer_train, fused_encoder_layer_train_plain):
            xl = x.clone().requires_grad_(True)
            o = fn(xl, enc.layers[0].weights(), seed, n_heads=6, drop=drop,
                   row0=row0)
            runs.append([o.detach()] + list(torch.autograd.grad(
                o, [xl] + lw, w5)))
        ties = k5_ties(x, enc.layers[0].weights(), seed, drop, row0)
        res = k5_held(runs[0], runs[1], name, ties)
        for part, (err, ratio, rel) in res.items():
            check(ratio <= 1.0, f"K5 {name} row0 {part}: err {err}, "
                  f"relative norm {rel}: {ratio:.3g} of its bar")
        results[("encoder_layer_train_fwd", name)]["row0_max_abs_err"] = \
            res["out"][0]
        results[("encoder_layer_train_bwd", name)]["row0_max_abs_err"] = max(
            r[0] for p, r in res.items() if p != "out")
        print(f"row0 {row0} ({Bm} rows, drop {drop}) {name}: K4 err "
              f"{ {p: f'{e:.3e}' for p, e in errs.items()} }; K5 max err "
              f"out {res['out'][0]:.3e}, grads "
              f"{max(r[0] for p, r in res.items() if p != 'out'):.3e}",
              flush=True)
        del runs
        torch.cuda.empty_cache()


def phase_data_parallel(dev, base, state, results):
    """The data-parallel train step and evaluation
    (``grounded_video_description_torch.parallel``) at flagship width:
    K4 and K5 at a row offset (``dp_row0``); the train step of
    ``DP_RUNS`` and the evaluation of ``dp_eval_runs`` on one device,
    then on two gloo ranks sharing cuda:0 (``dp_rank``, one process each:
    NCCL refuses two ranks on one device), held against one device: f32
    losses within 1e-4 relative and the gradient norm within 1e-3, bf16
    finite and its losses within 1e-2, both ranks' metrics equal; f32
    eval tokens and grounding argmaxes >= 0.99 equal through the kernels
    and equal on the plain path; then one epoch of the driver's path on
    one NCCL rank (``dp_nccl``).  Each group of processes has a time
    limit, and a rank that fails fails the phase."""
    import tempfile
    import torch
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.ops.kernels.decode_scan import (
        GEMM_ROUTES)
    from grounded_video_description_torch.parallel import shard_rows, spawn
    from grounded_video_description_torch.tools.eval_files import (
        eval_references, eval_vocab)

    dp_row0(dev, results)
    t0 = time.perf_counter()
    tcfg = train_config()
    train = train_batch()
    val = synthetic_batch(base, B, seed=1)
    val["seg_id"] = [f"v_DP{b:04d}_segment_{b % 3:02d}" for b in range(B)]
    val["n_valid"] = B
    vocab = eval_vocab(base)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(state, os.path.join(tmp, "state.pt"))
        for r in range(DP_WORLD):
            rows = shard_rows(tcfg.batch_size, tcfg.grad_accum, r, DP_WORLD)
            save_batch(os.path.join(tmp, f"rows{r}"),
                       {k: v[rows] for k, v in train.items()
                        if k != "seg_id"})
        save_batch(os.path.join(tmp, "val"), val)
        cfg0 = dp_eval_cfg(base, eval_references(tmp, base, vocab, [val]))
        print(f"data parallel set-up (batches, their files) "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        t0 = time.perf_counter()
        one = {"train": dp_train_runs(dev, state, train, None),
               "eval": dp_eval_runs(dev, cfg0, state, vocab, val, None,
                                    os.path.join(tmp, "one"))}
        torch.cuda.empty_cache()
        print(f"data parallel: one device's steps and evaluation "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        spawn(dp_rank, DP_WORLD, (tmp, cfg0, vocab), timeout_s=DP_TIMEOUT_S)
        group_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]

        # the train step
        terms = ("loss", "lm_loss", "att2_loss", "ground_loss", "cls_loss")
        summary = {"group_s": group_s}
        for run, ref in one["train"].items():
            got = [r["train"][run] for r in ranks]
            check(all(g["metrics"] == got[0]["metrics"] for g in got),
                  f"{run}: the ranks' metrics differ")
            a, b = got[0]["metrics"][0], ref["metrics"][0]
            for k in terms + ("grad_norm",):
                check(math.isfinite(a[k]), f"{run} {k} = {a[k]}")
                tol = (1e-2 if "bfloat16" in run
                       else 1e-3 if k == "grad_norm" else 1e-4)
                check(abs(a[k] - b[k]) <= tol * abs(b[k]),
                      f"{run} {k}: 2 ranks {a[k]} vs one device {b[k]}")
            rel = max(abs(a[k] - b[k]) / abs(b[k]) for k in terms)
            timed_s = (lambda s: statistics.median(s[1:]) if len(s) > 1
                       else s[0])
            one_s = timed_s(ref["s"])
            dp_s = max(timed_s(g["s"]) for g in got)
            summary[run] = dict(
                one_step_s=one_s, dp_step_s=dp_s,
                one_seg_per_s=tcfg.batch_size / one_s,
                dp_seg_per_s=tcfg.batch_size / dp_s,
                one_peak_gb=ref["peak_gb"],
                dp_peak_gb=max(g["peak_gb"] for g in got),
                loss_rel_err=rel,
                grad_norm_rel_err=abs(a["grad_norm"] - b["grad_norm"])
                / abs(b["grad_norm"]))
            if "allreduce_ms" in got[0]:
                summary[run]["allreduce_ms"] = max(g["allreduce_ms"]
                                                   for g in got)
                summary[run]["allreduce_mb"] = got[0]["allreduce_mb"]
            print(f"data parallel train {run}: 2 gloo ranks on cuda:0 vs one "
                  f"device: max loss rel err {rel:.2e}, grad norm "
                  f"{a['grad_norm']:.6f} / {b['grad_norm']:.6f}; step "
                  f"{dp_s:.3f} s vs {one_s:.3f} s ("
                  f"{tcfg.batch_size / dp_s:.2f} vs "
                  f"{tcfg.batch_size / one_s:.2f} segments/s); peak GB per "
                  f"rank {summary[run]['dp_peak_gb']:.2f} (one device "
                  f"{ref['peak_gb']:.2f})"
                  + (f"; gradient all-reduce "
                     f"{summary[run]['allreduce_ms']:.1f} ms for "
                     f"{summary[run]['allreduce_mb']:.0f} MB"
                     if "allreduce_ms" in summary[run] else ""),
                  flush=True)

        # the evaluation
        frames = (-1, base.seq_length, base.num_sampled_frm,
                  base.num_prop_per_frm)
        for kernels, ref in one["eval"].items():
            got = ranks[0]["eval"][kernels]
            check(ranks[1]["eval"][kernels]["stats"] == got["stats"],
                  f"eval kernels={kernels}: the ranks' stats differ")
            check_eval_files(got["out_dir"], cfg0, val["seg_id"],
                             {s.split("_segment_")[0] for s in val["seg_id"]})
            agree = {}
            for key, get in (
                    ("tokens", lambda o: o["gen"][0]["seq"]),
                    ("gen att2_ind", lambda o: o["gen"][0]["att2_weights"]
                     .reshape(frames).argmax(-1)),
                    ("gt att2_ind", lambda o: o["grd"][0]["att2_ind"]),
                    ("gt grd_ind", lambda o: o["grd"][0]["grd_ind"])):
                agree[key] = float((get(got) == get(ref)).mean())
                bar = 0.99 if kernels else 1.0
                check(agree[key] >= bar, f"eval kernels={kernels} {key}: "
                      f"2 ranks vs one device agreement {agree[key]}")
            summary[f"eval kernels={kernels}"] = dict(
                agreement=agree, one_evaluate_s=ref["evaluate_s"],
                dp_evaluate_s=got["evaluate_s"],
                one_grounding_s=ref["grounding_s"],
                dp_grounding_s=got["grounding_s"])
            print(f"data parallel eval f32 kernels={kernels}: 2 ranks vs one "
                  f"device agreement "
                  + ", ".join(f"{k} {v:.4f}" for k, v in agree.items())
                  + f"; evaluate {got['evaluate_s']:.3f} s vs "
                  f"{ref['evaluate_s']:.3f} s, eval_grounding_gt "
                  f"{got['grounding_s']:.3f} s vs {ref['grounding_s']:.3f} s",
                  flush=True)

        summary["model_axis"] = model_axis_runs(dev, tmp, base, state,
                                                cfg0, vocab, val, one)

        # the driver's path on one NCCL rank
        ncfg = tcfg.replace(
            dtype="bfloat16", use_pallas_encoder_train=True, use_pallas=True,
            use_pallas_rnn=True, use_pallas_decode=True, use_pallas_mha=True,
            use_pallas_encoder=True, pallas_encoder_grounding_guard=True,
            language_eval=True, eval_obj_grounding=True,
            eval_obj_grounding_gt=True, id="nccl", val_every_epoch=1,
            max_epochs=1, checkpoint_path=os.path.join(tmp, "save"),
            **{k: getattr(cfg0, k) for k in ("grd_reference", "split_file",
                                             "densecap_references",
                                             "data_path")})
        t0 = time.perf_counter()
        spawn(dp_nccl, 1, (tmp, ncfg, vocab), timeout_s=DP_TIMEOUT_S)
        summary["nccl_s"] = time.perf_counter() - t0
        nccl = torch.load(os.path.join(tmp, "nccl.pt"), weights_only=False)
        want = {**train_step_counts("K5", "bfloat16", ncfg.grad_accum),
                "decode_scan": 1, GEMM_ROUTES[torch.bfloat16]: 1,
                "flash_self_attention": 4, "birnn_recurrence": 4,
                "region_attention": ncfg.seq_length}
        check(nccl["launches"] == want,
              f"NCCL driver launches {nccl['launches']} != {want}")
        rec = nccl["records"]
        check([r["epoch"] for r in rec] == [0], f"NCCL driver records {rec}")
        for key in ("CIDEr", "box_accu_att", "box_accu_grd"):
            check(math.isfinite(rec[0]["stats"][key]),
                  f"NCCL driver stat {key}")
        with open(os.path.join(ncfg.checkpoint_path, "infos.json")) as f:
            infos = json.load(f)
        check(infos["epoch"] == 1 and infos["step"] == 1,
              f"NCCL driver infos {infos}")
        summary["nccl_world1"] = dict(train_s=rec[0]["train_s"],
                                      val_s=rec[0]["val_s"],
                                      save_s=rec[0]["save_s"])
        print(f"data parallel NCCL world size 1, the driver's path: train "
              f"{rec[0]['train_s']:.3f} s, validation {rec[0]['val_s']:.3f} "
              f"s, save {rec[0]['save_s']:.3f} s; launches as one device's",
              flush=True)
    print("data_parallel " + json.dumps(summary), flush=True)
    return summary


def padded_head(state, rows: int):
    """``state`` with the vocab head padded by zero rows to ``rows``
    (the pad columns are masked before the log-softmax, so the padded
    model computes the unpadded one's log-probabilities)."""
    import torch
    out = dict(state)
    for key in ("logit.weight", "logit.bias"):
        w = state[key]
        out[key] = torch.cat([w, w.new_zeros((rows - w.shape[0],)
                                             + tuple(w.shape[1:]))])
    return out


def model_axis_runs(dev, tmp, base, state, cfg0, vocab, val, one):
    """The model axis (``parallel/tensor.py``) at flagship width: two
    gloo ranks sharing cuda:0 as a (1, 2) mesh (``tp_rank``), each
    holding half of the vocab head padded to 4906 rows, on the whole
    train batch: ``TP_RUNS`` held against one device's steps of
    ``phase_data_parallel`` (``one``; f32 losses within 1e-4 relative,
    grad norm within 1e-3; bf16 at the flagship dropout within 1e-2), the
    two ranks' metrics equal, step seconds and peak GB per rank beside
    one device's, and one logits all-gather's ms; then ``evaluate`` and
    ``eval_grounding_gt`` over the batch of 100, rows split 50 / 50 on
    the whole model each evaluation gathers, f32, through the kernels (K6
    counted on each rank) and plain, against one device on the padded
    weights: tokens and the three argmax sets >= 0.998 equal through the
    kernels and equal on the plain path."""
    import torch
    from grounded_video_description_torch.parallel import spawn

    vp = base.replace(vocab_pad_to=TP_SHAPE[1]).vocab_size_padded
    tp_state = padded_head(state, vp)
    torch.save(tp_state, os.path.join(tmp, "state-tp.pt"))
    cfg_tp = cfg0.replace(vocab_pad_to=TP_SHAPE[1])
    t0 = time.perf_counter()
    one_eval = dp_eval_runs(dev, cfg_tp, tp_state, vocab, val, None,
                            os.path.join(tmp, "one-tp"))
    torch.cuda.empty_cache()
    one_eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spawn(tp_rank, TP_SHAPE[0] * TP_SHAPE[1], (tmp, cfg_tp, vocab),
          timeout_s=DP_TIMEOUT_S)
    summary = {"vocab_padded": vp, "one_eval_s": one_eval_s,
               "group_s": time.perf_counter() - t0}
    ranks = [torch.load(os.path.join(tmp, f"tp{r}.pt"), weights_only=False)
             for r in range(TP_SHAPE[0] * TP_SHAPE[1])]
    terms = ("loss", "lm_loss", "att2_loss", "ground_loss", "cls_loss")
    batch = train_config().batch_size
    for path, dt, _ in TP_RUNS:
        run = f"{path} {dt}"
        ref = one["train"][run]
        got = [r["train"][run] for r in ranks]
        check(all(g["metrics"] == got[0]["metrics"] for g in got),
              f"model axis {run}: the ranks' metrics differ")
        a, b = got[0]["metrics"][0], ref["metrics"][0]
        for k in terms + ("grad_norm",):
            check(math.isfinite(a[k]), f"model axis {run} {k} = {a[k]}")
            tol = (1e-2 if dt == "bfloat16"
                   else 1e-3 if k == "grad_norm" else 1e-4)
            check(abs(a[k] - b[k]) <= tol * abs(b[k]),
                  f"model axis {run} {k}: {TP_SHAPE} {a[k]} vs one device "
                  f"{b[k]}")
        one_s = statistics.median(ref["s"][1:] or ref["s"])
        tp_s = max(statistics.median(g["s"][1:] or g["s"]) for g in got)
        rec = dict(one_step_s=one_s, tp_step_s=tp_s,
                   one_seg_per_s=batch / one_s, tp_seg_per_s=batch / tp_s,
                   one_peak_gb=ref["peak_gb"],
                   tp_peak_gb=max(g["peak_gb"] for g in got),
                   loss_rel_err=max(abs(a[k] - b[k]) / abs(b[k])
                                    for k in terms),
                   grad_norm_rel_err=abs(a["grad_norm"] - b["grad_norm"])
                   / abs(b["grad_norm"]))
        if "gather_ms" in got[0]:
            rec["gather_ms"] = max(g["gather_ms"] for g in got)
            rec["gather_mb"] = got[0]["gather_mb"]
        summary[run] = rec
        print(f"model axis train {run}: {TP_SHAPE} on cuda:0 (gloo) vs one "
              f"device: max loss rel err {rec['loss_rel_err']:.2e}, grad "
              f"norm {a['grad_norm']:.6f} / {b['grad_norm']:.6f}; step "
              f"{tp_s:.3f} s vs {one_s:.3f} s ({batch / tp_s:.2f} vs "
              f"{batch / one_s:.2f} segments/s); peak GB per rank "
              f"{rec['tp_peak_gb']:.2f} (one device {ref['peak_gb']:.2f})"
              + (f"; logits all-gather {rec['gather_ms']:.2f} ms for "
                 f"{rec['gather_mb']:.2f} MB" if "gather_ms" in rec else ""),
              flush=True)
    frames = (-1, base.seq_length, base.num_sampled_frm,
              base.num_prop_per_frm)
    for kernels, ref in one_eval.items():
        got = ranks[0]["eval"][kernels]
        check(ranks[1]["eval"][kernels]["stats"] == got["stats"],
              f"model axis eval kernels={kernels}: the ranks' stats differ")
        check_eval_files(got["out_dir"], cfg_tp, val["seg_id"],
                         {s.split("_segment_")[0] for s in val["seg_id"]})
        agree = {}
        for key, get in (
                ("tokens", lambda o: o["gen"][0]["seq"]),
                ("gen att2_ind", lambda o: o["gen"][0]["att2_weights"]
                 .reshape(frames).argmax(-1)),
                ("gt att2_ind", lambda o: o["grd"][0]["att2_ind"]),
                ("gt grd_ind", lambda o: o["grd"][0]["grd_ind"])):
            agree[key] = float((get(got) == get(ref)).mean())
            bar = 0.998 if kernels else 1.0
            check(agree[key] >= bar, f"model axis eval kernels={kernels} "
                  f"{key}: agreement with one device {agree[key]}")
        summary[f"eval kernels={kernels}"] = dict(
            agreement=agree, one_evaluate_s=ref["evaluate_s"],
            tp_evaluate_s=got["evaluate_s"],
            one_grounding_s=ref["grounding_s"],
            tp_grounding_s=got["grounding_s"])
        print(f"model axis eval f32 kernels={kernels}: {TP_SHAPE} vs one "
              f"device agreement "
              + ", ".join(f"{k} {v:.4f}" for k, v in agree.items())
              + f"; evaluate {got['evaluate_s']:.3f} s vs "
              f"{ref['evaluate_s']:.3f} s, eval_grounding_gt "
              f"{got['grounding_s']:.3f} s vs {ref['grounding_s']:.3f} s",
              flush=True)
    return summary


def phase_params_io(dev, base, state):
    """``utils/params_io.py`` at flagship width: the model's weights
    (``weights.to_jax_variables``) saved in the JAX tools' npz format,
    loaded onto a model of another seed (``load_variables``,
    ``weights.from_jax_variables``); a greedy decode of one batch of 100
    through K1 and K2 gives the same tokens as the original model's."""
    import tempfile
    import torch
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.models import (
        GVDModel, batch_to_tensors)
    from grounded_video_description_torch.utils.params_io import (
        load_variables, save_variables)
    from grounded_video_description_torch.weights import (
        from_jax_variables, to_jax_variables)

    m = model_of(base, state, dev)
    batch = batch_to_tensors(synthetic_batch(base, B, seed=1), dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.npz")
        t0 = time.perf_counter()
        save_variables(path, to_jax_variables(m))
        save_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 2 ** 20
        other = GVDModel(base).init(torch.Generator().manual_seed(1))
        t0 = time.perf_counter()
        loaded = load_variables(path, to_jax_variables(other))
        load_s = time.perf_counter() - t0
    other.load_state_dict(from_jax_variables(loaded))
    other = other.to(dev).eval()
    seq = m.sample_greedy(batch)[0]
    seq2 = other.sample_greedy(batch)[0]
    check(torch.equal(seq, seq2), "params_io: the reloaded model's tokens "
          "differ")
    for k, v in m.state_dict().items():
        check(torch.equal(other.state_dict()[k], v),
              f"params_io: {k} differs after the round trip")
    print(f"params_io: flagship npz {mb:.1f} MB, save {save_s:.2f} s, "
          f"load {load_s:.2f} s; greedy tokens of the reloaded model "
          f"identical ({tuple(seq.shape)})", flush=True)
    return dict(npz_mb=mb, save_s=save_s, load_s=load_s)


# the kernels of one bf16 K5 train step (csrc/encoder_layer_train.cu, its
# attention in csrc/attention_mma.cu), as the profiler names them
K5_KERNELS = ("gemm_tc_kernel", "ln_fwd_kernel", "ln_bwd_kernel",
              "fwd_kernel", "bwd_kv_kernel", "bwd_q_kernel")


def phase_profile(dev, state):
    """``ProfilerHooks`` (CPU and CUDA activity) around one bf16 train
    step through K5 at flagship width, one microbatch of 30 after a
    warm-up step: the Chrome trace's size, its kernels, and K5's among
    them."""
    import tempfile
    import torch
    from grounded_video_description_torch.engine.trainer import (
        Trainer, batch_to_device)
    from grounded_video_description_torch.models import GVDModel
    from grounded_video_description_torch.utils.logging import (
        ProfilerHooks, kernel_names)

    cfg = train_config().replace(dtype="bfloat16", batch_size=30,
                                 grad_accum=1, **TRAIN_PATHS["K5"])
    model = GVDModel(cfg)
    model.load_state_dict(state)
    tr = Trainer(cfg, model.to(dev))
    batch = batch_to_device(cfg, {k: v[:30] for k, v in train_batch().items()
                                  if k != "seg_id"}, dev)
    tr.train_step(batch, cfg.learning_rate)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        hooks = ProfilerHooks(tmp, start_step=tr.step, num_steps=1,
                              device=dev)
        hooks.maybe_start(tr.step)
        t0 = time.perf_counter()
        tr.train_step(batch, cfg.learning_rate)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hooks.maybe_stop(tr.step)
        export_s = time.perf_counter() - t0
        mb = os.path.getsize(hooks.path) / 2 ** 20
        names = kernel_names(hooks.path)
    found = {k: [n for n in names if re.search(rf"\b{k}\b", n)]
             for k in K5_KERNELS}
    missing = [k for k, v in found.items() if not v]
    check(not missing, f"profile: K5's kernels {missing} not in the trace")
    print(f"profile: one bf16 K5 step (30 segments) {step_s:.2f} s under "
          f"the profiler, trace {mb:.1f} MB written in {export_s:.1f} s, "
          f"{len(names)} kernel names; K5's: "
          + "; ".join(f"{k}: {len(v)}" for k, v in found.items()),
          flush=True)
    return dict(trace_mb=mb, export_s=export_s, kernel_names=len(names))


def check_eval_files(out_dir, cfg, seg_ids, vids,
                     kinds=("attn-gen", "attn-gt", "grd-gt")):
    """The densecap JSON and the grounding JSONs of ``kinds`` parse and
    hold every segment."""
    tag = f"{cfg.val_split}-{cfg.id}.json"
    with open(os.path.join(out_dir, "densecap_results",
                           f"densecap-{tag}")) as f:
        dense = json.load(f)["results"]
    check(set(dense) == vids
          and sum(len(v) for v in dense.values()) == len(seg_ids),
          "densecap JSON does not hold every segment")
    for kind in kinds:
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

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        print(f"{phase.__name__}: {time.perf_counter() - t:.1f} s",
              flush=True)
        return out

    results = {}
    timed(phase_region_attention, dev, results)
    timed(phase_birnn, dev, results)
    timed(phase_encoder_layer, dev, results)
    timed(phase_attention_train, dev, results)
    timed(phase_encoder_layer_train, dev, results)
    base, state = flagship()
    timed(phase_decode_kernel, dev, results, base, state)
    timed(phase_flash_mha, dev, results)
    # launches per dtype and kernel: K1, K2 and K3 from the greedy path,
    # K6 and K7 from the eval, K4 and K5 from the train step (f32) and the
    # timed train steps and the training driver (bf16)
    launches = timed(phase_end_to_end, dev, base, state)
    timed(phase_beam, dev, base, state)
    for dt, counts in timed(phase_eval, dev, base, state).items():
        for name, n in counts.items():
            launches[dt].setdefault(name, n)
    for dt, counts in timed(phase_train, dev, state)[0].items():
        launches[dt].update(counts)
    driver = timed(phase_driver, dev, state)
    timed(phase_transformer, dev, base, state)
    timed(phase_data_parallel, dev, base, state, results)
    timed(phase_params_io, dev, base, state)
    timed(phase_profile, dev, state)
    for name in ("encoder_layer_train_fwd", "encoder_layer_train_bwd"):
        launches["bfloat16"][name] = driver[name]

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
             "grounded_video_description_torch/csrc/attention_tf32x3.cu",
             "grounded_video_description_tpu/ops/pallas/"
             "attention_train.py:163"),
            ("attention_train_bwd", "attention_train_bwd",
             "grounded_video_description_torch/csrc/attention_tf32x3.cu",
             "grounded_video_description_tpu/ops/pallas/"
             "attention_train.py:185"),
            ("encoder_layer_train_fwd", "encoder_layer_train_fwd",
             "grounded_video_description_torch/csrc/encoder_layer_train.cu",
             "grounded_video_description_tpu/ops/pallas/"
             "encoder_layer_train.py:401"),
            ("encoder_layer_train_bwd", "encoder_layer_train_bwd",
             "grounded_video_description_torch/csrc/encoder_layer_train.cu",
             "grounded_video_description_tpu/ops/pallas/"
             "encoder_layer_train.py:459"),
            ("decode_scan", "decode_scan",
             "grounded_video_description_torch/csrc/decode_scan.cu",
             "grounded_video_description_tpu/ops/pallas/decode_scan.py:325"),
            ("flash_self_attention", "flash_self_attention",
             "grounded_video_description_torch/csrc/attention_tf32x3.cu",
             "grounded_video_description_tpu/ops/pallas/mha.py:70")]
    bf16_source = {      # the bf16 launches of K4, K5's attention and K7
        "attention_train_fwd": "grounded_video_description_torch/csrc/"
                               "attention_mma.cu",
        "attention_train_bwd": "grounded_video_description_torch/csrc/"
                               "attention_mma.cu",
        "flash_self_attention": "grounded_video_description_torch/csrc/"
                                "attention_mma.cu"}
    kernels = []
    for dt in ("float32", "bfloat16"):
        for name, key, source, replaces in rows:
            r = results[(key, dt)]
            n = launches[dt].get(name, 0)
            check(n > 0, f"{name} ({dt}) was not launched on the main path")
            row = {"name": name, "route": "cuda",
                   "source": (bf16_source.get(name, source)
                              if dt == "bfloat16" else source),
                   "replaces": replaces, "launches": n,
                   "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                   "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                   "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                   "dtype": dt}
            for extra in ("repack_ms", "exchange_ms", "gemm_tflops",
                          "library_gemm_tflops", "bound_rates",
                          "stream_floor_ms", "phase_ms", "queued_ms",
                          "row0_max_abs_err"):
                if extra in r:
                    row[extra] = r[extra]
            kernels.append(row)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
