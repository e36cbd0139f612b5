#!/usr/bin/env python3
"""Profile one train step, or one greedy batch, of the PyTorch port on one
NVIDIA GPU, in bf16 or f32.

    python3 profile_step.py [--path K5 --path K4 --path serve
                             --path beam --path transformer ...]
                            [--dtype bfloat16 --dtype float32]
                            [--root DIR] [--tag NAME] [--out DIR]

``--path serve`` profiles one ``sample_greedy`` at the flagship
inference configuration (chip_smoke.py's ``flagship``: B = 100, 1000
ROIs, 480 frames, 20 tokens, K1-K3 on) in each ``--dtype``, after one
warm-up call, and prints the call's host seconds, the device-busy
seconds, and the device time of K2, K1's GEMMs, K1's attention, K1's
LayerNorms and K3, and the largest kernels.  ``--path beam`` does the
same for ``sample_beam`` at each of chip_smoke.py's ``BEAM_WIDTHS`` (K1
and K2 on), and in a second, unprofiled call times the shared-bank beam
attentions (``region_attention_beam``, ``temporal_attention_beam``) with
CUDA events around each call, and reads the call's peak device memory.
``--path transformer`` profiles the Masked-Transformer captioner
(``att_model`` "transformer", chip_smoke.py's ``sharpen_decoder``
weights) in each ``--dtype``: one ``sample_greedy`` of B = 100 (K1 and K2
on; the decoder is plain PyTorch) with the device time of K2, K1's
groups and the rest, and one train step through K5 at the training
configuration.

For each path (chip_smoke.py's ``TRAIN_PATHS``: K5, K4, plain) and each
``--dtype`` it builds the flagship training configuration in that dtype
(chip_smoke.py's ``train_config``: batch 240 in 8 microbatches, the
flagship dropout),
random weights from a seeded generator, runs one warm-up step, then one
step under ``torch.profiler`` with CUDA activity only, and prints:
the step's host seconds, the device-busy seconds (the union of the kernel
intervals) and their share of the step, the device time of the
attention kernels (K4's, also run by K5) and of K5's other kernels, and
the largest kernels by device time.  ``--root`` imports the port's
package from another checkout (for example the parent commit, to profile
before and after a change in one call); this script and chip_smoke.py are
read from this checkout.  With ``--out DIR``, a JSON summary per path
goes to DIR.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# kernel names of the attention: the repack, the forward and the two
# backward kernels in bf16 (csrc/attention_mma.cu) and f32 (3xTF32,
# csrc/attention_tf32x3.cu: its dQ kernel is bwd_dq_kernel; before it the
# SIMT kernels of csrc/attention_train.cu), and delta_kernel
ATTENTION = ("fwd_kernel", "bwd_kv_kernel", "bwd_q_kernel", "bwd_dq_kernel",
             "delta_kernel", "pack_kernel")
# K5's other kernels (csrc/encoder_layer_train.cu) and K1's GEMM (the
# names of this tree and of the trees before it)
K1_GEMM = ("gemm_kernel", "gemm_bf16_wmma_kernel", "gemm_f32_kernel",
           "gemm_bf16_mma_kernel", "gemm_tf32x3_kernel")
K5_REST = K1_GEMM + ("gemm_tc_kernel", "ln_fwd_kernel", "ln_bwd_kernel",
                     "colsum_partial_kernel", "colsum_final_kernel",
                     "splitk_sum_kernel")
# the serving path's kernel groups (csrc/birnn.cu, encoder_layer.cu,
# attention_mma.cu, attention_tf32x3.cu, region_attention.cu: K3's split
# kernel, and the one-block-a-row kernel of the trees before it)
SERVE_GROUPS = {
    "K2": ("birnn_kernel", "birnn_cluster_kernel", "birnn_mma_kernel"),
    "K1 GEMM": K1_GEMM,
    "K1 attention": ("attention_kernel", "attention_simt_kernel",
                     "fwd_kernel", "pack_kernel"),
    "K1 LayerNorm": ("residual_ln_kernel",),
    "K3": ("region_attention_kernel", "region_attention_split_kernel")}


def kernel_name(full: str) -> str:
    """The bare function name of a demangled kernel signature."""
    full = full.replace("(anonymous namespace)::", "")
    head = full.split("(")[0].split("<")[0]
    return head.split("::")[-1].split()[-1]


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_times(prof):
    """(busy seconds, kernel count, device us by kernel name) of a
    profile's CUDA events."""
    import torch
    spans, by_name = [], collections.Counter()
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        tr_ = ev.time_range
        spans.append((tr_.start, tr_.end))
        by_name[kernel_name(ev.name)] += tr_.end - tr_.start
    return busy_us(spans) / 1e6, len(spans), by_name


def profiled_call(call):
    """One warm-up ``call()``, then one under ``torch.profiler`` (CUDA
    activity): (the call's host seconds, busy seconds, kernel count,
    device us by kernel name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    call()                                                   # warm-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    return (call_s, *device_times(prof))


def inference_model(dtype: str, base, state, dev):
    """chip_smoke's flagship model in ``dtype`` and its batch of B."""
    from grounded_video_description_torch.data.synthetic import (
        synthetic_batch)
    from grounded_video_description_torch.models import batch_to_tensors
    from chip_smoke import B, model_of
    return (model_of(base.replace(dtype=dtype), state, dev),
            batch_to_tensors(synthetic_batch(base, B, seed=0), dev))


def profile_serve(dtype: str, base, state, dev):
    import torch
    model, batch = inference_model(dtype, base, state, dev)
    call_s, busy, n, by_name = profiled_call(
        lambda: model.sample_greedy(batch))
    del model
    torch.cuda.empty_cache()
    return {"path": "serve", "dtype": dtype, "step_s": call_s,
            "device_busy_s": busy, "busy_share": busy / call_s,
            "kernels": n,
            "groups": {g: sum(by_name[k] for k in names) / 1e6
                       for g, names in SERVE_GROUPS.items()},
            "top": [(k, t / 1e6) for k, t in by_name.most_common(12)]}


def profile_beam(dtype: str, width: int, base, state, dev):
    import torch
    from grounded_video_description_torch.models import gvd

    model, batch = inference_model(dtype, base, state, dev)

    def call():
        return model.sample_beam(batch, beam_size=width)

    call_s, busy, n, by_name = profiled_call(call)

    # the beam attentions' device time: CUDA events around each call
    spans = {"region_attention_beam": [], "temporal_attention_beam": []}
    originals = {name: getattr(gvd, name) for name in spans}

    def timed(name):
        def wrapper(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = originals[name](*args, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return wrapper

    torch.cuda.reset_peak_memory_stats(dev)
    for name in spans:
        setattr(gvd, name, timed(name))
    try:
        call()
    finally:
        for name, fn in originals.items():
            setattr(gvd, name, fn)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    del model
    torch.cuda.empty_cache()
    return {"path": "beam", "dtype": dtype, "beam_size": width,
            "step_s": call_s, "device_busy_s": busy,
            "busy_share": busy / call_s, "kernels": n,
            "groups": {
                **{g: sum(by_name[k] for k in names) / 1e6
                   for g, names in SERVE_GROUPS.items() if g != "K3"},
                **{name: sum(a.elapsed_time(b) for a, b in ev) / 1e3
                   for name, ev in spans.items()}},
            "attention_calls": {name: len(ev) for name, ev in spans.items()},
            "peak_memory_gb": peak / 1e9,
            "top": [(k, t / 1e6) for k, t in by_name.most_common(12)]}


def profile(path: str, dtype: str, state, dev, family: str = "topdown"):
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from grounded_video_description_torch.data.synthetic import (
        synthetic_batch)
    from grounded_video_description_torch.engine.trainer import (
        Trainer, batch_to_device)
    from grounded_video_description_torch.models import GVDModel
    from chip_smoke import TRAIN_PATHS, train_config

    cfg = train_config().replace(att_model=family, dtype=dtype,
                                 **TRAIN_PATHS[path])
    model = GVDModel(cfg)
    model.load_state_dict(state)
    tr = Trainer(cfg, model.to(dev))
    batch = batch_to_device(cfg, synthetic_batch(cfg, cfg.batch_size,
                                                 seed=0), dev)
    tr.train_step(batch, cfg.learning_rate)                  # warm-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(batch, cfg.learning_rate)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    busy, n_kernels, by_name = device_times(prof)
    attn = sum(by_name[n] for n in ATTENTION) / 1e6
    rest = sum(by_name[n] for n in K5_REST) / 1e6
    del tr, model
    torch.cuda.empty_cache()
    return {"path": path, "family": family, "dtype": dtype,
            "step_s": step_s, "device_busy_s": busy,
            "busy_share": busy / step_s, "kernels": n_kernels,
            "attention_s": attn, "k5_other_s": rest,
            "top": [(n, t / 1e6) for n, t in by_name.most_common(12)]}


def profile_transformer(dtype: str, base, dev):
    """One greedy call and one K5 train step of the transformer family."""
    import torch
    from grounded_video_description_torch.models import GVDModel
    from chip_smoke import sharpen_decoder

    tf = base.replace(att_model="transformer")
    state = sharpen_decoder(GVDModel(tf).init(
        torch.Generator().manual_seed(0)).state_dict())
    model, batch = inference_model(dtype, tf, state, dev)
    call_s, busy, n, by_name = profiled_call(
        lambda: model.sample_greedy(batch))
    del model
    torch.cuda.empty_cache()
    groups = {g: sum(by_name[k] for k in names) / 1e6
              for g, names in SERVE_GROUPS.items() if g != "K3"}
    groups["rest (decoder, encode glue)"] = (
        sum(by_name.values()) / 1e6 - sum(groups.values()))
    return ({"path": "transformer-greedy", "dtype": dtype, "step_s": call_s,
             "device_busy_s": busy, "busy_share": busy / call_s,
             "kernels": n, "groups": groups,
             "top": [(k, t / 1e6) for k, t in by_name.most_common(12)]},
            profile("K5", dtype, state, dev, family="transformer"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", action="append",
                    choices=["K5", "K4", "plain", "serve", "beam",
                             "transformer"])
    ap.add_argument("--dtype", action="append",
                    choices=["bfloat16", "float32"],
                    help="the dtypes of every path (default bfloat16)")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", help="a directory for the JSON summaries")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.root))
    from grounded_video_description_torch.config import GVDConfig
    from grounded_video_description_torch.models import GVDModel
    from grounded_video_description_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; package from {os.path.abspath(args.root)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.lib()
    base = GVDConfig(vocab_size=4905, detect_size=431,
                     obj_interact=True).validate()
    state = GVDModel(base).init(torch.Generator().manual_seed(0)).state_dict()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    serve = base.replace(seq_per_img=1, drop_prob_lm=0.5, use_pallas=True,
                         use_pallas_rnn=True, use_pallas_encoder=True)
    for path in args.path or ["K5", "K4"]:
        if path == "transformer":
            for dt in args.dtype or ["bfloat16"]:
                greedy, step = profile_transformer(dt, serve, dev)
                for r in (greedy, step):
                    r.update(tag=args.tag, device=smi)
                print(f"[{args.tag}] {dt} transformer greedy batch of 100: "
                      f"{greedy['step_s']:.4f} s, device busy "
                      f"{greedy['device_busy_s']:.4f} s "
                      f"({100 * greedy['busy_share']:.1f}%), "
                      f"{greedy['kernels']} kernels; " + ", ".join(
                          f"{g} {t * 1e3:.3f} ms"
                          for g, t in greedy["groups"].items())
                      + "; top: " + ", ".join(
                          f"{k} {t * 1e3:.3f}" for k, t in greedy["top"][:8]),
                      flush=True)
                print(f"[{args.tag}] {dt} transformer step K5: "
                      f"{step['step_s']:.3f} s, device busy "
                      f"{step['device_busy_s']:.3f} s "
                      f"({100 * step['busy_share']:.1f}%), "
                      f"{step['kernels']} kernels; attention "
                      f"{step['attention_s']:.3f} s, K5's other kernels "
                      f"{step['k5_other_s']:.3f} s; top: " + ", ".join(
                          f"{n} {t:.3f}" for n, t in step["top"][:8]),
                      flush=True)
                if args.out:
                    with open(os.path.join(
                            args.out, f"profile-{args.tag}-transformer-"
                            f"{dt}.json"), "w") as f:
                        json.dump({"greedy": greedy, "step": step}, f,
                                  indent=1)
            continue
        if path == "beam":
            from chip_smoke import BEAM_WIDTHS
            for dt in args.dtype or ["bfloat16"]:
                for width in BEAM_WIDTHS:
                    r = profile_beam(dt, width, serve, state, dev)
                    r.update(tag=args.tag, device=smi)
                    print(f"[{args.tag}] {dt} beam {width}, batch of 100: "
                          f"{r['step_s']:.4f} s, device busy "
                          f"{r['device_busy_s']:.4f} s "
                          f"({100 * r['busy_share']:.1f}%), {r['kernels']} "
                          f"kernels, peak {r['peak_memory_gb']:.2f} GB; "
                          + ", ".join(f"{g} {t * 1e3:.3f} ms"
                                      for g, t in r["groups"].items())
                          + "; top: " + ", ".join(
                              f"{k} {t * 1e3:.3f}" for k, t in r["top"][:8]),
                          flush=True)
                    if args.out:
                        with open(os.path.join(
                                args.out, f"profile-{args.tag}-beam{width}-"
                                f"{dt}.json"), "w") as f:
                            json.dump(r, f, indent=1)
            continue
        if path == "serve":
            for dt in args.dtype or ["bfloat16"]:
                r = profile_serve(dt, serve, state, dev)
                r.update(tag=args.tag, device=smi)
                print(f"[{args.tag}] {dt} greedy batch of 100: "
                      f"{r['step_s']:.4f} s, device busy "
                      f"{r['device_busy_s']:.4f} s "
                      f"({100 * r['busy_share']:.1f}%), {r['kernels']} "
                      "kernels; " + ", ".join(
                          f"{g} {t * 1e3:.3f} ms"
                          for g, t in r["groups"].items())
                      + "; top: " + ", ".join(
                          f"{k} {t * 1e3:.3f}" for k, t in r["top"][:8]),
                      flush=True)
                if args.out:
                    with open(os.path.join(
                            args.out, f"profile-{args.tag}-serve-{dt}.json"),
                            "w") as f:
                        json.dump(r, f, indent=1)
            continue
        for dt in args.dtype or ["bfloat16"]:
            r = profile(path, dt, state, dev)
            r.update(tag=args.tag, device=smi)
            print(f"[{args.tag}] {dt} step {path}: {r['step_s']:.3f} s, "
                  f"device busy {r['device_busy_s']:.3f} s "
                  f"({100 * r['busy_share']:.1f}%), {r['kernels']} kernels; "
                  f"attention {r['attention_s']:.3f} s, K5's other kernels "
                  f"{r['k5_other_s']:.3f} s; top: "
                  + ", ".join(f"{n} {t:.3f}" for n, t in r["top"][:8]),
                  flush=True)
            if args.out:
                with open(os.path.join(
                        args.out, f"profile-{args.tag}-{path}-{dt}.json"),
                        "w") as f:
                    json.dump(r, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
