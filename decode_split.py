#!/usr/bin/env python3
"""Split K6's greedy decode (the port's ``csrc/decode_scan.cu``) by phase,
on one NVIDIA GPU, in f32 and bf16, at the eval flagship's shapes (B =
100, 480 frames, 1000 ROIs of which a fifth are pnt-masked, rnn 1024,
att_hid 512, vocab 4905, 20 tokens; random weights from a seeded
generator, the banks encoded on the plain path).

    python3 decode_split.py [--root DIR] [--out DIR]

Block 0 stamps the card's %globaltimer at the start and after every
grid barrier; each phase's interval ends at the barrier after it.  A
second launch runs the barriers alone, and its intervals are taken out
of the first's.  Each reading is the median of three launches; beside
them, the decode's time with CUDA events (the wrapper's host work
included).  ``--root`` imports the port's package from another checkout
(for example the parent commit unpacked by ``git archive``).  A checkout
whose wrapper has no ``greedy_decode_timed`` (the kernel of seven phases
a step, before the timing entry) is timed through a copy of its
``decode_scan.cu`` with the same stamps and switch added, built alone
with nvcc.  With ``--out DIR`` the readings go to DIR/decode_split.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

# the phases of a step, by the checkout's kernel
PHASES = {10: ("att GEMM", "att cell", "h2att GEMM", "h2att bias", "scores",
               "sums", "lang GEMM", "lang cell", "logit GEMM", "finish"),
          7: ("att LSTM", "h2att", "scores", "sums", "lang LSTM", "logits",
              "finish")}

# what an older decode_scan.cu gets: stamps after each barrier and a
# switch that skips each phase's work, set by gvd_decode_timing
TIMING = '''namespace {
__device__ unsigned long long* g_stamps;
__device__ int g_bonly;
__device__ __forceinline__ void gvd_stamp(int& n) {
  if (g_stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[n++] = t;
  }
}
'''
SETTER = '''
extern "C" int gvd_decode_timing(void* stamps, int bonly) {
  cudaMemcpyToSymbol(g_stamps, &stamps, sizeof(void*));
  cudaMemcpyToSymbol(g_bonly, &bonly, sizeof(int));
  return (int)cudaGetLastError();
}
'''


def timed_copy(root: str, build):
    """An older checkout's decode_scan.cu with the stamps and the switch,
    built alone and loaded in place of its library."""
    csrc = os.path.join(root, "grounded_video_description_torch", "csrc")
    src = open(os.path.join(csrc, "decode_scan.cu")).read()
    src = src.replace("namespace {\n", TIMING, 1)
    for call in ("lstm_phase<T>(", "linear_phase<T, ", "score_phase<T>(",
                 "sum_phase<T>(", "finish_phase<T>("):
        if call not in src:
            raise RuntimeError(f"{call} not found: not the seven-phase kernel")
        src = src.replace(call, "if (!g_bonly) " + call)
    src = src.replace("grid_sync(a.bar);", "grid_sync(a.bar); gvd_stamp(n_);")
    src = src.replace("  for (int t = 0; t < a.L; ++t) {",
                      "  int n_ = 0;\n  gvd_stamp(n_);\n"
                      "  for (int t = 0; t < a.L; ++t) {", 1)
    tmp = tempfile.mkdtemp()
    cu = os.path.join(csrc, f"decode_scan_timed_{os.getpid()}.cu")
    so = os.path.join(tmp, "libdecode_timed.so")
    with open(cu, "w") as f:
        f.write(src + SETTER)
    try:
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                       check=True)
    finally:
        os.remove(cu)
    lib = ctypes.CDLL(so)
    lib.gvd_greedy_decode.argtypes = build._SIGNATURES["gvd_greedy_decode"]
    lib.gvd_greedy_decode.restype = ctypes.c_int
    lib.gvd_decode_timing.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gvd_decode_timing.restype = ctypes.c_int
    build._lib = lib
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose package is timed")
    ap.add_argument("--out", help="directory for decode_split.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_split: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from grounded_video_description_torch.config import GVDConfig
    from grounded_video_description_torch.data.synthetic import synthetic_batch
    from grounded_video_description_torch.models import (
        GVDModel, batch_to_tensors)
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.ops.kernels import decode_scan as k6

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = None if hasattr(k6, "greedy_decode_timed") else timed_copy(root,
                                                                     _build)
    n_ph = 7 if lib is not None else 10
    B, R = 100, 1000
    base = GVDConfig(vocab_size=4905, detect_size=431, seq_per_img=1,
                     drop_prob_lm=0.5, obj_interact=True, use_pallas=False,
                     use_pallas_rnn=False,
                     use_pallas_encoder=False).validate()
    L = base.seq_length
    state = GVDModel(base).init(torch.Generator().manual_seed(0)).state_dict()
    batch = batch_to_tensors(synthetic_batch(base, B, seed=0), dev)
    pnt = batch["pnt_mask"].bool().clone()
    pnt[:, 1:] |= torch.rand(B, R, device=dev, generator=torch.Generator(
        device=dev).manual_seed(17)) < 0.2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"root": root, "card": smi, "phases": PHASES[n_ph]}
    print(smi, flush=True)
    for dt in ("float32", "bfloat16"):
        m = GVDModel(base.replace(dtype=dt))
        m.load_state_dict(state)
        m = m.to(dev).eval()
        with torch.no_grad():
            enc = m.encode(batch)

            def stamps(barriers_only: bool):
                if lib is None:
                    st = k6.greedy_decode_timed(m, enc, pnt,
                                                barriers_only=barriers_only)
                else:
                    st = torch.zeros(1 + n_ph * L, dtype=torch.int64,
                                     device=dev)
                    _build.check(lib.gvd_decode_timing(st.data_ptr(),
                                                       int(barriers_only)),
                                 "decode_timing")
                    k6.greedy_decode_fused(m, enc, pnt)
                    _build.check(lib.gvd_decode_timing(None, 0),
                                 "decode_timing")
                d = (st[1:] - st[:-1]).cpu().double().reshape(L, n_ph)
                return d.sum(0) / 1e6

            def median(barriers_only: bool):
                return torch.stack([stamps(barriers_only) for _ in range(3)]
                                   ).median(0).values

            k6.greedy_decode_fused(m, enc, pnt)
            full, bars = median(False), median(True)
            events = []
            for _ in range(5):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                k6.greedy_decode_fused(m, enc, pnt)
                t1.record()
                t1.synchronize()
                events.append(t0.elapsed_time(t1))
        out[dt] = {"decode_ms": statistics.median(events),
                   "whole_ms": float(full.sum()),
                   "barriers_ms": float(bars.sum()),
                   "barriers": n_ph * L,
                   "work_ms": dict(zip(PHASES[n_ph],
                                       (float(x) for x in full - bars)))}
        print(dt, json.dumps(out[dt]), flush=True)
        del m, enc
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "decode_split.json"), "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
