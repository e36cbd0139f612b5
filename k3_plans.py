#!/usr/bin/env python3
"""Time K3 (the port's ``csrc/region_attention.cu``) under its own launch
plan and under other plans of the same kernel, on one NVIDIA GPU, in f32
and bf16, at the decode step's flagship shapes (B = 100, R = 1000, H =
512, D = 1024; seeded random banks, a fifth of the ROIs masked).

    python3 k3_plans.py [--out DIR]

Each other plan is ``card_plan``'s with one of the plan's constants
(``ops/kernels/region_attention.py``) set otherwise while it is made: the
streaming warps it aims at (f32 at 400 takes blocks of 4 warps), the bytes
a ring slot aims at.  A reading is the device time of one call queued back to
back (chip_smoke.py's ``time_ms_queued`` over 20 calls); every plan is
read four times, the plans in turns (forward, backward, forward,
backward).  Each line gives the plan, the warps it streams at once, the
mean time and the share of the bound (bytes at 3.35 TB/s).

Then, under the default plan, two designs the kernel does not take, each
a patched copy of its source built alone with nvcc and timed in turns with
the kernel itself: the slots filled by 16-byte cp.async by every thread of
a group in place of the TMA bulk copy (``cp16``), and the merge through
global memory (every block writes its partials there and a second launch
merges each row's, in the same order) in place of the cluster's
distributed shared memory.  With ``--out DIR`` the readings go to
DIR/k3_plans.json.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
B, R, H, D = 100, 1000, 512, 1024
PEAK_BYTES = 3.35e12
SOURCE = "grounded_video_description_torch/csrc/region_attention.cu"
# the plans read beside the default: the plan's constants set otherwise
VARIANTS = (("default", {}),
            ("half the streams", {"STREAM_WARPS": 400}),
            ("twice the streams", {"STREAM_WARPS": 1600}),
            ("one ROI a slot", {"SLOT_BYTES": 0}),
            ("two ROIs a slot", {"SLOT_BYTES": 2 * (H + D) * 4}))


def patch(src: str, old: str, new: str) -> str:
    """``src`` with its one ``old`` replaced by ``new``; raises, naming the
    anchor, where the source no longer has it once."""
    n = src.count(old)
    if n != 1:
        raise RuntimeError(f"k3_plans: {SOURCE} has {n} copies of the "
                           f"anchor {old.splitlines()[0]!r}, not one: bring "
                           "the patch up to date with the source")
    return src.replace(old, new)


def cp16_copy(src: str) -> str:
    """The kernel's source with its cp.async route copying 16 bytes a
    piece and built for f32 too, so that a plan whose ``copy`` is ``cp8``
    fills the slots of whole-16-byte rows by 16-byte cp.async."""
    src = patch(src, "constexpr int kPiece = 8;", "constexpr int kPiece = 16;")
    src = patch(src, '"cp.async.ca.shared.global [%0], [%1], 8;\\n"',
                '"cp.async.cg.shared.global [%0], [%1], 16;\\n"')
    return patch(src, "if constexpr (sizeof(T) == 2)", "if constexpr (true)")


MERGE_KERNEL = '''}

template <typename T>
__global__ void merge_kernel(int n_parts, int D, T* att_res) {
  const size_t stride = 4 + (size_t)D;
  const float* parts = g_merge_scratch + blockIdx.x * n_parts * stride;
  float top = -INFINITY;
  for (int i = 0; i < n_parts; ++i) top = fmaxf(top, parts[i * stride]);
  T* out = att_res + (size_t)blockIdx.x * D;
  for (int c = 4 * threadIdx.x; c < D; c += 4 * blockDim.x) {
    float total = 0.0f, o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < n_parts; ++i) {
      const float* pq = parts + i * stride;
      const float w = expf(pq[0] - top);
      total += pq[1] * w;
      for (int e = 0; e < 4; ++e) o[e] += w * pq[4 + c + e];
    }
    for (int e = 0; e < 4; ++e) out[c + e] = gvd::from_f32<T>(o[e] / total);
  }
}
'''
SECOND_LAUNCH = '''
  if (dtype == 0)
    merge_kernel<float><<<B, 256, 0, (cudaStream_t)stream>>>(
        splits * (WB / G), D, (float*)att_res);
  else
    merge_kernel<__nv_bfloat16><<<B, 256, 0, (cudaStream_t)stream>>>(
        splits * (WB / G), D, (__nv_bfloat16*)att_res);
'''
SETTER = '''
extern "C" int gvd_merge_scratch(void* p) {
  return (int)cudaMemcpyToSymbol(g_merge_scratch, &p, sizeof(void*));
}
'''


def merge_copy(src: str) -> str:
    """The kernel's source with its cluster merge replaced by partials in
    global memory and a second launch that merges them."""
    start = "  cl.sync();  // every partial of the row written\n"
    end = "  cl.sync();  // the peers' shared memory stays until block 0 " \
          "has read it\n}\n"
    i, j = src.find(start), src.find(end)
    if i < 0 or j < i:
        patch(src, start if i < 0 else end, "")   # raises, naming it
    src = src[:i] + MERGE_KERNEL + src[j + len(end):]
    src = patch(src, "  float* parts = reinterpret_cast<float*>(smem);",
                "  float* parts = g_merge_scratch + ((size_t)b * S + split) "
                "* NG * (4 + (size_t)D);")
    src = patch(src, "namespace cg = cooperative_groups;\n",
                "namespace cg = cooperative_groups;\n"
                "__device__ float* g_merge_scratch;\n")
    launch = ("  e = cudaLaunchKernelExC(&cfg, (const void*)kern, args);\n"
              "  if (e != cudaSuccess) return (int)e;\n")
    return patch(src, launch, launch + SECOND_LAUNCH) + SETTER


def build_copies(tmp: str) -> dict:
    """The patched copies, built at once (one nvcc each) and loaded with
    the kernel's C signatures."""
    from grounded_video_description_torch.ops.kernels import _build
    csrc = os.path.dirname(os.path.join(ROOT, SOURCE))
    with open(os.path.join(ROOT, SOURCE)) as f:
        src = f.read()
    procs = {}
    for name, make in (("cp16", cp16_copy), ("merge", merge_copy)):
        cu, so = (os.path.join(tmp, name + ext) for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(make(src))
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"k3_plans: nvcc failed on the {name} copy")
        lib = ctypes.CDLL(so)
        for entry in ("gvd_region_attention",
                      "gvd_region_attention_max_clusters"):
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    libs["merge"].gvd_merge_scratch.argtypes = [ctypes.c_void_p]
    libs["merge"].gvd_merge_scratch.restype = ctypes.c_int
    return libs


@contextlib.contextmanager
def constants(module, values: dict):
    """``module``'s constants set to ``values`` inside the block."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def in_turns(calls: dict, time_ms_queued) -> dict:
    """Four readings of each call, the calls in turns."""
    readings = {name: [] for name in calls}
    order = list(calls)
    for turn in range(4):
        for name in (order if turn % 2 == 0 else order[::-1]):
            readings[name].append(time_ms_queued(calls[name], 20, 1))
    return readings


def design_readings(args, plan, libs, time_ms_queued) -> dict:
    """The default plan on the kernel and on each patched copy, in turns,
    and each copy's max abs difference from the plain version."""
    import torch
    from grounded_video_description_torch.ops.kernels import _build
    from grounded_video_description_torch.ops.kernels import \
        region_attention as ra
    own = _build.lib()
    parts = torch.empty(plan.B * plan.splits * plan.groups * (4 + plan.D),
                        dtype=torch.float32, device=args[0].device)
    _build.check(libs["merge"].gvd_merge_scratch(parts.data_ptr()),
                 "gvd_merge_scratch")
    runs = {"kernel": (own, plan),
            "cp16 copies": (libs["cp16"], dataclasses.replace(plan,
                                                              copy="cp8")),
            "merge by a second launch": (libs["merge"], plan)}
    ref = ra.fused_region_attention_plain(*args)[0].float()

    def call_on(lib, p):
        def call():
            _build._lib = lib
            ra._launch(*args, p)
        return call

    try:
        calls = {name: call_on(*run) for name, run in runs.items()}
        errs = {}
        for name, (lib, p) in runs.items():
            _build._lib = lib
            got = ra._launch(*args, p)[0]
            errs[name] = float((got.float() - ref).abs().max())
        readings = in_turns(calls, time_ms_queued)
    finally:
        _build._lib = own
    return dict(readings_ms=readings, max_abs_err=errs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_plans: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms_queued
    from grounded_video_description_torch.ops.kernels import \
        region_attention as ra

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    out = {"card": card, "dtypes": {}}
    tmp = tempfile.TemporaryDirectory()
    libs = build_copies(tmp.name)
    for dt in (torch.float32, torch.bfloat16):
        mask = torch.rand(B, R, generator=g, device=dev) < 0.2
        args = (torch.randn(B, R, H, generator=g, device=dev).to(dt),
                torch.randn(B, H, generator=g, device=dev).to(dt),
                torch.randn(B, R, D, generator=g, device=dev).to(dt),
                torch.randn(1, H, generator=g, device=dev) * 0.05,
                torch.full((1,), 0.05, device=dev), mask, mask.clone())
        n_bytes = sum(t.numel() * t.element_size() for t in args)
        n_bytes += (B * D + B * R) * args[0].element_size()
        bound_ms = 1e3 * n_bytes / PEAK_BYTES
        plans = {}
        for label, values in VARIANTS:
            with constants(ra, values):
                plans[label] = ra._card_plan(B, R, H, D, dt)

        def call_of(p):
            return lambda: ra._launch(*args, p)
        readings = in_turns({k: call_of(p) for k, p in plans.items()},
                            time_ms_queued)
        name = str(dt).replace("torch.", "")
        rows = []
        for label, values in VARIANTS:
            p = plans[label]
            ms = statistics.mean(readings[label])
            row = dict(variant=label, constants=values, splits=p.splits,
                       block_warps=p.block_warps, slot_rois=p.slot_rois,
                       ring_slots=p.ring_slots, copy=p.copy, smem=p.smem,
                       resident=p.resident, warps=p.blocks * p.block_warps,
                       readings_ms=readings[label], ms=ms,
                       share=bound_ms / ms)
            rows.append(row)
            print(f"K3 {name} {label}: {p.splits} split(s) of "
                  f"{p.block_warps}-warp blocks, {row['warps']} warps, "
                  f"{p.slot_rois} ROI(s) a slot, {p.ring_slots} slots, "
                  f"{p.copy}: {ms:.4f} ms, {row['share']:.3f} of the bound "
                  f"({bound_ms:.4f} ms)", flush=True)
        designs = design_readings(args, plans["default"], libs,
                                  time_ms_queued)
        for how, ms_list in designs["readings_ms"].items():
            print(f"K3 {name} default plan, {how}: "
                  f"{statistics.mean(ms_list):.4f} ms, max abs diff from "
                  f"plain {designs['max_abs_err'][how]:.3e}", flush=True)
        out["dtypes"][name] = dict(bound_ms=bound_ms, plans=rows,
                                   designs=designs)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "k3_plans.json"), "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
