"""Closed-loop captioning: one caller hands the program a batch of host
arrays through ``Evaluator.generate`` (the program's entry for a batch
from its dataset loader), waits for the host arrays of its captions,
and sends the next; the mix's ``distinct_batches`` batches are cycled.

- ``captions_per_s``: captions returned in the window over the window,
  which runs from the first timed call until the end of the last one
  started before ``--seconds`` had passed.
- ``batch_p90_ms``: the 90th percentile of every timed call's latency,
  call to host arrays back.
- ``setup_s``: from the process's start to the first timed call.

After the window (and, with ``--trace 1``, a profiled stretch of
``traced_calls`` more calls) the program is freed and the reference
judges ``judged_calls`` of the timed calls, drawn from the seed by
reservoir sampling.
"""

from __future__ import annotations

import gc
import random
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import harness, traffic, work
from benchmark.reference import compare
from benchmark.reference.gvd import GVDReference, Ops
from benchmark.weights import draw_weights


def judge_kind(cell: harness.Cell) -> str:
    if cell.model["att_model"] == "transformer":
        return "transformer_greedy"
    return "topdown_beam" if cell.traffic["beam_size"] > 1 else \
        "topdown_greedy"


def program(cell: harness.Cell, weights: Dict[str, torch.Tensor]):
    """The program's evaluator over a model of the cell's configuration
    holding ``weights``, on the cell's device."""
    from grounded_video_description_torch.config import GVDConfig
    from grounded_video_description_torch.engine.evaluator import Evaluator
    from grounded_video_description_torch.models.gvd import GVDModel
    cfg = GVDConfig(**cell.model, **cell.config["kernels"]["serve"],
                    dtype=cell.config["dtype"],
                    beam_size=cell.traffic["beam_size"]).validate()
    with torch.device(cell.device):
        model = GVDModel(cfg)
    model.load_state_dict(weights)
    return Evaluator(cfg, model.eval(), vocab=None)


def inputs(cell: harness.Cell, calls: int = 0) -> List[Dict[str, np.ndarray]]:
    mix = dict(cell.traffic)
    if calls:
        mix["distinct_batches"] = calls
    return traffic.host_batches(cell.model, mix, cell.seed + 1, cell.device)


def synchronize(cell: harness.Cell) -> None:
    if cell.device == "cuda":
        torch.cuda.synchronize()


def judged(cell: harness.Cell, samples: List[Tuple[int, Dict]],
           batches: List[Dict[str, np.ndarray]],
           control: bool = False) -> Dict[str, float]:
    """The widest reading of each number over ``samples`` ((batch index,
    served outputs)), the reference in float32 judging. With ``control``
    the reference in TF32 serves in the program's place."""
    dev = cell.device
    ref = GVDReference(cell.model).to(dev)
    ref.load_state_dict(draw_weights(cell.config, cell.seed, dev))
    ops, low = Ops("f32"), Ops("tf32")
    kind, width = judge_kind(cell), cell.traffic["beam_size"]
    L = cell.model["seq_length"]
    numbers: Dict[str, float] = {}
    with torch.no_grad():
        for bi, out in samples:
            b = {k: torch.as_tensor(v).to(dev) for k, v in batches[bi].items()}
            enc = ref.encode(ops, b)
            if control:
                out = compare.control_outputs(kind, ref, low,
                                              ref.encode(low, b), L, width)
            for k, v in compare.JUDGES[kind](ref, ops, enc, out).items():
                numbers[k] = max(numbers.get(k, -float("inf")), v)
    return numbers


def run(cell: harness.Cell) -> harness.Run:
    mix = cell.traffic
    batches = inputs(cell)
    ev = program(cell, draw_weights(cell.config, cell.seed, cell.device))
    for i in range(mix["warmup_calls"]):
        ev.generate(batches[i % len(batches)])
    synchronize(cell)
    setup_s = time.perf_counter() - cell.started

    rng = random.Random(cell.seed)
    samples: List[Tuple[int, Dict]] = []
    latency = []
    start = time.perf_counter()
    while True:
        i = len(latency)
        bi = i % len(batches)
        t0 = time.perf_counter()
        out = ev.generate(batches[bi])
        t1 = time.perf_counter()
        latency.append(t1 - t0)
        if i < mix["judged_calls"]:
            samples.append((bi, out))
        else:
            j = rng.randrange(i + 1)
            if j < mix["judged_calls"]:
                samples[j] = (bi, out)
        if t1 - start >= cell.seconds:
            break
    window_s = t1 - start
    B = mix["batch_size"]
    calls = len(latency)
    peak = torch.cuda.max_memory_allocated() if cell.device == "cuda" else 0
    p90_ms = float(np.percentile(latency, 90)) * 1e3
    measured = {"captions_per_s": calls * B / window_s,
                "batch_p90_ms": p90_ms, "setup_s": setup_s}
    result = harness.Run(
        cell=cell, attempted=calls, failed=0,
        metrics={m["name"]: measured[m["name"]] for m in cell.end_to_end},
        memory_peak_bytes=peak,
        window={"seconds": window_s, "units": calls, "p90_ms": p90_ms},
        work={"flops_per_unit": work.serve_flops(cell.model, B,
                                                 mix["beam_size"]),
              "dtype": cell.config["dtype"], "batch": B})
    if cell.trace:
        n = mix["traced_calls"]

        def traced():
            for k in range(n):
                ev.generate(batches[k % len(batches)])
        result.trace = harness.profiled(traced, n)

    del ev
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    result.numbers = judged(cell, samples, batches)
    words = sum(int((out["seq"] != 0).sum()) for _, out in samples)
    cells = sum(out["seq"].size for _, out in samples)
    print(f"judged {len(samples)} calls: {words} of {cells} served words "
          "are not the end word", file=sys.stderr)
    return result


def readings(cell: harness.Cell, control: bool = True) -> Dict:
    """For ``calibrate.py``: the numbers of the program over the calls a
    run judges, served outside a window, and (``control``) of the plain
    reference in TF32 serving in its place."""
    batches = inputs(cell, cell.traffic["judged_calls"])
    ev = program(cell, draw_weights(cell.config, cell.seed, cell.device))
    served = [(i, ev.generate(b)) for i, b in enumerate(batches)]
    del ev
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    out = {"program": judged(cell, served, batches),
           "served_words": sum(int((o["seq"] != 0).sum()) for _, o in served)}
    if control:
        out["control"] = judged(cell, served, batches, control=True)
    return out
