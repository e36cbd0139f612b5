"""Closed-loop captioning with the language-model captioner
(``att_model`` "lm"): one caller hands the program a batch of host arrays
through ``Evaluator.generate``, waits for the host arrays of its
captions, and sends the next; the mix's ``distinct_batches`` batches are
cycled. The window, ``captions_per_s``, ``batch_p90_ms`` and ``setup_s``
are ``serve_closed``'s.

The program's model is built on the meta device and takes the weights,
drawn on the card (``weights_lm.py``: the language model in bfloat16),
with ``load_state_dict(assign=True)``: the card holds one copy.

After the window (and, with ``--trace 1``, ``traced_calls`` more calls
under the profiler) the program is freed and the reference judges
``judged_segments`` segments, drawn from the seed, of each of
``judged_calls`` timed calls (reservoir sampling): the plain encoder in
float32 and the plain language model in float32, teacher-forced on the
served words (``reference/lm.py``). The numbers:

- ``logprob_err``: |the program's log-probability of a served word - the
  reference's|;
- ``logit_gap``: the reference's top logit less its logit at the served
  word;
- ``sim_err``: the largest difference between the served class-region
  similarity and the reference's;

the first two over every served position of the judged segments, the
largest or the quantile ``QUANTILE`` (the check file says which, and
why).
"""

from __future__ import annotations

import gc
import random
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import harness, traffic, weights_lm, work_lm
from benchmark.reference import lm as ref_lm
from benchmark.reference.gvd import GVDReference, Ops

# the statistic of logprob_err and logit_gap over the judged positions:
# None the largest, else this quantile (checks/kimivl-greedy.json)
QUANTILE = 0.9


def config(cell: harness.Cell):
    from grounded_video_description_torch.config import GVDLMConfig
    return GVDLMConfig(**cell.model, **cell.config["kernels"]["serve"],
                     dtype=cell.config["dtype"]["encoder"],
                     lm=cell.config["lm"]).validate()


def program(cell: harness.Cell, weights: Dict[str, torch.Tensor], cfg=None):
    """The program's evaluator over a model of the cell's configuration
    (``cfg``, else ``config(cell)``) built on the meta device and holding
    ``weights`` themselves."""
    from grounded_video_description_torch.engine.evaluator import Evaluator
    from grounded_video_description_torch.models.gvd import GVDModel
    cfg = cfg or config(cell)
    with torch.device("meta"):
        model = GVDModel(cfg)
    model.load_state_dict(weights, assign=True)
    return Evaluator(cfg, model.eval(), vocab=None)


def inputs(cell: harness.Cell, calls: int = 0) -> List[Dict[str, np.ndarray]]:
    mix = dict(cell.traffic)
    if calls:
        mix["distinct_batches"] = calls
    return traffic.host_batches(cell.model, mix, cell.seed + 1, cell.device)


def free(cell: harness.Cell) -> None:
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def judged(cell: harness.Cell, samples: List[Tuple[int, Dict]],
           batches: List[Dict[str, np.ndarray]], mode: str = "program",
           quantiles=(QUANTILE,)) -> Dict:
    """The numbers over ``samples`` ((batch index, served outputs)), the
    reference in float32 judging, for each of ``quantiles``. ``mode``
    "control": the reference serves in the program's place with its
    encoder's products in TF32 and its language model's in float8 (each a
    precision below the configuration's); "fault": the reference in
    float32 routing each token to one expert fewer."""
    dev, block = cell.device, cell.config["lm"]
    enc_ref = GVDReference(weights_lm.encoder_block(cell.config)).to(dev)
    enc_ref.load_state_dict(weights_lm.encoder_weights(cell.config,
                                                       cell.seed, dev))
    lm_ref = ref_lm.LMReference(block, weights_lm.lm_weights(
        cell.config, cell.seed, dev))
    ops, lm_ops = Ops("f32"), ref_lm.LMOps("f32")
    n = cell.traffic["judged_segments"]
    rng = random.Random(cell.seed + 5)
    errs, gaps, sim = [], [], 0.0
    with torch.no_grad():
        for bi, out in samples:
            rows = sorted(rng.sample(range(len(out["seq"])), n))
            b = {k: torch.as_tensor(v[rows]).to(dev)
                 for k, v in batches[bi].items()}
            enc = enc_ref.encode(ops, b)
            seq = torch.as_tensor(out["seq"][rows]).to(dev)
            served = {"seq": seq, "logprobs": torch.as_tensor(
                          out["logprobs"][rows]).to(dev),
                      "sim_mat": torch.as_tensor(out["sim_mat"][rows]).to(dev)}
            visual = torch.cat([enc["conv"], enc["pool"]], 1)
            logits = lm_ref.logits(lm_ops, visual, seq[:, :-1])
            if mode == "control":
                low = enc_ref.encode(Ops("tf32"), b)
                served = {**ref_lm.control_outputs(lm_ref.logits(
                    ref_lm.LMOps("fp8"),
                    torch.cat([low["conv"], low["pool"]], 1), seq[:, :-1])),
                    "sim_mat": low["sim_mat"]}
            elif mode == "fault":
                served = {**ref_lm.control_outputs(lm_ref.logits(
                    lm_ops, visual, seq[:, :-1],
                    top_k=block["num_experts_per_tok"] - 1)),
                    "sim_mat": enc["sim_mat"]}
            e, g = ref_lm.position_errors(logits, served["seq"],
                                          served["logprobs"])
            errs.append(e)
            gaps.append(g)
            sim = max(sim, float((served["sim_mat"].float()
                                  - enc["sim_mat"]).abs().max()))
            del logits, enc
    err, gap = torch.cat(errs), torch.cat(gaps)
    out = {}
    for q in quantiles:
        out[q] = {"logprob_err": ref_lm.statistic(err, q),
                  "logit_gap": ref_lm.statistic(gap, q), "sim_err": sim}
    return out


def run(cell: harness.Cell) -> harness.Run:
    mix = cell.traffic
    cfg = config(cell)      # a program without the captioner stops here
    batches = inputs(cell)
    ev = program(cell, weights_lm.program_weights(cell.config, cell.seed,
                                                  cell.device), cfg)
    for i in range(mix["warmup_calls"]):
        ev.generate(batches[i % len(batches)])
    if cell.device == "cuda":
        torch.cuda.synchronize()
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
        work={"flops_per_unit": work_lm.serve_flops(cell.config, B),
              "dtype": cell.config["dtype"]["lm"], "batch": B})
    if cell.trace:
        n = mix["traced_calls"]

        def traced():
            for k in range(n):
                ev.generate(batches[k % len(batches)])
        result.trace = harness.profiled(traced, n)

    del ev
    free(cell)
    result.numbers = judged(cell, samples, batches)[QUANTILE]
    words = sum(int((out["seq"] != 0).sum()) for _, out in samples)
    print(f"judged {cell.traffic['judged_segments']} segments of each of "
          f"{len(samples)} calls; {words} of "
          f"{sum(out['seq'].size for _, out in samples)} served words are "
          "not the end word", file=sys.stderr)
    return result


def readings(cell: harness.Cell, control: bool = True) -> Dict:
    """For ``calibrate.py``: the numbers of the program over the calls a
    run judges, served outside a window, and (``control``) of the control
    and of the fault, each as the largest and at a few quantiles."""
    batches = inputs(cell, cell.traffic["judged_calls"])
    ev = program(cell, weights_lm.program_weights(cell.config, cell.seed,
                                                  cell.device))
    served = [(i, ev.generate(b)) for i, b in enumerate(batches)]
    del ev
    free(cell)
    qs = (None, 0.999, 0.99, 0.9, 0.5)

    def named(r):
        return {"max" if q is None else f"q{q}": v for q, v in r.items()}

    out = {"program": named(judged(cell, served, batches, quantiles=qs))}
    if control:
        for mode in ("control", "fault"):
            out[mode] = named(judged(cell, served, batches, mode, qs))
    return out
