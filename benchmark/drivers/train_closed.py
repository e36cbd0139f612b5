"""Closed-loop training: one caller moves each batch of host arrays to the
card (``engine/trainer.py::batch_to_device``) and takes one supervised
step on it (``Trainer.train_step``: the microbatches' forward and
backward, the clip, Adam), waiting for the step to end before the next;
the mix's ``distinct_batches`` batches are cycled. This is the body of
``Trainer.fit_epoch``.

- ``train_segments_per_s``: the batch size times the steps completed in
  the window, over the time from the window's start to the end of the
  last step started before ``--seconds`` had passed.
- ``setup_s``: from the process's start to the window, including the
  first three steps.

Set-up builds one trainer from the seed and takes its first three steps
through the window's own call, on three distinct batches; it reads the
losses and pre-clip norm of each, the first step's gradient as Adam holds
it, and the parameters' change after the third. The window then goes on
with the same trainer. Afterwards the program is freed and the plain
reference takes the same three steps from the same weights, batches and
dropout generator (``reference/train.py``).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, traffic, work
from benchmark.reference import train as ref_train
from benchmark.reference.gvd import GVDReference
from benchmark.weights import draw_weights

FOLLOWED = 3          # the steps the reference follows


def config(cell: harness.Cell):
    from grounded_video_description_torch.config import GVDConfig
    mix = cell.traffic
    return GVDConfig(**cell.model, **cell.config["kernels"]["train"],
                     **cell.config["train"], dtype=cell.config["dtype"],
                     batch_size=mix["batch_size"],
                     grad_accum=mix["grad_accum"]).validate()


def program(cell: harness.Cell, weights: Dict[str, torch.Tensor]):
    """The program's trainer over a model holding ``weights``, its dropout
    generator seeded from the cell's seed."""
    from grounded_video_description_torch.engine.trainer import Trainer
    from grounded_video_description_torch.models.gvd import GVDModel
    cfg = config(cell)
    with torch.device(cell.device):
        model = GVDModel(cfg)
    model.load_state_dict(weights)
    gen = torch.Generator(device=cell.device).manual_seed(cell.seed + 2)
    return Trainer(cfg, model.train(), generator=gen)


def inputs(cell: harness.Cell) -> List[Dict[str, np.ndarray]]:
    return traffic.host_batches(cell.model, cell.traffic, cell.seed + 1,
                                cell.device)


def synchronize(cell: harness.Cell) -> None:
    if cell.device == "cuda":
        torch.cuda.synchronize()


def first_steps(cell: harness.Cell, trainer, step, batches,
                weights: Dict[str, torch.Tensor]) -> Dict:
    """The program's readings over its first ``FOLLOWED`` steps."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    readings: Dict = {"losses": []}
    for i in range(FOLLOWED):
        metrics = step(batches[i % len(batches)])
        readings["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            readings["grad"] = ref_train.leaf_norms({
                names[id(p)]: ref_train.first_gradient(s["exp_avg"])
                for p, s in trainer.optimizer.state.items()})
    params = dict(trainer.model.named_parameters())
    readings["delta"] = ref_train.leaf_norms({
        n: params[n].detach() - weights[n] for n in readings["grad"]})
    return readings


def followed(cell: harness.Cell, batches, precision: str = "f32",
             keep_rows=None) -> Dict:
    """The reference's readings over the same steps, in ``precision``
    (``keep_rows``: a fault, each microbatch cut to that share of its
    rows)."""
    dev = cell.device
    ref = GVDReference(cell.model).to(dev)
    ref.load_state_dict(draw_weights(cell.config, cell.seed, dev))
    dev_batches = [{k: torch.as_tensor(v).to(dev) for k, v in
                    batches[i % len(batches)].items()}
                   for i in range(FOLLOWED)]
    return ref_train.follow(ref, cell.config["train"], precision, cell.seed + 2,
                            dev_batches, cell.traffic["grad_accum"],
                            keep_rows)


def free(cell: harness.Cell) -> None:
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()


def run(cell: harness.Cell) -> harness.Run:
    from grounded_video_description_torch.engine.trainer import (
        batch_to_device)
    mix = cell.traffic
    batches = inputs(cell)
    weights = draw_weights(cell.config, cell.seed, cell.device)
    trainer = program(cell, weights)
    cfg, lr = trainer.cfg, trainer.cfg.learning_rate

    def step(b):
        return trainer.train_step(batch_to_device(cfg, b, cell.device), lr)

    readings = first_steps(cell, trainer, step, batches, weights)
    del weights
    synchronize(cell)
    setup_s = time.perf_counter() - cell.started

    steps, start = 0, time.perf_counter()
    while True:
        step(batches[(FOLLOWED + steps) % len(batches)])
        synchronize(cell)
        steps += 1
        end = time.perf_counter()
        if end - start >= cell.seconds:
            break
    window_s = end - start
    B = mix["batch_size"]
    peak = torch.cuda.max_memory_allocated() if cell.device == "cuda" else 0
    result = harness.Run(
        cell=cell, attempted=steps, failed=0,
        metrics={"train_segments_per_s": B * steps / window_s,
                 "setup_s": setup_s},
        memory_peak_bytes=peak,
        window={"seconds": window_s, "units": steps},
        work={"flops_per_unit": work.train_flops(cell.model, B),
              "dtype": cell.config["dtype"], "batch": B,
              "microbatches": mix["grad_accum"]})
    if cell.trace:
        n = mix["traced_steps"]

        def traced():
            for k in range(n):
                step(batches[k % len(batches)])
        result.trace = harness.profiled(traced, n)
    del trainer, step
    free(cell)
    want = followed(cell, batches)
    result.numbers = ref_train.numbers(readings, want)
    moved = set(ref_train.moved_leaves(want["grad"]))
    print(f"step_err over {len(moved)} of {len(want['grad'])} leaves; left "
          f"out: {sorted(set(want['grad']) - moved)}", file=sys.stderr)
    return result


def readings(cell: harness.Cell, control: bool = True) -> Dict:
    """For ``calibrate.py``: the numbers of the program and (``control``)
    of the control, the reference in TF32 in its place, and of a fault,
    the reference with half of each microbatch's rows left out and the
    means taken over the rest. A state left unchanged reads 1 on
    ``step_err`` by its definition and needs no run."""
    from grounded_video_description_torch.engine.trainer import (
        batch_to_device)
    batches = inputs(cell)[:FOLLOWED]
    weights = draw_weights(cell.config, cell.seed, cell.device)
    trainer = program(cell, weights)
    cfg, lr = trainer.cfg, trainer.cfg.learning_rate
    got = first_steps(cell, trainer, lambda b: trainer.train_step(
        batch_to_device(cfg, b, cell.device), lr), batches, weights)
    del trainer, weights
    free(cell)
    want = followed(cell, batches)
    out = {"program": ref_train.numbers(got, want),
           "losses": [x["loss"] for x in got["losses"]]}
    if control:
        out["control"] = ref_train.numbers(followed(cell, batches, "tf32"),
                                           want)
        out["half_batch"] = ref_train.numbers(
            followed(cell, batches, keep_rows=0.5), want)
    return out
