"""Closed-loop data-parallel training over ``ranks`` cards: ``train_closed``
on a data mesh of ``ranks`` processes, one a card, over NCCL
(``parallel/mesh.py``: ``init_mesh``, ``shard_rows``; the trainer sums
the gradients over the mesh once a step). Rank 0 runs in this process,
so the window, the trace and the judging stay where the harness reads
them; ranks 1.. are spawned, each draws the same weights and batches
from the seed and keeps its rows of each microbatch. Before each step
rank 0 broadcasts the index of the batch the mesh takes, or -1 to stop.

- ``train_segments_per_s``: the batch size times the steps completed in
  the window over the window, as ``train_closed``'s.
- ``setup_s``: from the process's start to the window, including the
  ranks' start and the first three steps.

The judging is ``train_closed``'s, imported: rank 0 reads the losses and
pre-clip norm of the mesh's first three steps (each the whole batch's),
the first step's gradient as Adam holds it and the parameters' change
after the third; after the window the ranks are stopped and the plain
reference takes the same three steps on one card on the whole batches.
"""

from __future__ import annotations

import socket
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, work
from benchmark.drivers import train_closed as closed
from benchmark.reference import train as ref_train
from benchmark.weights import draw_weights

STOP = -1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def device_of(cell: harness.Cell, rank: int) -> str:
    return f"cuda:{rank}" if cell.device == "cuda" else "cpu"


class Rank:
    """One rank of the mesh: its trainer over the cell's weights, its rows
    of each of the mix's batches (host arrays) and its step."""

    def __init__(self, cell: harness.Cell, rank: int, port: int,
                 batches: List[Dict[str, np.ndarray]]):
        from grounded_video_description_torch.parallel.mesh import (
            init_mesh, shard_rows)
        mix = cell.traffic
        dev = device_of(cell, rank)
        self.mesh = init_mesh(dev, shape=[mix["ranks"]], rank=rank,
                              init_method=f"tcp://localhost:{port}")
        rows = shard_rows(mix["batch_size"], mix["grad_accum"], rank,
                          mix["ranks"])
        self.batches = [{k: np.ascontiguousarray(v[rows])
                         for k, v in b.items()}
                        for b in batches]
        self.weights = draw_weights(cell.config, cell.seed, dev)
        self.trainer = self._trainer(cell, dev)
        self.device = dev

    def _trainer(self, cell: harness.Cell, dev: str):
        from grounded_video_description_torch.engine.trainer import Trainer
        from grounded_video_description_torch.models.gvd import GVDModel
        cfg = closed.config(cell).replace(mesh_shape=[self.mesh.data])
        with torch.device(dev):
            model = GVDModel(cfg)
        model.load_state_dict(self.weights)
        gen = torch.Generator(device=dev).manual_seed(cell.seed + 2)
        return Trainer(cfg, model.train(), generator=gen, mesh=self.mesh)

    def announce(self, index: int = 0) -> int:
        """Rank 0's batch index (or ``STOP``) on every rank."""
        import torch.distributed as dist
        t = torch.tensor([index], device=self.device)
        dist.broadcast(t, src=0, group=self.mesh.group)
        return int(t.item())

    def step(self, index: int) -> Dict[str, torch.Tensor]:
        """The mesh's step on batch ``index``: announced from rank 0."""
        from grounded_video_description_torch.engine.trainer import (
            batch_to_device)
        if self.mesh.writer:
            self.announce(index)
        tr = self.trainer
        return tr.train_step(batch_to_device(
            tr.cfg, self.batches[index], self.device), tr.cfg.learning_rate)

    def follow(self) -> None:
        """Ranks 1..: the steps rank 0 announces, until it stops."""
        while True:
            index = self.announce()
            if index == STOP:
                break
            self.step(index)

    def close(self) -> None:
        from grounded_video_description_torch.parallel.mesh import close_mesh
        if self.mesh.writer:
            self.announce(STOP)
        close_mesh(self.mesh)


def worker(i: int, cell: harness.Cell, port: int) -> None:
    """Rank i + 1's process."""
    rank = Rank(cell, i + 1, port, closed.inputs(cell))
    rank.follow()
    rank.close()


def start_ranks(cell: harness.Cell, port: int):
    """Ranks 1.. in processes of their own (spawned: this module by its
    import path), not waited for."""
    import torch.multiprocessing as mp
    from benchmark.drivers import train_closed_dp
    return mp.start_processes(train_closed_dp.worker, args=(cell, port),
                              nprocs=cell.traffic["ranks"] - 1, join=False,
                              start_method="spawn")


def stop_ranks(ctx, timeout_s: float = 600.0) -> None:
    """Waits for the spawned ranks (raising for one that failed); kills
    those still alive past ``timeout_s`` or on an error."""
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError("the spawned ranks did not stop")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def first_steps(cell: harness.Cell, rank: Rank) -> Dict:
    """``train_closed``'s readings of the mesh's first steps on rank 0."""
    return closed.first_steps(cell, rank.trainer, rank.step,
                              list(range(closed.FOLLOWED)), rank.weights)


def run(cell: harness.Cell) -> harness.Run:
    mix = cell.traffic
    port = free_port()
    ctx = start_ranks(cell, port)
    try:
        batches = closed.inputs(cell)
        rank = Rank(cell, 0, port, batches)
        readings = first_steps(cell, rank)
        rank.weights = None
        closed.synchronize(cell)
        setup_s = time.perf_counter() - cell.started

        n = len(rank.batches)
        steps, start = 0, time.perf_counter()
        while True:
            rank.step((closed.FOLLOWED + steps) % n)
            closed.synchronize(cell)
            steps += 1
            end = time.perf_counter()
            if end - start >= cell.seconds:
                break
        window_s = end - start
        B = mix["batch_size"]
        peak = torch.cuda.max_memory_allocated() \
            if cell.device == "cuda" else 0
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
            traced = mix["traced_steps"]

            def stretch():
                for k in range(traced):
                    rank.step(k % n)
            result.trace = harness.profiled(stretch, traced)
        rank.close()
    finally:
        stop_ranks(ctx)
    del rank
    closed.free(cell)
    want = closed.followed(cell, batches)
    result.numbers = ref_train.numbers(readings, want)
    moved = set(ref_train.moved_leaves(want["grad"]))
    print(f"{mix['ranks']} ranks; step_err over {len(moved)} of "
          f"{len(want['grad'])} leaves", file=sys.stderr)
    return result


def readings(cell: harness.Cell, control: bool = True) -> Dict:
    """For ``calibrate.py``: the mesh's numbers over its first steps, and
    (``control``) ``train_closed``'s control and fault on one card."""
    port = free_port()
    ctx = start_ranks(cell, port)
    try:
        batches = closed.inputs(cell)
        rank = Rank(cell, 0, port, batches)
        got = first_steps(cell, rank)
        rank.close()
    finally:
        stop_ranks(ctx)
    del rank
    closed.free(cell)
    want = closed.followed(cell, batches)
    out = {"program": ref_train.numbers(got, want),
           "losses": [x["loss"] for x in got["losses"]]}
    if control:
        out["control"] = ref_train.numbers(
            closed.followed(cell, batches, "tf32"), want)
        out["half_batch"] = ref_train.numbers(
            closed.followed(cell, batches, keep_rows=0.5), want)
    return out
