"""The device mesh of the port: one process per device in a
``torch.distributed`` process group, laid out as a (D, M) grid.

The counterpart of ``grounded_video_description_tpu/parallel/mesh.py``,
where ``jax.jit`` partitions the global step over a ("data", "model")
device mesh.  Rank r is (d, m) = divmod(r, M), the order of the JAX
``make_mesh``'s reshape; the data group joins the D ranks of one m, the
model group the M ranks of one d.  Here each rank runs the model on its
data index's rows of every microbatch and the ranks meet in explicit
collectives, placed so that a step of D x M ranks computes the step of
one device on the whole batch:

* rows: rank (d, m) takes rows [i n + d n / D, i n + (d + 1) n / D) of
  microbatch i, n = batch / accum (``shard_rows``), as the JAX trainer
  shards axis 1 of the (accum, n) reshaped batch; the M ranks of one d
  hold the same rows;
* gradients: summed over the data group once a step, after the
  accumulation loop, in one collective per dtype
  (``all_reduce_grads_sum``), over losses that ``spmd.py`` renormalizes
  by the global mask counts;
* BatchNorm: statistics of the whole microbatch through a differentiable
  all-reduce over the data group (``all_reduce_sum``, which
  ``nn.core.batch_norm_train`` takes under a ``RowShard``);
* dropout: every rank runs the same generator stream and keeps its data
  index's rows of each whole-microbatch mask (``RowShard``), and K4 and
  K5 hash global rows (their ``row0``);
* the model axis splits the vocab head and the visual-word table over
  the model group (``parallel/tensor.py``).

The backend follows the device: NCCL for CUDA, gloo for the CPU.  An
explicit ``backend`` is taken as given (two ranks on one card need gloo,
since NCCL refuses two ranks on one device); nothing falls back to
another backend or device by itself.
"""

from __future__ import annotations

import datetime
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 1800        # of every collective, the rendezvous included


@dataclass(frozen=True)
class Mesh:
    """A (D, M) grid of ranks: this process's ``rank`` and ``device``, the
    world's process ``group`` and the groups of its data and model axes
    (each None where its axis has one rank)."""
    shape: Tuple[int, int]
    rank: int
    device: torch.device
    group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def world(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def data(self) -> int:
        """D, the ranks of the data axis."""
        return self.shape[0]

    @property
    def model(self) -> int:
        """M, the ranks of the model axis."""
        return self.shape[1]

    @property
    def data_rank(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_rank(self) -> int:
        return self.rank % self.shape[1]

    @property
    def writer(self) -> bool:
        """Rank 0 writes the files and the metrics of a run."""
        return self.rank == 0


def init_mesh(device, *, shape: Sequence[int], rank: int, init_method: str,
              backend: Optional[str] = None) -> Mesh:
    """Join the process group of the (D, M) ``shape``'s D x M ranks (a
    one-element shape is (D, 1)) as ``rank`` on ``device``
    (``init_method``: ``tcp://host:port`` or ``file://path``), and make
    the groups of its axes.  The backend is the device's (NCCL for CUDA,
    gloo for the CPU) unless ``backend`` names one."""
    shape = (tuple(shape) + (1,))[:2]
    D, M = shape
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method,
        world_size=D * M, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    world = dist.group.WORLD

    def axis_groups(members):
        """Every rank makes every group, in one order; returns this
        rank's."""
        mine = None
        for ranks in members:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    data_group = model_group = None
    if D > 1:
        data_group = world if M == 1 else axis_groups(
            [[d * M + m for d in range(D)] for m in range(M)])
    if M > 1:
        model_group = world if D == 1 else axis_groups(
            [[d * M + m for m in range(M)] for d in range(D)])
    return Mesh(shape, rank, device, world, data_group, model_group)


def close_mesh(mesh: Optional[Mesh]) -> None:
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: Sequence = (),
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(i, *args)`` in ``nprocs`` new processes and wait for all
    of them.  A child that raises or dies raises here; past ``timeout_s``
    every child is killed and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{nprocs} workers did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


# --------------------------------------------------------------------- #
# rows
# --------------------------------------------------------------------- #

def shard_rows(n: int, accum: int, rank: int, world: int) -> np.ndarray:
    """The rows of a batch of ``n`` that rank ``rank`` of ``world`` trains
    on: its slice of each of the ``accum`` microbatches, in order."""
    if n % accum or (n // accum) % world:
        raise ValueError(f"a batch of {n} in {accum} microbatches does not "
                         f"split over {world} ranks")
    m = n // accum
    k = m // world
    return np.concatenate([np.arange(i * m + rank * k, i * m + (rank + 1) * k)
                           for i in range(accum)])


def split_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous share of ``n`` rows (evaluation)."""
    return slice(n * rank // world, n * (rank + 1) // world)


@dataclass(frozen=True)
class RowShard:
    """What a data-parallel training forward needs beside the model: the
    dropout ``generator`` (the same stream on every rank), this rank's
    rows of the microbatch (``rows`` of ``total``, from ``row0``) and the
    process ``group`` BatchNorm reduces over (the data group).  The
    model's ``generator`` arguments take it in place of a
    ``torch.Generator``."""
    generator: torch.Generator
    row0: int
    rows: int
    total: int
    group: Any = None

    def span(self, x: torch.Tensor):
        """(first global row, rows of the whole microbatch) for a tensor
        whose leading axis holds this rank's rows, each repeated k times in
        a row (k = 1, or seq_per_img captions per segment)."""
        k, rest = divmod(x.shape[0], self.rows)
        if rest or not k:
            raise ValueError(f"a leading axis of {x.shape[0]} does not hold "
                             f"this rank's {self.rows} rows")
        return k * self.row0, k * self.total


def generator_of(g):
    """The ``torch.Generator`` of a generator argument."""
    return g.generator if isinstance(g, RowShard) else g


def group_of(g):
    """The process group of BatchNorm's statistics under a generator
    argument (None: this process's rows alone)."""
    return g.group if isinstance(g, RowShard) else None


def row0_of(g, x: torch.Tensor) -> int:
    """The global row of x's first row under a generator argument."""
    return g.span(x)[0] if isinstance(g, RowShard) else 0


# --------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------- #

class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; the gradient of every rank's x is
    the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The differentiable sum of x over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def _by_dtype(tensors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: Dict[Any, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return list(groups.values())


def _flat_collective(tensors: List[torch.Tensor], op) -> None:
    """``op`` on one flat copy of ``tensors`` per dtype, copied back."""
    with torch.no_grad():
        for ts in _by_dtype(tensors):
            flat = torch.cat([t.reshape(-1) for t in ts])
            op(flat)
            o = 0
            for t in ts:
                t.copy_(flat[o:o + t.numel()].view_as(t))
                o += t.numel()


def all_reduce_sum_(group, tensors: List[torch.Tensor]) -> None:
    """Sum ``tensors`` over the ranks of ``group`` in place, one
    collective per dtype."""
    _flat_collective(tensors, lambda f: dist.all_reduce(f, group=group))


def all_reduce_grads_sum(mesh: Mesh, params: List[torch.Tensor]) -> None:
    """Sum the ``.grad`` of ``params`` over the data group: each rank's
    gradient is of its data index's count-renormalized share of the loss,
    so the sum is the whole batch's gradient.  Every rank runs the same
    graph, so the same parameters hold a gradient on each; a model-axis
    rank's slice of the head sums with the same slice of the other data
    indices."""
    if mesh.data > 1:
        all_reduce_sum_(mesh.data_group,
                        [p.grad for p in params if p.grad is not None])


def broadcast_module(mesh: Mesh, module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    tensors = list(module.parameters()) + list(module.buffers())
    _flat_collective(tensors, lambda f: dist.broadcast(
        f, src=0, group=mesh.group))


def gather_rows(mesh: Mesh,
                arrays: Optional[Dict[str, np.ndarray]]
                ) -> Optional[Dict[str, np.ndarray]]:
    """Every rank's host arrays, concatenated along the rows in rank
    order, on rank 0 (None on the others).  A rank without rows passes
    None."""
    parts: Optional[List] = [None] * mesh.world if mesh.writer else None
    dist.gather_object(arrays, parts, dst=0, group=mesh.group)
    if not mesh.writer:
        return None
    parts = [p for p in parts if p is not None]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.world > 1:
        dist.barrier(group=mesh.group)
