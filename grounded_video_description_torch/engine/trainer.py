"""Training engine of the port: the supervised MLE step.

Counterpart of ``grounded_video_description_tpu/engine/trainer.py``
(reference: main.py:197-311, 652-684): the four-loss weighted objective,
a global-norm gradient clip, Adam / SGD (momentum 0.9) / Adamax with a
0.1x learning rate on the transferred layers (``ctx2pool_grd``,
``vis_embed``), the epoch learning-rate decay, and gradient accumulation
over sequential microbatches that reproduces the full batch's gradient.

The JAX package's optax chain (clip, torch-style L2, the base optimizer,
the 0.1 scale on the transferred layers, -lr) is a torch optimizer with
two parameter groups here; the clip runs before it, in ``train_step``,
with optax's formula.

With a ``Mesh`` the step is the JAX mesh step's (``parallel/``): each
rank holds its data index's rows of every microbatch
(``parallel.shard_rows``), the mask counts are summed over the data
group, the gradients once after the accumulation loop, and the forward
runs under a ``RowShard`` (BatchNorm over the whole microbatch, dropout
masks and K4's and K5's hashes of the global rows).  On a model axis the
vocab head and the visual-word table are split over the model group
(``parallel/tensor.py``), with their Adam moments, and the clip's norm
counts each slice once.  So D x M ranks take the step one device takes
on the whole batch.

With ``profile_dir`` the trainer traces three steps from its second
(``utils.logging.ProfilerHooks``; on rank 0 of a mesh).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from grounded_video_description_torch import losses as L
from grounded_video_description_torch.config import GVDConfig
from grounded_video_description_torch.models.gvd import (
    GVDModel, batch_to_tensors)
from grounded_video_description_torch.parallel import spmd
from grounded_video_description_torch.parallel.mesh import (
    Mesh, RowShard, all_reduce_grads_sum, broadcast_module)
from grounded_video_description_torch.parallel.spmd import COUNTS
from grounded_video_description_torch.parallel.tensor import (
    shard_model, split_params)
from grounded_video_description_torch.utils.logging import span

FINETUNE_KEYS = ("ctx2pool_grd", "vis_embed")


def make_optimizer(cfg: GVDConfig, model: GVDModel) -> torch.optim.Optimizer:
    """The optimizer of ``make_optimizer`` (trainer.py:76-99) without its
    clip: torch-style L2 (``weight_decay``, added to the gradient before
    the moments), then Adam / SGD / Adamax.  Group 1 holds the transferred
    layers, whose learning rate is ``finetune_lr_scale`` times the base
    one; each group's ``lr_scale`` says which.  Frozen parameters (the
    LSTMs' zero ``bias_hh``) are left out."""
    main, finetune = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            top = name.split(".")[0]
            (finetune if top in FINETUNE_KEYS else main).append(p)
    groups = [{"params": main, "lr_scale": 1.0},
              {"params": finetune, "lr_scale": cfg.finetune_lr_scale}]
    betas = (cfg.optim_alpha, cfg.optim_beta)
    if cfg.optim == "adam":
        return torch.optim.Adam(groups, lr=cfg.learning_rate, betas=betas,
                                eps=cfg.optim_epsilon,
                                weight_decay=cfg.weight_decay)
    if cfg.optim == "sgd":
        return torch.optim.SGD(groups, lr=cfg.learning_rate, momentum=0.9,
                               weight_decay=cfg.weight_decay)
    return torch.optim.Adamax(groups, lr=cfg.learning_rate, betas=betas,
                              eps=cfg.optim_epsilon,
                              weight_decay=cfg.weight_decay)


def clip_by_global_norm(params: List[torch.Tensor], max_norm: float,
                        split: Sequence[torch.Tensor] = (),
                        group=None) -> torch.Tensor:
    """optax.clip_by_global_norm on the ``.grad`` of ``params``, in
    place: g * max_norm / |g| only where |g| >= max_norm (no epsilon, as
    ``torch.nn.utils.clip_grad_norm_`` adds).  Returns |g| on the device,
    with no host synchronisation.

    ``split``: the parameters of ``params`` that a model axis splits over
    ``group``; their squared norms are summed over it, so each slice counts
    once and each replicated parameter once."""
    ids = {id(p) for p in split}
    held = [p for p in params if p.grad is not None]
    grads = [p.grad for p in held]
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    if ids:
        is_split = torch.tensor([id(p) in ids for p in held],
                                device=norms.device)
        sq = norms * norms
        sq_split = torch.where(is_split, sq, 0.0).sum()
        dist.all_reduce(sq_split, group=group)
        norm = torch.sqrt(torch.where(is_split, 0.0, sq).sum() + sq_split)
    else:
        norm = torch.linalg.vector_norm(norms)
    factor = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm


def batch_to_device(cfg: GVDConfig, batch: Dict,
                    device) -> Dict[str, torch.Tensor]:
    """``batch_to_tensors`` with the host-side cast of the JAX Trainer:
    with bf16 compute the two feature banks (seg_feat, ppls_feat) are cast
    to bf16 on the host, halving their transfer; the model casts them to
    bf16 on arrival anyway.  Geometry (ppls, gt_boxes) stays f32 for the
    IoU targets.  To a CUDA device the batch goes through the device's
    pinned staging ring and the cast happens in its staging copy (rounding
    as ``Tensor.to``); to the CPU it takes ``Tensor.to``.  Under the
    ``h2d`` span, with the bytes copied (as they arrive)."""
    cast = ({k: torch.bfloat16 for k in ("seg_feat", "ppls_feat")}
            if cfg.dtype == "bfloat16" else None)
    with span("h2d", nbytes=lambda: sum(
            t.nbytes for t in out.values())):
        out = batch_to_tensors(batch, device, cast)
        return out


class Trainer:
    """Holds the model, its optimizer, the dropout generator (on the
    model's device, seeded with ``cfg.seed`` unless one is given) and the
    count of updates made (``step``, which the checkpoint saves).  With a
    ``mesh`` every rank starts from rank 0's weights and runs the same
    generator stream; on a model axis the model keeps its slices of the
    split parameters (``parallel.tensor.shard_model``)."""

    def __init__(self, cfg: GVDConfig, model: GVDModel,
                 generator: torch.Generator = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.model = model
        self.mesh = mesh
        if mesh is not None:
            broadcast_module(mesh, model)
            shard_model(model, mesh)
        self.device = next(model.parameters()).device
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(cfg.seed)
        self.optimizer = make_optimizer(cfg, model)
        self.params = [p for g in self.optimizer.param_groups
                       for p in g["params"]]
        self.split = split_params(self)
        self.step = 0
        self.profiler = None

    def lr_at_epoch(self, epoch: int) -> float:
        """main.py:679-684: times decay_rate every decay_every epochs past
        decay_start."""
        cfg = self.cfg
        lr = cfg.learning_rate
        if cfg.learning_rate_decay_start >= 0:
            for e in range(cfg.learning_rate_decay_start + 1, epoch + 1):
                if (e - cfg.learning_rate_decay_start) \
                        % cfg.learning_rate_decay_every == 0:
                    lr *= cfg.learning_rate_decay_rate
        return lr

    def _generator(self, rows: int):
        """The forward's generator argument for a microbatch of which this
        process holds ``rows`` rows."""
        mesh = self.mesh
        if mesh is None or mesh.data == 1:
            return self.generator
        return RowShard(self.generator, row0=mesh.data_rank * rows,
                        rows=rows, total=mesh.data * rows,
                        group=mesh.data_group)

    def train_step(self, batch: Dict[str, torch.Tensor],
                   lr: float) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` (tensors on the model's device; with a
        mesh, this rank's rows, ``parallel.shard_rows``) over
        ``cfg.grad_accum`` sequential microbatches.

        The supervision is computed once for the batch and sliced per
        microbatch.  Each microbatch's masked mean is scaled by its count
        over the whole batch's count (over every rank) and the scaled
        gradients are summed, over the microbatches and then, in one
        collective, over the ranks, which is the whole batch's gradient
        (trainer.py:209-306, spmd.py:47-72).  The BatchNorm statistics are
        carried from one microbatch to the next.  Returns the loss terms
        summed over the microbatches and the ranks (each the whole batch's
        value) and the global gradient norm before the clip, as 0-d
        tensors on the device.

        Spans (``utils/logging.py``): the step is ``train_step``; in it
        each microbatch's model call and total loss are ``forward`` and
        its ``loss.backward()`` is ``backward``; the mesh reductions, the
        clip, the optimizer's step and ``zero_grad`` are ``optimizer``, and
        in it the gradients' sum over the mesh is ``allreduce`` (with the
        gradients' bytes)."""
        cfg, model = self.cfg, self.model
        accum = cfg.grad_accum
        with span("train_step"):
            sup = model.supervision(batch)
            totals = spmd.global_counts(self.mesh, sup)
            sup_rows = {k: v for k, v in sup.items() if k not in COUNTS}

            def part(t: torch.Tensor, i: int) -> torch.Tensor:
                n = t.shape[0] // accum
                return t[i * n:(i + 1) * n]

            metrics = None
            for i in range(accum):
                mb = {k: part(v, i) for k, v in batch.items()}
                with span("forward"):
                    losses, bn_state = model(
                        mb, mode="MLE", train=True,
                        generator=self._generator(mb["seg_feat"].shape[0]),
                        sup={k: part(v, i) for k, v in sup_rows.items()})
                    frac = spmd.renormalized(losses, totals)
                    loss = L.total_loss(
                        frac["lm_loss"], frac["att2_loss"],
                        frac["ground_loss"], frac["cls_loss"],
                        w_att2=cfg.w_att2, w_grd=cfg.w_grd, w_cls=cfg.w_cls,
                        disable_caption=cfg.disable_caption)
                with span("backward"):
                    loss.backward()
                model.set_bn_state(bn_state)
                step = {"loss": loss.detach(),
                        **{k: v.detach() for k, v in frac.items()}}
                metrics = step if metrics is None else {
                    k: metrics[k] + step[k] for k in metrics}
            with span("optimizer"):
                if self.mesh is not None:
                    with span("allreduce", nbytes=lambda: sum(
                            p.grad.nbytes for p in self.params
                            if p.grad is not None)):
                        all_reduce_grads_sum(self.mesh, self.params)
                    metrics = spmd.sum_metrics(self.mesh, metrics)
                metrics["grad_norm"] = clip_by_global_norm(
                    self.params, cfg.grad_clip, self.split,
                    self.mesh.model_group if self.split else None)
                for group in self.optimizer.param_groups:
                    group["lr"] = lr * group["lr_scale"]
                self.optimizer.step()
                self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return metrics

    def fit_epoch(self, loader: Iterable[Dict], epoch: int,
                  log_fn: Optional[Callable[[Dict], None]] = None
                  ) -> Dict[str, float]:
        """One epoch over the loader's numpy batches (trainer.py:324-417):
        each, without its ``seg_id`` and ``n_valid``, goes to the device
        (``batch_to_device``) and through ``train_step`` at the epoch's
        learning rate.  Metrics are summed on the device; they are read
        only every ``disp_interval`` steps, for ``log_fn`` (running means
        with the epoch, step, learning rate and seconds per batch), and at
        the end, as means over the epoch's steps.

        With ``profile_dir`` the trainer's first epoch opens a profile at
        step ``step + 2`` for 3 steps (trainer.py:342-346 of the JAX
        package), each step synchronized so that the trace holds it
        whole."""
        device = self.device
        lr = self.lr_at_epoch(epoch)
        prof = self._profiler()
        total, n = None, 0
        t0 = time.time()
        for batch in loader:
            batch = {k: v for k, v in batch.items()
                     if k not in ("seg_id", "n_valid")}
            batch = batch_to_device(self.cfg, batch, device)
            if prof is not None:
                prof.maybe_start(self.step)
            m = self.train_step(batch, lr)
            if prof is not None and prof.active and device.type == "cuda":
                torch.cuda.synchronize(device)
            if prof is not None:
                prof.maybe_stop(self.step)
            total = m if total is None else {k: total[k] + m[k]
                                             for k in total}
            n += 1
            if log_fn and n % max(self.cfg.disp_interval, 1) == 0:
                log_fn({"epoch": epoch, "step": self.step, "lr": lr,
                        **{k: float(v) / n for k, v in total.items()},
                        "time_per_batch": (time.time() - t0) / n})
        return {k: float(v) / n for k, v in (total or {}).items()}

    def _profiler(self):
        """The trainer's ``ProfilerHooks`` under ``profile_dir`` (on the
        writer rank), made at its first epoch."""
        if self.profiler is None and self.cfg.profile_dir and (
                self.mesh is None or self.mesh.writer):
            from grounded_video_description_torch.utils.logging import (
                ProfilerHooks)
            self.profiler = ProfilerHooks(
                self.cfg.profile_dir, start_step=self.step + 2,
                num_steps=3, device=self.device)
        return self.profiler
