"""Training driver of the port:

    python -m grounded_video_description_torch.main [--device cuda] FLAGS

The counterpart of the repository's ``main.py`` (reference driver:
main.py:520-743), which stays the JAX package's: the config from flags
and a ``--path_opt`` YAML (``GVDConfig.from_cli``), the datasets and
loaders, the model on the card, optional resume (crash recovery from the
latest checkpoint in ``--checkpoint_path``, or ``--start_from`` a run's
directory, best or latest by ``--load_best_score``), then the epoch loop:
``Trainer.fit_epoch``, and every ``val_every_epoch`` epochs
``Evaluator.evaluate`` and, under ``eval_obj_grounding_gt``,
``eval_grounding_gt`` (the TopDown family only: it grounds through the
TopDown core's attention), with a checkpoint after each validation and
``model-best`` where CIDEr rose.  ``--att_model transformer`` trains and
decodes the Masked-Transformer captioner; ``--quantize_banks`` decodes
over int8 attention banks.  The evaluation JSONs are written under
the working directory, as the JAX driver writes them.

``--device`` (default ``cuda``) is read before the config's flags.  With
no visible card the driver raises; it never moves to the CPU by itself.
The tests pass ``--device cpu``, where every kernel flag takes its plain
version.

When ``data_path/detectron_weights`` exists and ``transfer_mode`` is not
"none", the model starts from the Visual-Genome weight transfer
(``data/transfer.py``), as the JAX driver's does.

The device mesh (the JAX driver's ``build_driver_mesh``, main.py:86-149),
one process per device in a ``torch.distributed`` group (``parallel/``):
``--mesh_shape D`` (or ``D 1``) spawns D workers on ``cuda:0 .. D-1``
(NCCL), or with ``--device cpu`` D CPU workers (gloo); with no flag and
more than one visible card, D is the most cards that divide the
microbatch.  ``--mesh_shape D M`` adds a model axis: D x M workers, rank
d x M + m, the M ranks of one d splitting the vocab head
(``parallel/tensor.py``); the vocab is padded to a multiple of M
(``vocab_pad_to``, as the JAX driver pads it), so a run resumed from its
checkpoint on another mesh passes the same ``--vocab_pad_to``.
Multi-host: ``--coordinator_address host:port --num_processes N
--process_id i`` on every host joins one group of N x D x M ranks, rank i
x D x M + the local rank.  Rank 0 writes the checkpoints, the evaluation
JSONs and the logs.  With ``--profile_dir`` rank 0 traces three train
steps (``utils.logging.ProfilerHooks``).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from grounded_video_description_torch.config import GVDConfig


def resolve_device(name: str) -> torch.device:
    """The device ``--device`` names; a CUDA device must be visible."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is visible (pass --device cpu "
            "to run on the CPU)")
    return device


def build_model_and_vocab(cfg: GVDConfig, device: torch.device):
    """The datasets of ``train_split`` and ``val_split``, the config with
    the vocabulary's sizes, and the model initialised from ``cfg.seed``,
    with the Visual-Genome weight transfer where the data directory holds
    the detector's weights, on ``device`` (main.py:44-83)."""
    from grounded_video_description_torch.data.dataset import AnetDataset
    from grounded_video_description_torch.data.transfer import (
        apply_weight_transfer, load_detectron_weights)
    from grounded_video_description_torch.data.vocab import (
        GloVe, build_class_glove, build_vg_cls_glove, load_vg_classes)
    from grounded_video_description_torch.models import GVDModel

    dataset = AnetDataset(cfg, split=cfg.train_split)
    dataset_val = AnetDataset(cfg, split=cfg.val_split)
    vocab = dataset.vocab
    unk = int(vocab.wtoi.get("UNK", vocab.vocab_size - 1))
    cfg = cfg.replace(vocab_size=vocab.vocab_size,
                      detect_size=vocab.detect_size, unk_idx=unk)
    model = GVDModel(cfg).init(torch.Generator().manual_seed(cfg.seed))

    # Visual-Genome knowledge transfer (model.py:172-217), on the host
    detectron_dir = os.path.join(cfg.data_path, "detectron_weights")
    if os.path.isdir(detectron_dir) and cfg.transfer_mode != "none":
        glove = GloVe(cfg.glove_file or None, dim=cfg.glove_dim)
        vg_classes = load_vg_classes(
            os.path.join(cfg.data_path, "vg_object_vocab.txt"))
        glove_vg = build_vg_cls_glove(vg_classes, glove)
        glove_cls = build_class_glove(vocab.itod, glove)
        det = load_detectron_weights(detectron_dir)
        if det:
            apply_weight_transfer(
                model, transfer_mode=cfg.transfer_mode, detectron=det,
                glove_vg_cls=glove_vg, glove_clss=glove_cls, verbose=True)
            print("applied detectron weight transfer "
                  f"({cfg.transfer_mode})")
    return cfg, model.to(device), dataset, dataset_val, vocab


def sharing_model(model, cfg: GVDConfig):
    """``model`` itself if ``cfg`` is its config, else a shallow copy that
    shares its parameters and buffers and runs with ``cfg`` (the
    evaluator's config differs from training's only in kernel flags)."""
    if cfg is model.cfg:
        return model
    view = copy.copy(model)
    view.cfg = cfg
    return view


def data_axis(cfg: GVDConfig, device: torch.device) -> int:
    """The data indices on this host: ``mesh_shape``'s data axis, else
    (on the card) the most visible cards that divide the microbatch, as
    the JAX driver's auto-DP picks them (main.py:111-124)."""
    if cfg.mesh_shape is not None:
        local = cfg.mesh_shape[0]
    elif device.type == "cuda":
        micro = cfg.batch_size // cfg.grad_accum
        local = max(k for k in range(1, torch.cuda.device_count() + 1)
                    if micro % k == 0)
    else:
        local = 1
    world = cfg.num_processes * local
    if (cfg.batch_size // cfg.grad_accum) % world:
        raise ValueError(f"microbatch {cfg.batch_size}//{cfg.grad_accum} "
                         f"must be divisible by the {world} ranks")
    return local


def model_axis(cfg: GVDConfig) -> int:
    """M, the model axis of ``mesh_shape`` (1 without one)."""
    shape = cfg.mesh_shape or [1]
    return shape[1] if len(shape) > 1 else 1


def padded_for_mesh(cfg: GVDConfig) -> GVDConfig:
    """``cfg`` with ``vocab_pad_to`` the model axis's size where it does
    not divide by it, so the vocab head splits (main.py:145-147)."""
    M = model_axis(cfg)
    if M > 1 and cfg.vocab_pad_to % M:
        return cfg.replace(vocab_pad_to=M)
    return cfg


def run(cfg: GVDConfig, trainer, evaluator, loader, loader_val, ckpt,
        logger, infos: Dict, *, out_dir: str = ".") -> List[Dict]:
    """The epoch loop (main.py:223-265) from ``infos["epoch"]`` to
    ``max_epochs``.  Returns one record per epoch: the seconds its
    training, validation and checkpoint took, its stats and whether it
    saved ``model-best``."""
    best_val = infos.get("best_val_score")
    start_epoch = infos.get("epoch", 0)
    # loss, learning-rate and validation histories saved with the
    # checkpoint (reference histories_*.pkl, main.py:718-732)
    histories = infos.get("histories", {"loss": {}, "lr": {}, "val": {}})
    records = []
    for epoch in range(start_epoch, cfg.max_epochs):
        rec = {"epoch": epoch}
        if not cfg.inference_only:
            t0 = time.perf_counter()
            train_metrics = trainer.fit_epoch(loader, epoch,
                                              log_fn=logger.log)
            rec["train_s"] = time.perf_counter() - t0
            print(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.4f}" for k, v in train_metrics.items()))
            logger.log({"epoch": epoch, **train_metrics})
            histories["loss"][str(epoch)] = train_metrics.get("loss")
            histories["lr"][str(epoch)] = trainer.lr_at_epoch(epoch)

        if epoch % cfg.val_every_epoch == 0 or cfg.inference_only:
            t0 = time.perf_counter()
            stats = evaluator.evaluate(loader_val, epoch=epoch,
                                       out_dir=out_dir)
            if cfg.att_model == "topdown" and cfg.eval_obj_grounding_gt:
                stats.update(evaluator.eval_grounding_gt(loader_val,
                                                         out_dir=out_dir))
            rec["val_s"] = time.perf_counter() - t0
            rec["stats"] = stats
            logger.log({"epoch": epoch, "split": cfg.val_split, **stats})

            if cfg.inference_only:
                print(json.dumps(stats))
                records.append(rec)
                break

            current = stats.get("CIDEr", 0.0)
            best_flag = best_val is None or current > best_val
            if best_flag:
                best_val = current
            histories["val"][str(epoch)] = stats
            t0 = time.perf_counter()
            ckpt.save(trainer, {"epoch": epoch + 1,
                                "best_val_score": best_val,
                                "vocab_size": cfg.vocab_size,
                                "histories": histories},
                      best=best_flag)
            rec["save_s"] = time.perf_counter() - t0
            rec["best"] = best_flag
            print(f"checkpoint saved (best={best_flag}, "
                  f"CIDEr={current:.4f})")
        records.append(rec)
    return records


def parse_args(argv: Optional[List[str]] = None):
    """``--device``, then the config's own flags."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    return resolve_device(args.device), GVDConfig.from_cli(rest)


def main(argv: Optional[List[str]] = None) -> int:
    """The driver: one process, or D x M workers per host
    (``data_axis`` x ``model_axis``)."""
    import tempfile

    from grounded_video_description_torch.parallel import spawn

    device, cfg = parse_args(argv)
    cfg = padded_for_mesh(cfg)
    local = data_axis(cfg, device) * model_axis(cfg)
    if device.type == "cuda" and local > torch.cuda.device_count():
        raise ValueError(f"a mesh of {local} ranks a host needs {local} "
                         f"cards, {torch.cuda.device_count()} visible")
    if local * cfg.num_processes == 1 and not cfg.coordinator_address:
        return train(cfg, device)
    with tempfile.TemporaryDirectory() as rdzv:
        init = (f"tcp://{cfg.coordinator_address}" if cfg.coordinator_address
                else f"file://{rdzv}/rdzv")
        spawn(_worker, local, (cfg, device.type, init, local))
    return 0


def _worker(local_rank: int, cfg: GVDConfig, device_type: str,
            init_method: str, local: int) -> None:
    """Rank ``process_id`` x ``local`` + ``local_rank`` of the (N x D, M)
    mesh: join the group on this host's device ``local_rank`` and train.
    Ranks other than 0 print nothing."""
    from grounded_video_description_torch.parallel import (
        close_mesh, init_mesh)

    device = (torch.device("cuda", local_rank) if device_type == "cuda"
              else torch.device("cpu"))
    if device.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // local))
    rank = cfg.process_id * local + local_rank
    if rank:
        sys.stdout = open(os.devnull, "w")
    M = model_axis(cfg)
    mesh = init_mesh(device, shape=(cfg.num_processes * local // M, M),
                     rank=rank, init_method=init_method)
    try:
        train(cfg, device, mesh)
    finally:
        close_mesh(mesh)


def train(cfg: GVDConfig, device: torch.device, mesh=None) -> int:
    """Build the datasets, the model and its trainer, evaluator and
    checkpoints on ``device`` (as one rank of ``mesh`` if given), resume
    if a checkpoint says so, and run the epoch loop."""
    from grounded_video_description_torch.data.dataset import Loader
    from grounded_video_description_torch.engine.checkpoint import (
        CheckpointManager)
    from grounded_video_description_torch.engine.evaluator import (
        Evaluator, grounding_eval_cfg)
    from grounded_video_description_torch.engine.trainer import Trainer
    from grounded_video_description_torch.parallel.mesh import barrier
    from grounded_video_description_torch.utils.logging import MetricLogger

    np.random.seed(cfg.seed)
    writer = mesh is None or mesh.writer
    cfg, model, dataset, dataset_val, vocab = build_model_and_vocab(
        cfg, device)
    if cfg.packed_cache_dir:
        from grounded_video_description_torch.data.packed_cache import (
            open_or_build)
        # rank 0 builds the caches, then the others open them
        for rank0_turn in (True, False):
            if writer == rank0_turn:
                dataset = open_or_build(dataset, os.path.join(
                    cfg.packed_cache_dir, cfg.train_split))
                dataset_val = open_or_build(dataset_val, os.path.join(
                    cfg.packed_cache_dir, cfg.val_split))
            barrier(mesh)
    shard = ({} if mesh is None else
             dict(rank=mesh.data_rank, world=mesh.data, accum=cfg.grad_accum))
    loader = Loader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
                    **shard)
    loader_val = Loader(dataset_val, cfg.batch_size, shuffle=False,
                        drop_last=False, pad_last=True)

    trainer = Trainer(cfg, model, mesh=mesh)
    ckpt = CheckpointManager(cfg.checkpoint_path, mesh)
    logger = (MetricLogger(cfg.log_jsonl, tensorboard_dir=cfg.tensorboard_dir)
              if writer else MetricLogger())

    infos = {"epoch": 0, "best_val_score": None}
    resume_dir = cfg.start_from
    if not resume_dir and os.path.isdir(
            os.path.join(cfg.checkpoint_path, "model")):
        # crash recovery: pick up the run in progress
        resume_dir = cfg.checkpoint_path
    if resume_dir:
        # crash recovery continues from the latest state; an explicit
        # --start_from honours --load_best_score (main.py:622-628)
        load_best = (cfg.load_best_score == 1) if cfg.start_from else False
        infos = CheckpointManager(resume_dir, mesh).restore(
            trainer, load_best=load_best)
        print(f"resumed from {resume_dir} at epoch {infos.get('epoch', 0)}")

    eval_cfg = grounding_eval_cfg(cfg)
    if eval_cfg is not cfg:
        print("grounding eval active: encoder kernel gated off for metric "
              "fidelity (pallas_encoder_grounding_guard)")
    evaluator = Evaluator(eval_cfg, sharing_model(model, eval_cfg), vocab,
                          mesh)
    run(cfg, trainer, evaluator, loader, loader_val, ckpt, logger, infos)
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
