"""Overfit a flagship-width checkpoint of the port on synthetic data.

    python -m grounded_video_description_torch.tools.overfit \
        --out save/gvd_overfit [--steps 300] [--pool 2] [--device cuda]

The bf16 bars (token agreement >= 0.99, box_accu_att within noise) apply
at trained weights; random weights give flat logits whose argmaxes any
reordering moves.  This runs the port's ``Trainer`` at the README's
flagship training configuration (vocab 4905, 431 detector classes,
obj_interact, bf16 through K5, batch 240 in 8 microbatches, Adam at 5e-4,
clip 0.1, drop_prob_lm 0.5, the loss weights w_att2 0.05 and w_cls 0.1,
no learning-rate decay) over a small pool of ``data/synthetic.py``
batches, cycled, until the LM loss collapses: sharp, non-random logit
and attention margins, with no download.  It prints the losses every 10
steps and saves through ``CheckpointManager`` into ``--out`` every 50
steps and at the end, with the LM loss history and every field of the
config in ``infos.json``; run again on the same ``--out``, it resumes
from the latest checkpoint and goes on to ``--steps``, and it refuses a
checkpoint made under another config or pool.  ``tools/kernel_delta.py``
reads the checkpoint.  Give each checkout its own ``--out`` (``save/`` is
gitignored), so that two trees compared never share one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from grounded_video_description_torch.config import GVDConfig
from grounded_video_description_torch.data.synthetic import synthetic_batch
from grounded_video_description_torch.engine.checkpoint import (
    CheckpointManager)
from grounded_video_description_torch.engine.trainer import (
    Trainer, batch_to_device)
from grounded_video_description_torch.models import GVDModel

LOG_EVERY = 10
SAVE_EVERY = 50


def flagship_train_config(**overrides) -> GVDConfig:
    """The README's training flags at flagship width, in bf16 through K5,
    with no learning-rate decay (the pool is cycled, not epochs)."""
    return GVDConfig(
        vocab_size=4905, detect_size=431, seq_per_img=1, obj_interact=True,
        dtype="bfloat16", batch_size=240, grad_accum=8, w_att2=0.05,
        w_cls=0.1, learning_rate=5e-4, grad_clip=0.1, drop_prob_lm=0.5,
        learning_rate_decay_start=-1,
        use_pallas_encoder_train=True).replace(**overrides).validate()


def pool_batches(cfg: GVDConfig, pool: int) -> List[Dict[str, np.ndarray]]:
    """The cycled pool: ``synthetic_batch`` of ``cfg.batch_size`` with
    seeds 0 .. pool - 1."""
    return [synthetic_batch(cfg, cfg.batch_size, seed=s) for s in range(pool)]


def config_record(cfg: GVDConfig) -> Dict:
    """Every field of ``cfg`` as ``infos.json`` holds it."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def check_checkpoint(infos: Dict, cfg: GVDConfig, pool: int,
                     where: str) -> None:
    """Raises unless the checkpoint of ``infos`` was trained under ``cfg``
    on a pool of ``pool`` batches."""
    if infos.get("pool") != pool:
        raise ValueError(f"{where} was trained on a pool of "
                         f"{infos.get('pool')}, not {pool}")
    want, have = config_record(cfg), infos.get("config") or {}
    diff = sorted(k for k in want.keys() | have.keys()
                  if want.get(k) != have.get(k))
    if diff:
        raise ValueError(f"{where} was trained under another config "
                         f"(fields {', '.join(diff)})")


def overfit(cfg: GVDConfig, out_dir: str, *, steps: int, pool: int,
            device, log: Callable[[str], None] = print) -> Dict:
    """Train ``cfg``'s model from ``cfg.seed`` (or from the latest
    checkpoint in ``out_dir``) up to ``steps`` updates over the cycled
    pool, saving into ``out_dir``.  Returns the checkpoint's infos (with
    the step reached)."""
    model = GVDModel(cfg).init(torch.Generator().manual_seed(cfg.seed))
    trainer = Trainer(cfg, model.to(device))
    ckpt = CheckpointManager(out_dir)
    infos: Dict = {"lm_loss": {}, "pool": pool,
                   "config": config_record(cfg)}
    infos_path = os.path.join(out_dir, "infos.json")
    if os.path.isfile(infos_path):
        with open(infos_path) as f:
            check_checkpoint(json.load(f), cfg, pool, out_dir)
        infos = ckpt.restore(trainer, load_best=False)
        log(json.dumps({"resumed_at": trainer.step}))
    batches = [batch_to_device(cfg, {k: v for k, v in b.items()
                                     if k != "seg_id"}, device)
               for b in pool_batches(cfg, pool)]
    t0 = time.perf_counter()
    while trainer.step < steps:
        step = trainer.step
        metrics = trainer.train_step(batches[step % pool],
                                     cfg.learning_rate)
        done = trainer.step
        if step % LOG_EVERY == 0 or done == steps:
            m = {k: round(float(v), 4) for k, v in metrics.items()}
            infos["lm_loss"][str(step)] = m["lm_loss"]
            log(json.dumps({"step": step, **m, "elapsed_s": round(
                time.perf_counter() - t0, 1)}))
        if done % SAVE_EVERY == 0 or done == steps:
            ckpt.save(trainer, infos)
    return {**infos, "step": trainer.step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="the checkpoint directory (resumed if it holds one),"
                    " e.g. save/gvd_overfit in the checkout")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--pool", type=int, default=2,
                    help="distinct synthetic batches, cycled")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("overfit: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    infos = overfit(flagship_train_config(), args.out, steps=args.steps,
                    pool=args.pool, device=device,
                    log=lambda line: print(line, flush=True))
    losses = infos["lm_loss"]
    first, last = min(losses, key=int), max(losses, key=int)
    print(json.dumps({"saved": os.path.abspath(args.out),
                      "steps": infos["step"],
                      "lm_loss_first": losses[first],
                      "lm_loss_last": losses[last]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
