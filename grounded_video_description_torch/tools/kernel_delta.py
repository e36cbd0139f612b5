"""The bf16 bars of each inference kernel at trained weights.

    python -m grounded_video_description_torch.tools.kernel_delta
        --ckpt DIR --out FILE [--device cuda]

At the weights of ``tools/overfit.py``'s checkpoint (the latest in
``--ckpt``), over three batches of 100 (the first 100 segments of each of
the overfit pool's two batches and one batch the model never saw, named
in the output), this compares every variant below with the bf16 plain
path, the baseline of the bf16 kernel promotion policy (docs/DESIGN.md
§bf16 kernel promotion policy):

  * bf16 with one inference kernel alone: K1 (the obj_interact layer),
    K2 (the BiGRU), K3 (the region attention of the greedy step loop, K6
    off), K6 (the whole greedy decode), K7 (the obj_interact attention
    with K1 off, as the grounding guard runs it);
  * bf16 with the config's kernel defaults (K1 and K2), and with the
    evaluator's flags under the grounding guard (K2, K3, K6, K7);
  * beam 3 with the defaults, against beam 3 on the bf16 plain path.

Each variant is also held against the f32 plain path (beam 3 against f32
beam 3), which says whether it sits nearer f32 than bf16 plain does.

Per batch and variant: greedy (or beam) token agreement, exact-sentence
agreement, the region-attention argmax agreement (each step's argmax ROI),
and ``box_accu_att``, ``box_accu_grd`` and ``cls_accu`` of
``Evaluator.eval_grounding_gt`` on reference files made from the batch
(``tools/eval_files.py``, as chip_smoke.py's eval phase makes them).  Two
floors take the same measures: bf16 plain against f32 plain (what bf16
itself costs; also at beam 3), and f32 with the defaults against f32
plain.  One JSON file goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Tuple

import numpy as np
import torch

from grounded_video_description_torch.config import GVDConfig
from grounded_video_description_torch.data.synthetic import synthetic_batch
from grounded_video_description_torch.engine.checkpoint import STATE_FILE
from grounded_video_description_torch.engine.evaluator import Evaluator
from grounded_video_description_torch.models import (
    GVDModel, batch_to_tensors)
from grounded_video_description_torch.tools.eval_files import (
    eval_references, eval_vocab)
from grounded_video_description_torch.tools.overfit import (
    check_checkpoint, flagship_train_config, pool_batches)

EVAL_BATCH = 100
FRESH_SEED = 1000
OFF = dict(use_pallas=False, use_pallas_rnn=False, use_pallas_encoder=False,
           use_pallas_decode=False, use_pallas_mha=False)
DEFAULTS = {k: getattr(GVDConfig, k) for k in OFF}
# name: (dtype, kernel flags, beam size)
RUNS = {
    "f32_plain": ("float32", OFF, 1),
    "f32_plain_beam3": ("float32", OFF, 3),
    "f32_defaults": ("float32", DEFAULTS, 1),
    "bf16_plain": ("bfloat16", OFF, 1),
    "bf16_plain_beam3": ("bfloat16", OFF, 3),
    "bf16_K1": ("bfloat16", {**OFF, "use_pallas_encoder": True}, 1),
    "bf16_K2": ("bfloat16", {**OFF, "use_pallas_rnn": True}, 1),
    "bf16_K3": ("bfloat16", {**OFF, "use_pallas": True}, 1),
    "bf16_K6": ("bfloat16", {**OFF, "use_pallas_decode": True}, 1),
    "bf16_K7": ("bfloat16", {**OFF, "use_pallas_mha": True}, 1),
    "bf16_defaults": ("bfloat16", DEFAULTS, 1),
    "bf16_eval_flags": ("bfloat16", {**OFF, "use_pallas": True,
                                     "use_pallas_rnn": True,
                                     "use_pallas_decode": True,
                                     "use_pallas_mha": True}, 1),
    "bf16_defaults_beam3": ("bfloat16", DEFAULTS, 3),
}
# each variant against its bf16 plain run (the policy's baseline), and
# against its f32 plain run (which of the two bf16 paths is nearer f32)
VARIANTS = {name: ("bf16_plain_beam3" if name.endswith("beam3")
                   else "bf16_plain")
            for name in RUNS if name.startswith("bf16_")
            and not name.startswith("bf16_plain")}
FLOORS = {"bf16_plain_vs_f32_plain": ("bf16_plain", "f32_plain"),
          "bf16_plain_beam3_vs_f32_plain_beam3": ("bf16_plain_beam3",
                                                  "f32_plain_beam3"),
          "f32_defaults_vs_f32_plain": ("f32_defaults", "f32_plain")}
BOX_KEYS = ("box_accu_att", "box_accu_grd", "cls_accu")


def eval_batches(cfg: GVDConfig, pool: int) -> List[Tuple[str, Dict]]:
    """(name, batch of EVAL_BATCH): the first segments of each batch of
    the overfit pool, and a fresh batch; each with unique segment ids."""
    n = min(EVAL_BATCH, cfg.batch_size)
    out = []
    for s, full in enumerate(pool_batches(cfg, pool)):
        out.append((f"pool seed {s}, segments 0-{n - 1}",
                    {k: v[:n] for k, v in full.items()}))
    out.append((f"fresh seed {FRESH_SEED}",
                synthetic_batch(cfg, n, seed=FRESH_SEED)))
    for i, (_, batch) in enumerate(out):
        batch["seg_id"] = [f"v_KD{i}{b:04d}_segment_{b % 3:02d}"
                           for b in range(n)]
        batch["n_valid"] = n
    return out


def decode(model: GVDModel, batch: Dict, beam: int) -> Dict[str, np.ndarray]:
    """Tokens and each step's argmax ROI of a greedy or beam decode."""
    tensors = batch_to_tensors({k: v for k, v in batch.items()
                                if k not in ("seg_id", "n_valid")},
                               next(model.parameters()).device)
    if beam > 1:
        seq, _, att2_ind, _ = model.sample_beam(tensors, beam_size=beam)
    else:
        seq, _, att2, _ = model.sample_greedy(tensors)
        att2_ind = att2.float().argmax(dim=-1)
    return {"seq": seq.cpu().numpy(), "att2_ind": att2_ind.cpu().numpy()}


def agreement(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
              ) -> Dict[str, float]:
    same = got["seq"] == ref["seq"]
    return {"token": float(same.mean()),
            "exact_sentence": float(same.all(axis=1).mean()),
            "attn_argmax": float((got["att2_ind"] == ref["att2_ind"]).mean())}


def measure(train_cfg: GVDConfig, state: Dict[str, torch.Tensor], *,
            pool: int, device, work_dir: str) -> Dict:
    """Every variant on every batch at the weights ``state`` of a model of
    ``train_cfg``'s widths.  Returns the report (without the device)."""
    cfg0 = train_cfg.replace(seq_per_img=1, **OFF)
    vocab = eval_vocab(cfg0)
    batches = eval_batches(train_cfg, pool)
    refs = []
    for i, (_, batch) in enumerate(batches):
        root = os.path.join(work_dir, f"batch{i}")
        os.makedirs(root)
        refs.append(eval_references(root, cfg0, vocab, [batch]))
    runs: Dict[str, List[Dict]] = {}
    for name, (dtype, flags, beam) in RUNS.items():
        cfg = cfg0.replace(dtype=dtype, id=name, **flags)
        model = GVDModel(cfg)
        model.load_state_dict(state)
        model = model.to(device).eval()
        runs[name] = []
        for i, (_, batch) in enumerate(batches):
            out = decode(model, batch, beam)
            ev = Evaluator(cfg.replace(**refs[i]), model, vocab)
            stats = ev.eval_grounding_gt(
                [batch], out_dir=os.path.join(work_dir, f"{name}-{i}"))
            out.update({k: float(stats[k]) for k in BOX_KEYS})
            runs[name].append(out)
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def held(name: str, ref: str) -> Dict:
        per_batch = []
        for got, want in zip(runs[name], runs[ref]):
            row = agreement(got, want)
            for k in BOX_KEYS:
                row[k] = got[k]
                row[f"{k}_delta"] = got[k] - want[k]
            per_batch.append(row)
        tokens = [r["token"] for r in per_batch]
        return {"against": ref, "per_batch": per_batch,
                "token_mean": float(np.mean(tokens)),
                "token_min": float(np.min(tokens)),
                "exact_sentence_mean": float(np.mean(
                    [r["exact_sentence"] for r in per_batch])),
                "attn_argmax_mean": float(np.mean(
                    [r["attn_argmax"] for r in per_batch])),
                **{f"{k}_delta_mean": float(np.mean(
                    [r[f"{k}_delta"] for r in per_batch]))
                   for k in BOX_KEYS}}

    plain = ("f32_plain", "f32_plain_beam3", "bf16_plain",
             "bf16_plain_beam3")
    return {"batches": [name for name, _ in batches],
            "batch_size": len(batches[0][1]["seg_id"]),
            "plain": {name: [{k: r[k] for k in BOX_KEYS} for r in runs[name]]
                      for name in plain},
            "variants": {name: held(name, ref)
                         for name, ref in VARIANTS.items()},
            "variants_vs_f32": {name: held(name, ref.replace("bf16", "f32"))
                                for name, ref in VARIANTS.items()},
            "floors": {name: held(a, b) for name, (a, b) in FLOORS.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="tools/overfit.py's checkpoint directory")
    ap.add_argument("--out", required=True, help="the JSON file to write")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("kernel_delta: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(args.ckpt, "infos.json")) as f:
        infos = json.load(f)
    cfg = flagship_train_config()
    check_checkpoint(infos, cfg, infos.get("pool"), args.ckpt)
    blob = torch.load(os.path.join(args.ckpt, "model", STATE_FILE),
                      map_location="cpu", weights_only=True)
    with tempfile.TemporaryDirectory() as work:
        report = measure(cfg, blob["model"],
                         pool=infos["pool"], device=device, work_dir=work)
    losses = infos["lm_loss"]
    report["checkpoint"] = {
        "steps": infos["step"], "pool": infos["pool"],
        "lm_loss_first": losses[min(losses, key=int)],
        "lm_loss_last": losses[max(losses, key=int)],
        "config": infos["config"]}
    if device.type == "cuda":
        report["device"] = {
            "name": torch.cuda.get_device_name(0),
            "nvidia_smi": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]}
    else:
        report["device"] = {"name": "cpu"}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    for name, r in [*report["variants"].items(),
                    *report["variants_vs_f32"].items(),
                    *report["floors"].items()]:
        print(f"{name} vs {r['against']}: token mean {r['token_mean']:.4f}"
              f" min {r['token_min']:.4f}, exact "
              f"{r['exact_sentence_mean']:.4f}, attn argmax "
              f"{r['attn_argmax_mean']:.4f}, box_accu_att delta "
              f"{r['box_accu_att_delta_mean']:+.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
