"""A sustained-training rehearsal of the port through its driver, over a
synthetic dataset on disk.

    python -m grounded_video_description_torch.tools.rehearsal \
        --out REPORT.json [--root DIR] [--n_train_videos 1200]
        [--n_val_videos 120] [--epochs_phase1 2] [--epochs_total 6]
        [--device cuda] [--smoke] [--keep] [--reuse_data]

The port's copy of the repository's ``tools/rehearsal.py``: it writes a
dataset with ``data/synthetic_files.py`` (flagship widths: rnn 1024, 1000
proposals, 480 frames, a vocabulary of about 4.9k words through
``n_extra_words``; detect_size is the synthetic 12), then runs
``python -m grounded_video_description_torch.main`` in two phases on one
``--checkpoint_path``: a fresh run of ``--epochs_phase1`` epochs (the
packed cache built, every epoch validated with the densecap, attn-gen,
attn-gt and grd-gt JSONs written, a checkpoint after each validation),
then a second run to ``--epochs_total`` that resumes from the latest
checkpoint (crash recovery) and goes on.  It fails on a NaN training
loss in ``log.jsonl`` (after phase 1 already) and writes a report of the
per-epoch segments/s, the validation stats, the resume line and the
evaluation files found to ``--out``, a new file.

The flagship run trains in bf16 through K5 (batch 240 in 8
microbatches) on ``--device`` (default ``cuda``).  ``--smoke`` runs the
tiny widths on the CPU (4 + 2 videos, batch 2), which is what the tests
run.  The dataset's proposals are HDF5, so the tool needs ``h5py``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EVAL_FILES = (
    os.path.join("densecap_results", "densecap-validation-rehearsal.json"),
    os.path.join("results", "attn-gen-sent-results-validation-"
                 "rehearsal.json"),
    os.path.join("results", "attn-gt-sent-results-validation-"
                 "rehearsal.json"),
    os.path.join("results", "grd-gt-sent-results-validation-"
                 "rehearsal.json"))
LOSS_KEYS = ("loss", "lm_loss", "att2_loss", "ground_loss", "cls_loss")
TINY_DIMS = ("rnn_size", "input_encoding_size", "att_hid_size",
             "fc_feat_size", "rgb_feat_size", "motion_feat_size",
             "att_feat_size", "t_attn_size", "num_sampled_frm",
             "num_prop_per_frm", "glove_dim", "loc_encoding_size",
             "seg_info_size", "seq_length")


def rehearsal_cfg(smoke: bool):
    from grounded_video_description_torch.config import (
        GVDConfig, tiny_test_config)
    return tiny_test_config() if smoke else GVDConfig().validate()


def generate_dataset(data_root: str, n_train_videos: int,
                     n_val_videos: int, smoke: bool = False) -> dict:
    from grounded_video_description_torch.data.synthetic_files import (
        write_synthetic_dataset)

    t0 = time.time()
    paths = write_synthetic_dataset(
        data_root, rehearsal_cfg(smoke), n_train=n_train_videos,
        n_val=n_val_videos, seed=7, n_extra_words=0 if smoke else 4860)
    print(f"[rehearsal] dataset written in {time.time() - t0:.0f}s "
          f"({n_train_videos}+{n_val_videos} videos x 2 segments)",
          flush=True)
    return paths


def driver_argv(paths: dict, work: str, max_epochs: int, *,
                device: str = "cuda", smoke: bool = False,
                batch: int = 240) -> list:
    argv = [sys.executable, "-m", "grounded_video_description_torch.main",
            "--device", device]
    for k, v in paths.items():
        if k == "densecap_references":
            argv += ["--densecap_references"] + list(v)
        else:
            argv += [f"--{k}", str(v)]
    if smoke:
        cfg = rehearsal_cfg(True)
        for f in TINY_DIMS:
            argv += [f"--{f}", str(getattr(cfg, f))]
        argv += ["--batch_size", str(batch), "--grad_accum", "1"]
    else:
        argv += ["--batch_size", str(batch), "--grad_accum", "8",
                 "--dtype", "bfloat16", "--obj_interact",
                 "--use_pallas_encoder_train"]
    argv += [
        "--w_att2", "0.05", "--w_cls", "0.1",
        "--max_epochs", str(max_epochs), "--val_every_epoch", "1",
        "--language_eval", "--eval_obj_grounding",
        "--eval_obj_grounding_gt",
        "--disp_interval", "2", "--seed", "7", "--id", "rehearsal",
        "--packed_cache_dir", os.path.join(work, "packed"),
        "--checkpoint_path", os.path.join(work, "save"),
        "--log_jsonl", os.path.join(work, "log.jsonl"),
    ]
    return argv


def run_phase(argv: list, work: str, tag: str) -> float:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.time()
    res = subprocess.run(argv, cwd=work, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
    dt = time.time() - t0
    log_path = os.path.join(work, f"driver_{tag}.log")
    with open(log_path, "w") as f:
        f.write(res.stdout)
    print(f"[rehearsal] phase {tag}: exit {res.returncode} in {dt:.0f}s "
          f"(log: {log_path})", flush=True)
    if res.returncode != 0:
        print(res.stdout[-4000:])
        raise SystemExit(f"driver phase {tag} failed")
    return dt


def parse_log(work: str) -> dict:
    """Per-epoch time per batch (the last running mean of each epoch),
    the validation stats; a NaN training loss raises."""
    per_epoch_tpb: dict = {}
    val_stats: dict = {}
    with open(os.path.join(work, "log.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "time_per_batch" in rec:
                # a NaN loss anywhere poisons the epoch's running means
                bad = [k for k in LOSS_KEYS if k in rec and rec[k] != rec[k]]
                if bad:
                    raise SystemExit(
                        f"NaN training loss {bad} at epoch "
                        f"{rec['epoch']} step {rec.get('step')}: see "
                        f"{work}/log.jsonl")
                per_epoch_tpb[str(int(rec["epoch"]))] = rec["time_per_batch"]
            if rec.get("split") == "validation":
                val_stats[str(int(rec["epoch"]))] = {
                    k: rec[k] for k in
                    ("CIDEr", "Bleu_4", "METEOR", "grd_f1_all",
                     "grd_f1_loc", "box_accu_att", "box_accu_grd",
                     "cls_accu", "captions_per_sec") if k in rec}
    return {"time_per_batch": per_epoch_tpb, "val": val_stats}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="the report's file (a new one)")
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "gvd_rehearsal_torch"))
    ap.add_argument("--n_train_videos", type=int, default=1200)
    ap.add_argument("--n_val_videos", type=int, default=120)
    ap.add_argument("--epochs_phase1", type=int, default=2)
    ap.add_argument("--epochs_total", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keep", action="store_true",
                    help="keep the dataset and checkpoints afterwards")
    ap.add_argument("--reuse_data", action="store_true",
                    help="reuse an existing dataset under --root")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny widths on the CPU: the tool's plumbing")
    ap.add_argument("--batch", type=int, default=240)
    args = ap.parse_args(argv)
    if os.path.exists(args.out):
        raise SystemExit(f"{args.out} exists: the report goes to a new file")
    if args.smoke:
        args.n_train_videos = min(args.n_train_videos, 4)
        args.n_val_videos = min(args.n_val_videos, 2)
        args.batch = 2
        args.device = "cpu"

    data_root = os.path.join(args.root, "data")
    work = os.path.join(args.root, "work")
    paths_file = os.path.join(args.root, "paths.json")
    if args.reuse_data and os.path.isfile(paths_file):
        with open(paths_file) as f:
            paths = json.load(f)
    else:
        os.makedirs(args.root, exist_ok=True)
        paths = generate_dataset(data_root, args.n_train_videos,
                                 args.n_val_videos, smoke=args.smoke)
        with open(paths_file, "w") as f:
            json.dump(paths, f)
    os.makedirs(work, exist_ok=True)

    def phase(epochs, tag):
        return run_phase(driver_argv(paths, work, epochs, device=args.device,
                                     smoke=args.smoke, batch=args.batch),
                         work, tag)

    # phase 1: a fresh run (the packed cache built once)
    dt1 = phase(args.epochs_phase1, "phase1")
    parse_log(work)     # fail on a NaN before paying for phase 2
    # phase 2: the same checkpoint_path and more epochs: the crash
    # recovery resume, then more training and validation
    dt2 = phase(args.epochs_total, "phase2")

    parsed = parse_log(work)
    resumed_at = None
    with open(os.path.join(work, "driver_phase2.log")) as f:
        for line in f:
            if line.startswith("resumed from"):
                resumed_at = line.strip()
    seg_s = {e: args.batch / t
             for e, t in parsed["time_per_batch"].items()}
    rec = {
        "metric": "integrated_driver_train_seg_per_sec",
        "device": args.device,
        "per_epoch_seg_per_sec": seg_s,
        "steady_state_seg_per_sec": (
            max(list(seg_s.values())[1:], default=None)
            if len(seg_s) > 1 else None),
        "steps_per_epoch": args.n_train_videos * 2 // args.batch,
        "epochs": args.epochs_total,
        "batch_size": args.batch,
        "val_stats_per_epoch": parsed["val"],
        "resume_evidence": resumed_at,
        "phase1_wall_s": dt1,
        "phase2_wall_s": dt2,
        "artifacts_checked": sorted(
            p for p in EVAL_FILES if os.path.isfile(os.path.join(work, p))),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))

    if not args.keep:
        shutil.rmtree(args.root, ignore_errors=True)
    return rec


if __name__ == "__main__":
    main()
