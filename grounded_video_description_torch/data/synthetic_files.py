"""Write a complete synthetic ANet-Entities-format dataset to disk.

The port's copy of ``grounded_video_description_tpu/data/
synthetic_files.py``: the same numpy draws in the same order, so one
config, size and seed give the same files in both packages
(tests/test_torch_utils.py holds them equal byte for byte).  It writes
every artifact the driver reads (misc/dataloader_anet.py:49-100,
189-210, and the evaluation harness's JSONs): dic_anet.json,
cap_anet.json, the grounding reference, the split ids, the proposals'
HDF5 file, per-segment region features (.npy), per-video frame features
(_resnet.npy / _bn.npy) and a densecap reference for the validation
split.  ``h5py`` is imported only when the HDF5 file is written.

The driver's tests and ``tools/rehearsal.py`` make their data with it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from grounded_video_description_torch.config import GVDConfig

_WORDS = ("man woman dog cat ball car tree house door window chair table "
          "person boy girl street park room hand water plays runs walks "
          "holds throws sits stands looks eats opens the a is on with and "
          "then while near into over").split()


def write_synthetic_dataset(root: str, cfg: GVDConfig, *,
                            n_train: int = 4, n_val: int = 4,
                            seed: int = 0,
                            n_extra_words: int = 0) -> Dict[str, str]:
    """Returns a dict of config path overrides pointing at the files.

    ``n_extra_words`` appends synthetic non-detection filler words to
    the vocabulary, as ``tools/rehearsal.py`` does to reach the
    flagship's vocabulary of about 4.9k words (and the flagship's logit
    widths) without a real corpus; captions sample uniformly over the
    whole vocabulary."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    feature_root = os.path.join(root, "fc6_feat")
    seg_feature_root = os.path.join(root, "rgb_motion_1d")
    os.makedirs(feature_root, exist_ok=True)
    os.makedirs(seg_feature_root, exist_ok=True)

    det_words = _WORDS[:12]                      # detection classes
    vocab_words = (list(_WORDS)
                   + [f"zzw{i:04d}" for i in range(n_extra_words)]
                   + ["UNK"])
    itow = {str(i + 1): w for i, w in enumerate(vocab_words)}
    wtoi = {w: i + 1 for i, w in enumerate(vocab_words)}
    wtod = {w: i for i, w in enumerate(det_words)}  # dic convention:
    # dataloader does wtod = {w: i+1}, so store 0-based here
    wtol = {w: w for w in vocab_words}

    n_vids = n_train + n_val
    videos = []
    cap_file: Dict = {}
    grd_ann: Dict = {}
    split_ids = {"training": [], "validation": [], "testing": [],
                 "hidden_test": []}
    densecap_ref: Dict = {}

    R = cfg.max_proposal
    n_frm = cfg.num_sampled_frm
    dets_num = []
    dets_labels = []

    img_w, img_h = 720.0, 405.0
    T_feat = cfg.t_attn_size

    seg_counter = 0
    for v in range(n_vids):
        vid = f"v_SYN{v:04d}"
        split = "training" if v < n_train else "validation"
        split_ids[split].append(vid)
        duration = 30.0
        n_segs = 2
        cap_file[vid] = {"segments": {}}
        grd_ann[vid] = {"duration": duration, "segments": {}}
        if split == "validation":
            densecap_ref[vid] = {"duration": duration, "timestamps": [],
                                 "sentences": []}

        # frame features per video
        rgb = rng.randn(T_feat, cfg.rgb_feat_size).astype(np.float32)
        motion = rng.randn(T_feat, cfg.motion_feat_size).astype(np.float32)
        np.save(os.path.join(seg_feature_root, vid[2:] + "_resnet.npy"),
                rgb)
        np.save(os.path.join(seg_feature_root, vid[2:] + "_bn.npy"),
                motion)

        for s in range(n_segs):
            seg_id = f"{vid}_segment_{s:02d}"
            videos.append({"id": seg_id, "split": split})

            # proposals
            ppls = np.zeros((R, 7), np.float32)
            x1 = rng.uniform(0, img_w * 0.6, R)
            y1 = rng.uniform(0, img_h * 0.6, R)
            ppls[:, 0], ppls[:, 1] = x1, y1
            ppls[:, 2] = np.minimum(x1 + rng.uniform(40, 200, R), img_w - 1)
            ppls[:, 3] = np.minimum(y1 + rng.uniform(40, 150, R), img_h - 1)
            ppls[:, 4] = np.repeat(np.arange(n_frm), R // n_frm)
            ppls[:, 5] = rng.randint(1, 100, R)
            ppls[:, 6] = rng.uniform(0.3, 1.0, R)
            dets_num.append(R)
            dets_labels.append(ppls)

            feat = rng.randn(n_frm, R // n_frm,
                             cfg.att_feat_size).astype(np.float32)
            np.save(os.path.join(feature_root, seg_id + ".npy"), feat)

            # caption with 2 grounded detection words
            length = rng.randint(6, min(cfg.seq_length, 10) + 1)
            caption = [vocab_words[rng.randint(12, len(vocab_words) - 1)]
                       for _ in range(length)]
            n_obj = 2
            obj_pos = rng.permutation(length)[:n_obj]
            clss, idxs, bboxes, frm_idxs = [], [], [], []
            p_clss, p_frames, p_boxes, p_idx = [], [], [], []
            for pos in sorted(obj_pos.tolist()):
                w = det_words[rng.randint(0, len(det_words))]
                caption[pos] = w
                src = ppls[rng.randint(0, R)]
                box = (src[:4] + rng.uniform(-2, 2, 4)).tolist()
                clss.append([w])
                idxs.append([int(pos)])
                bboxes.append(box)
                frm_idxs.append(int(src[4]))
                p_clss.append(w)
                p_frames.append(int(src[4]))
                p_boxes.append(box)
                p_idx.append(int(pos))

            ts = [duration * s / n_segs, duration * (s + 1) / n_segs]
            cap_file[vid]["segments"][str(s)] = {
                "caption": caption, "clss": clss, "idx": idxs,
                "bbox": bboxes, "frm_idx": frm_idxs}
            grd_ann[vid]["segments"][str(s)] = {
                "timestamps": ts, "tokens": caption,
                "process_clss": p_clss, "frame_ind": p_frames,
                "process_bnd_box": p_boxes, "process_idx": p_idx}
            if split == "validation":
                densecap_ref[vid]["timestamps"].append(ts)
                densecap_ref[vid]["sentences"].append(" ".join(caption))
            seg_counter += 1

    dic_path = os.path.join(root, "dic_anet.json")
    with open(dic_path, "w") as f:
        json.dump({"ix_to_word": itow, "wtod": wtod, "wtol": wtol,
                   "videos": videos}, f)
    cap_path = os.path.join(root, "cap_anet.json")
    with open(cap_path, "w") as f:
        json.dump(cap_file, f)
    grd_path = os.path.join(root, "grd_ref.json")
    with open(grd_path, "w") as f:
        json.dump({"annotations": grd_ann}, f)
    split_path = os.path.join(root, "split_ids.json")
    with open(split_path, "w") as f:
        json.dump(split_ids, f)
    ref1 = os.path.join(root, "densecap_ref_1.json")
    with open(ref1, "w") as f:
        json.dump(densecap_ref, f)

    import h5py
    h5_path = os.path.join(root, "proposals.h5")
    with h5py.File(h5_path, "w") as h5:
        h5.create_dataset("dets_num", data=np.asarray(dets_num))
        h5.create_dataset("dets_labels", data=np.stack(dets_labels))

    return {
        "input_dic": dic_path,
        "input_json": cap_path,
        "grd_reference": grd_path,
        "split_file": split_path,
        "proposal_h5": h5_path,
        "feature_root": feature_root,
        "seg_feature_root": seg_feature_root,
        "densecap_references": [ref1],
    }
