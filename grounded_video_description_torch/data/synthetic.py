"""Synthetic batch fixtures.

The port's copy of ``grounded_video_description_tpu/data/synthetic.py``:
the same numpy draws in the same order, so one config and seed give the
same arrays in both packages (tests/test_torch_slice.py holds them
equal).  Batches have the tensor contract of the reference dataloader's
12-tuple (misc/dataloader_anet.py:351-354), with ground-truth boxes that
are jittered copies of proposals on the same frame and captions whose
visual words are aligned with those boxes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from grounded_video_description_torch.config import GVDConfig


def synthetic_batch(cfg: GVDConfig, batch_size: int, seed: int = 0,
                    img_w: float = 720.0, img_h: float = 405.0) -> Dict:
    rng = np.random.RandomState(seed)
    B = batch_size
    R = cfg.max_proposal
    K = cfg.max_gt_box
    Lq = cfg.seq_length
    S = cfg.seq_per_img
    T = cfg.t_attn_size

    seg_feat = rng.randn(B, T, cfg.fc_feat_size).astype(np.float32)

    # proposals: [x1, y1, x2, y2, frm_idx, vg_class, score]
    x1 = rng.uniform(0, img_w * 0.7, (B, R))
    y1 = rng.uniform(0, img_h * 0.7, (B, R))
    w = rng.uniform(30, img_w * 0.3, (B, R))
    h = rng.uniform(30, img_h * 0.3, (B, R))
    ppls = np.zeros((B, R, 7), np.float32)
    ppls[:, :, 0] = x1
    ppls[:, :, 1] = y1
    ppls[:, :, 2] = np.minimum(x1 + w, img_w - 1)
    ppls[:, :, 3] = np.minimum(y1 + h, img_h - 1)
    ppls[:, :, 4] = rng.randint(0, cfg.num_sampled_frm, (B, R))
    ppls[:, :, 5] = rng.randint(1, 1601, (B, R))
    ppls[:, :, 6] = rng.uniform(0.3, 1.0, (B, R))  # above prop_thresh

    ppls_feat = rng.randn(B, R, cfg.att_feat_size).astype(np.float32) * 0.5
    pnt_mask_r = np.zeros((B, R), bool)            # none masked

    # GT boxes: jittered copies of proposals, same frame -> IoU > 0.5
    n_box = rng.randint(1, K + 1, B)
    gt_boxes = np.zeros((B, K, 6), np.float32)
    src = rng.randint(0, R, (B, K))
    for b in range(B):
        for k in range(n_box[b]):
            pb = ppls[b, src[b, k]]
            jit = rng.uniform(-3, 3, 4)
            gt_boxes[b, k, :4] = pb[:4] + jit
            gt_boxes[b, k, 4] = pb[4]
            gt_boxes[b, k, 5] = rng.randint(1, cfg.detect_size + 1)

    # frame mask: True where proposal and gt are on different frames
    frm_mask = np.ones((B, R, K), bool)
    for b in range(B):
        frm_mask[b, :, :n_box[b]] = (
            ppls[b, :, 4:5] != gt_boxes[b, None, :n_box[b], 4].reshape(1, -1))

    # captions: random text words, with each GT box's visual word
    # placed at a distinct position
    cap_len = rng.randint(max(3, Lq // 2), Lq + 1, B)
    input_seq = np.zeros((B, S, Lq + 1, 4), np.int64)
    gt_seq = np.zeros((B, 10, Lq), np.int64)
    mask_boxes = np.ones((B, S, K, Lq + 1), np.uint8)
    for b in range(B):
        words = rng.randint(1, cfg.vocab_size - 1, Lq)  # exclude UNK
        words[cap_len[b]:] = 0
        vis_positions = rng.permutation(cap_len[b])[:n_box[b]]
        iseq = np.zeros((Lq + 1, 4), np.int64)
        iseq[1:, 0] = words
        iseq[1:, 3] = words
        for k, pos in enumerate(vis_positions):
            det_cls = int(gt_boxes[b, k, 5])
            iseq[pos + 1, 0] = det_cls + cfg.vocab_size
            iseq[pos + 1, 1] = 1
            iseq[pos + 1, 2] = det_cls
            mask_boxes[b, :, k, pos + 1] = 0
        input_seq[b, :] = iseq[None]
        gt_seq[b, :] = words[None]

    num = np.zeros((B, 7), np.float32)
    num[:, 0] = 1
    num[:, 1] = R
    num[:, 2] = n_box
    num[:, 3] = rng.randint(0, 5, B)
    num[:, 4] = rng.randint(5, 10, B)
    num[:, 5] = rng.uniform(0, 0.5, B)
    num[:, 6] = rng.uniform(0.5, 1.0, B)

    lo = rng.randint(0, max(T // 2, 1), B)
    hi = lo + rng.randint(1, max(T // 2, 2), B)
    sample_idx = np.stack([lo, np.minimum(hi, T)], axis=1).astype(np.int64)

    pnt_mask = np.concatenate(
        [np.zeros((B, 1), bool), pnt_mask_r], axis=1)

    return {
        "seg_feat": seg_feat,
        "input_seq": input_seq,
        "gt_seq": gt_seq,
        "num": num,
        "ppls": ppls,
        "gt_boxes": gt_boxes,
        "mask_boxes": mask_boxes.astype(bool),
        "ppls_feat": ppls_feat,
        "frm_mask": frm_mask,
        "sample_idx": sample_idx,
        "pnt_mask": pnt_mask,
        "seg_id": [f"v_SYN{b:04d}_segment_{b:02d}" for b in range(B)],
    }
