"""The benchmark's traffic: batches of ANet-Entities-shaped segments drawn
on the device from a seed and handed to the program as host numpy
arrays, with the keys, shapes and dtypes of the dataset loader's batches
(``data/dataset.py``'s ``ARRAY_KEYS``).

The draws follow the distributions of the port's synthetic batch
(``data/synthetic.py``: frame features N(0, 1), region features
N(0, 0.25), proposals of 30 to 30% of a 720 x 405 frame on a random
frame, ground-truth boxes jittered from proposals of their frame,
captions of L/2 to L words with each box's visual word at its own
position), vectorized, so one large call makes each field. A traffic
mix is a JSON file of parameters under ``workloads/``; this module reads
it and knows nothing of any one mix.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

IMG_W, IMG_H = 720.0, 405.0


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _randint(g, lo, hi, shape, device):
    return torch.randint(lo, hi, shape, generator=g, device=device)


def draw_batch(m: Dict, B: int, g: torch.Generator, device) -> Dict:
    """One batch of B segments of the configuration's ``model`` block
    ``m``, as device tensors."""
    R = m["num_sampled_frm"] * m["num_prop_per_frm"]
    K, L, T, V = m["max_gt_box"], m["seq_length"], m["t_attn_size"], \
        m["vocab_size"]
    F = m["rgb_feat_size"] + m["motion_feat_size"]
    d = device
    seg_feat = torch.randn((B, T, F), generator=g, device=d)
    x1 = _uniform(g, (B, R), 0, IMG_W * 0.7, d)
    y1 = _uniform(g, (B, R), 0, IMG_H * 0.7, d)
    w = _uniform(g, (B, R), 30, IMG_W * 0.3, d)
    h = _uniform(g, (B, R), 30, IMG_H * 0.3, d)
    ppls = torch.stack([
        x1, y1, torch.clamp(x1 + w, max=IMG_W - 1),
        torch.clamp(y1 + h, max=IMG_H - 1),
        _randint(g, 0, m["num_sampled_frm"], (B, R), d).float(),
        _randint(g, 1, 1601, (B, R), d).float(),
        _uniform(g, (B, R), 0.3, 1.0, d)], dim=-1)
    ppls_feat = torch.randn((B, R, m["att_feat_size"]), generator=g,
                            device=d) * 0.5

    # ground-truth boxes: jittered copies of proposals, on their frame
    n_box = _randint(g, 1, K + 1, (B,), d)
    box = torch.arange(K, device=d)[None] < n_box[:, None]          # (B, K)
    src = ppls.gather(1, _randint(g, 0, R, (B, K), d)[..., None]
                      .expand(B, K, 7))
    gt_boxes = torch.cat([
        src[..., :4] + _uniform(g, (B, K, 4), -3, 3, d), src[..., 4:5],
        _randint(g, 1, m["detect_size"] + 1, (B, K, 1), d).float()], -1)
    gt_boxes = gt_boxes * box[..., None]
    frm_mask = (ppls[:, :, None, 4] != gt_boxes[:, None, :, 4]) \
        | ~box[:, None, :]                                          # (B, R, K)

    # captions: words 1 .. V-2 (no UNK), each box's visual word at a
    # distinct position of the caption
    cap_len = _randint(g, max(3, L // 2), L + 1, (B,), d)
    pos = torch.arange(L, device=d)[None]
    words = torch.where(pos < cap_len[:, None],
                        _randint(g, 1, V - 1, (B, L), d), 0)
    order = torch.where(pos < cap_len[:, None],
                        torch.rand((B, L), generator=g, device=d),
                        2.0).argsort(1)                             # (B, L)
    input_seq = torch.zeros((B, L + 1, 4), dtype=torch.long, device=d)
    input_seq[:, 1:, 0] = words
    input_seq[:, 1:, 3] = words
    mask_boxes = torch.ones((B, K, L + 1), dtype=torch.bool, device=d)
    rows = torch.arange(B, device=d)
    for k in range(min(K, L)):
        on = (k < n_box) & (k < cap_len)
        p = order[:, k] + 1
        cls = gt_boxes[:, k, 5].long()
        for col, val in ((0, cls + V), (1, torch.ones_like(cls)), (2, cls)):
            input_seq[rows, p, col] = torch.where(
                on, val, input_seq[rows, p, col])
        mask_boxes[rows, k, p] = mask_boxes[rows, k, p] & ~on

    num = torch.stack([
        torch.ones(B, device=d), torch.full((B,), float(R), device=d),
        n_box.float(), _randint(g, 0, 5, (B,), d).float(),
        _randint(g, 5, 10, (B,), d).float(), _uniform(g, (B,), 0, 0.5, d),
        _uniform(g, (B,), 0.5, 1.0, d)], dim=1)
    lo = _randint(g, 0, max(T // 2, 1), (B,), d)
    hi = lo + _randint(g, 1, max(T // 2, 2), (B,), d)
    sample_idx = torch.stack([lo, torch.clamp(hi, max=T)], 1)
    return {
        "seg_feat": seg_feat,
        "input_seq": input_seq[:, None],
        "gt_seq": words[:, None].expand(B, 10, L),
        "num": num,
        "ppls": ppls,
        "gt_boxes": gt_boxes,
        "mask_boxes": mask_boxes[:, None],
        "ppls_feat": ppls_feat,
        "frm_mask": frm_mask,
        "sample_idx": sample_idx,
        "pnt_mask": torch.zeros((B, R + 1), dtype=torch.bool, device=d),
    }


def host_batches(m: Dict, traffic: Dict, seed: int, device
                 ) -> List[Dict[str, np.ndarray]]:
    """The mix's ``distinct_batches`` batches of ``batch_size`` segments
    from ``seed``, as host arrays."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(traffic["distinct_batches"]):
        b = draw_batch(m, traffic["batch_size"], g, device)
        out.append({k: v.contiguous().cpu().numpy() for k, v in b.items()})
    return out
