"""Attention-overlay visualization.

The port's copy of ``grounded_video_description_tpu/utils/visualize.py``
(reference main.py:47-85 ``vis_infer`` and misc/utils.py:371-405
``vis_detections``): for each generated word, draw the most attended
proposal's box and its predicted region class onto the sampled frame it
lies on, and write ``vis/<run-id>/<seg_id>_generated_sent.jpg``.

Drawn with matplotlib's ``Agg`` backend (imported when a figure is
drawn; no cv2), so a machine without matplotlib runs everything else.
``Evaluator.evaluate`` calls it under ``vis_attn`` for the segments whose
frames lie under ``image_path``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def vis_infer(seg_frames: np.ndarray, seg_id: str, caption: str,
              att2_weights: np.ndarray, proposals: np.ndarray,
              num_proposals: int, sim_mat: np.ndarray,
              itod: dict, out_dir: str = "vis", run_id: str = "run"):
    """seg_frames: (n_frm, H, W, 3) uint8; att2_weights: (n_words, R)
    softmaxed; proposals: (R, 7); sim_mat: (C+1, R)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    words = caption.split()
    if not words:
        return None
    proposals = proposals[:num_proposals]
    sim_ind = np.argmax(sim_mat, axis=0)
    sim_val = np.max(sim_mat, axis=0)

    n = len(words)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    if n == 1:
        axes = [axes]
    for j, (word, ax) in enumerate(zip(words, axes)):
        idx = int(np.argmax(att2_weights[j][:num_proposals]))
        frm = int(proposals[idx, 4])
        frm = min(frm, seg_frames.shape[0] - 1)
        ax.imshow(seg_frames[frm])
        x1, y1, x2, y2 = proposals[idx, :4]
        ax.add_patch(patches.Rectangle(
            (x1, y1), x2 - x1, y2 - y1, fill=False, lw=3, color="lime"))
        cls_name = itod.get(int(sim_ind[idx]), "__background__")
        ax.set_title(f"{word}\n{cls_name} ({sim_val[idx]:.2f})",
                     fontsize=10)
        ax.axis("off")

    os.makedirs(os.path.join(out_dir, run_id), exist_ok=True)
    path = os.path.join(out_dir, run_id,
                        f"{seg_id}_generated_sent.jpg")
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)
    return path
