"""Box geometry and target assignment, always in f32.

Counterpart of ``grounded_video_description_tpu/ops/geometry.py``
(reference: misc/bbox_transform.py:176-273, misc/utils.py:299-328).
Boxes are [x1, y1, x2, y2, ...] with the inclusive +1 pixel convention;
masks are bool with True == masked out; a degenerate (1 x 1) GT box zeros
its IoU column and a degenerate proposal sets its IoU row to -1.
"""

from __future__ import annotations

from typing import Optional

import torch


def bbox_overlaps_batch(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                        frm_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """anchors (B, N, >=4), gt_boxes (B, K, >=4), frm_mask (B, N, K) bool
    (True where proposal and GT lie on different frames: IoU forced to
    0).  Returns the (B, N, K) f32 IoU."""
    a = anchors[..., :4].float()
    g = gt_boxes[..., :4].float()

    gt_w = g[:, :, 2] - g[:, :, 0] + 1.0          # (B, K)
    gt_h = g[:, :, 3] - g[:, :, 1] + 1.0
    gt_area = (gt_w * gt_h)[:, None, :]           # (B, 1, K)
    an_w = a[:, :, 2] - a[:, :, 0] + 1.0          # (B, N)
    an_h = a[:, :, 3] - a[:, :, 1] + 1.0
    an_area = (an_w * an_h)[:, :, None]           # (B, N, 1)
    gt_zero = ((gt_w == 1.0) & (gt_h == 1.0))[:, None, :]
    an_zero = ((an_w == 1.0) & (an_h == 1.0))[:, :, None]

    iw = (torch.minimum(a[:, :, None, 2], g[:, None, :, 2])
          - torch.maximum(a[:, :, None, 0], g[:, None, :, 0]) + 1.0)
    ih = (torch.minimum(a[:, :, None, 3], g[:, None, :, 3])
          - torch.maximum(a[:, :, None, 1], g[:, None, :, 1]) + 1.0)
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
    overlaps = inter / (an_area + gt_area - inter)
    if frm_mask is not None:
        overlaps = overlaps * (~frm_mask).to(overlaps.dtype)
    overlaps = overlaps.masked_fill(gt_zero, 0.0)
    return overlaps.masked_fill(an_zero, -1.0)


def bbox_overlaps(rois: torch.Tensor, gt_box: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """misc/utils.py:293-297: the frame | proposal mask passed in."""
    return bbox_overlaps_batch(rois[:, :, :5], gt_box[:, :, :5], mask)


def sim_mat_target(overlaps: torch.Tensor,
                   pad_gt_bboxs: torch.Tensor) -> torch.Tensor:
    """overlaps (B, N, K), class labels (B, K) -> (B, K, N) int64: the
    GT class where IoU > 0.5, else 0."""
    hit = (overlaps > 0.5).long()
    return (hit * pad_gt_bboxs[:, None, :].long()).transpose(1, 2)


def bbox_target(mask: torch.Tensor, overlaps: torch.Tensor) -> torch.Tensor:
    """mask (B, K) bool (True masks a GT box out at this step), overlaps
    (B, N, K) -> (B, N) f32: 1 where the ROI overlaps the step's active GT
    box with IoU > 0.5."""
    masked = overlaps.masked_fill(mask[:, None, :], 0.0)
    return (masked.max(dim=2).values > 0.5).float()
