"""Training criteria, counterpart of ``grounded_video_description_tpu/
losses.py`` (reference: misc/utils.py:117-152, misc/model.py:345-350,
main.py:238-255).

Every mean is over the selected elements only (a masked mean), so the
fixed 20-step teacher-forced loop equals the reference's early exit.
Each criterion also returns its mask count: gradient accumulation scales
a microbatch's mean by count / total to get the full batch's mean.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    denom = mask.sum().float().clamp_min(1.0)
    return torch.where(mask, x, 0.0).sum() / denom


def lm_criterion_with_counts(
        decoded: torch.Tensor, att2_weights: torch.Tensor,
        ground_weights: torch.Tensor, target: torch.Tensor,
        att2_target: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """LM + attention + grounding losses and their mask counts.

    decoded (B, S, V) log-probabilities; att2_weights and ground_weights
    (B, S, R) masked logits; target (B, S) token ids (0 = pad/end);
    att2_target (B, S, R) {0, 1} ROI labels.  Returns (lm, att2, grd,
    txt_count, roi_count), all f32 scalars."""
    decoded = decoded.float()
    B = decoded.shape[0]
    # the END position counts: mask = [1, target[:-1] > 0]
    txt_mask = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                     device=target.device),
                          target[:, :-1] > 0], dim=1)
    nll = -decoded.gather(2, target[..., None].long())[..., 0]
    lm_loss = _masked_mean(nll, txt_mask)

    roi_mask = att2_target > 0
    att2_loss = -_masked_mean(
        F.log_softmax(att2_weights.float(), dim=2), roi_mask)
    ground_loss = -_masked_mean(
        F.log_softmax(ground_weights.float(), dim=2), roi_mask)
    return (lm_loss, att2_loss, ground_loss, txt_mask.sum().float(),
            roi_mask.sum().float())


def cls_criterion_with_counts(sim_mat_static: torch.Tensor,
                              sim_target: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Region-classification BCE (model.py:345-350) and its mask count.

    sim_mat_static (B, C+1, R) class-softmaxed similarity; sim_target
    (B, K, R) GT class per (box, ROI), 0 = none.  The loss is the mean of
    -log p[target] over non-zero targets, clamped at 100 as torch's
    binary_cross_entropy clamps its log at -100.  A probability of
    exactly 0 gives 100 with zero gradient through a where-guard, never an
    epsilon floor: under flush-to-zero an epsilon below the normal range
    is itself 0, and log(0) then meets the clamp's zero cotangent as NaN.
    """
    gathered = sim_mat_static.gather(1, sim_target.long())      # (B, K, R)
    mask = sim_target > 0
    zero = gathered <= 0.0
    safe = torch.where(zero, 1.0, gathered)
    bce = torch.where(zero, 100.0, torch.clamp(-torch.log(safe), max=100.0))
    return _masked_mean(bce, mask), mask.sum().float()


def total_loss(lm, att2, grd, cls, *, w_att2: float, w_grd: float,
               w_cls: float, disable_caption: bool = False) -> torch.Tensor:
    """The weighted sum (main.py:238-255)."""
    loss = torch.zeros((), device=lm.device)
    if not disable_caption:
        loss = loss + lm
    if w_att2:
        loss = loss + w_att2 * att2
    if w_grd:
        loss = loss + w_grd * grd
    if w_cls:
        loss = loss + w_cls * cls
    return loss
