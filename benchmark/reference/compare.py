"""The numbers that decide ``correct`` in the serving cells: what the timed
path served, judged by the plain reference teacher-forced on the served
words. Each is a widest gap or a largest error, so 0 is a perfect score.

- ``logit_gap``: the widest gap by which a served word's log-probability
  (TopDown, as the program reports it, in either direction) or logit
  (Transformer, as the reference computes it; the program reports none)
  lies below the reference's best one that the decoding rule could have
  picked at that position.
- ``logprob_err``: the largest difference between a served word's
  log-probability and the reference's.
- ``att2_err``: the largest difference between the served region scores
  of a step and the reference's (unmasked proposals).
- ``sim_err``: the largest difference between the served class-region
  similarity (the grounder's softmax) and the reference's.
- ``att2_gap``: the widest gap by which the region score of a served
  argmax proposal (over all proposals, and in each frame) lies below
  the reference's best.

Positions after a beam caption's end word are not compared (the
program fills them with zeros, and its region indices with -1).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.gvd import MIN_VALUE, GVDReference, Ops


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def topdown_greedy(ref: GVDReference, ops: Ops, enc: Dict, out: Dict
                   ) -> Dict[str, float]:
    dev = enc["fc"].device
    seq = _tensor(out["seq"], dev).long()
    lp, scores = ref.teacher_forced(ops, enc, seq)
    unk = torch.arange(lp.shape[-1], device=dev) == ref.unk
    best = lp.masked_fill(unk, -math.inf).max(-1).values
    served = lp.gather(-1, seq[..., None])[..., 0]
    live = scores > MIN_VALUE / 2
    att2 = _tensor(out["att2_weights"], dev).float()
    reported = _tensor(out["logprobs"], dev).float()
    return {
        "logit_gap": float((best - reported).abs().max()),
        "logprob_err": float((reported - served).abs().max()),
        "att2_err": float(torch.where(live, (att2 - scores).abs(), 0.0)
                          .max()),
        "sim_err": float((_tensor(out["sim_mat"], dev).float()
                          - enc["sim_mat"]).abs().max()),
    }


def transformer_greedy(ref: GVDReference, ops: Ops, enc: Dict, out: Dict
                       ) -> Dict[str, float]:
    dev = enc["fc"].device
    seq = _tensor(out["seq"], dev).long()
    logits = ref.transformer_logits(ops, enc, seq)
    served = logits.gather(-1, seq[..., None])[..., 0]
    return {
        "logit_gap": float((logits.max(-1).values - served).max()),
        "sim_err": float((_tensor(out["sim_mat"], dev).float()
                          - enc["sim_mat"]).abs().max()),
    }


def topdown_beam(ref: GVDReference, ops: Ops, enc: Dict, out: Dict
                 ) -> Dict[str, float]:
    dev = enc["fc"].device
    m = ref.m
    seq = _tensor(out["seq"], dev).long()
    B, L = seq.shape
    lp, scores = ref.teacher_forced(ops, enc, seq)
    served = lp.gather(-1, seq[..., None])[..., 0]
    # up to and with the first end word
    ended = (seq == 0).long().cumsum(1)
    valid = (ended == 0) | ((ended == 1) & (seq == 0))
    lp_err = (_tensor(out["logprobs"], dev).float() - served).abs()
    # after the end word the program reports region index -1: gather at 0
    # there (the position is not compared)
    ind = torch.where(valid, _tensor(out["att2_ind"], dev).long(), 0)
    gap_all = scores.max(-1).values - scores.gather(-1, ind[..., None])[..., 0]
    frames = scores.view(B, L, m["num_sampled_frm"], m["num_prop_per_frm"])
    find = torch.where(valid[..., None],
                       _tensor(out["att2_frm_ind"], dev).long(), 0)
    gap_frm = (frames.max(-1).values
               - frames.gather(-1, find[..., None])[..., 0]).max(-1).values
    return {
        "logprob_err": float(torch.where(valid, lp_err, 0.0).max()),
        "att2_gap": float(torch.where(valid, torch.maximum(gap_all, gap_frm),
                                      0.0).max()),
    }


JUDGES = {"topdown_greedy": topdown_greedy,
          "transformer_greedy": transformer_greedy,
          "topdown_beam": topdown_beam}


def control_outputs(kind: str, ref: GVDReference, ops: Ops, enc: Dict,
                    L: int, width: int = 1) -> Dict:
    """What the reference serves in the program's place (in ``ops``'
    precision): the control of the comparison."""
    if kind == "topdown_greedy":
        return ref.greedy(ops, enc, L)
    if kind == "transformer_greedy":
        return ref.transformer_greedy(ops, enc, L)
    return ref.beam(ops, enc, L, width)
