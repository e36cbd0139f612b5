"""Batched beam search on the device, PyTorch port.

The port's copy of ``grounded_video_description_tpu/models/beam.py``.
Capability contract from misc/CaptionModelBU.py:24-185: a per-step beam
fork by cumulative logprob, the raw per-step logprob of each token, the
region-attention argmax of each beam, finished beams harvested (EOS, token
0, or the last step) with the finished beam's running score knocked to
-1000, and the best finished beam by cumulative score (model.py:738-740
takes done_beams[k][0]).

The whole batch and all W beams advance together: one core step for the
B * W rows, attention banks shared by the beams (``core_step_beam``),
state re-indexed by parent with one gather per tensor, and no per-item
loop or per-token host copy (CaptionModelBU.py:129 moved the logprobs to
the host every step).  The candidates are one top-W over (beam x vocab)
per item, the reference's per-row sort and global re-sort in one.  The
reference's ROI re-use ban (CaptionModelBU.py:168-175) is a no-op for
this model family (the logit layer emits only indices < vocab_size), so
it is not reproduced.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

NEG_INF = -1e18
FINISHED_SCORE = -1000.0


def _top_w(flat: torch.Tensor, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-w values and indices per row, descending, a tie going to the
    first index: w argmax passes, each masking its pick to NEG_INF (the
    JAX package's order; ``torch.topk`` promises no order among ties).

    PRECONDITION: every row holds at least ``w`` candidates greater than
    NEG_INF, else the indices repeat.  Beam search meets it (vocab_size >>
    w, and row 0 of the candidates is finite)."""
    vals, idxs = [], []
    cur = flat
    for _ in range(w):
        i = cur.argmax(dim=-1, keepdim=True)
        vals.append(cur.gather(-1, i))
        idxs.append(i)
        cur = cur.scatter(-1, i, NEG_INF)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _gather_beams(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """x (B, W, ...), parent (B, W) -> x[b, parent[b, w]]."""
    idx = parent.view(parent.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand_as(x))


def beam_search(model, enc: Dict[str, torch.Tensor], *,
                beam_size: int) -> Tuple[torch.Tensor, ...]:
    """Beam search of ``model`` (a ``GVDModel``) over the banks ``enc`` of
    its encode.  Returns (seq (B, L) int32, seq_logprobs (B, L) f32,
    att2_ind (B, L) int32, att2_frm_ind (B, L, num_sampled_frm) int32).

    att2_frm_ind is the per-frame proposal argmax of the best beam's region
    attention at every step, which generated-sentence grounding reads
    (main.py:361-384); position 0 is the BOS step's."""
    cfg = model.cfg
    W, Lq = beam_size, cfg.seq_length
    F, Ppf = cfg.num_sampled_frm, cfg.num_prop_per_frm
    V = cfg.vocab_size
    pnt_mask = enc["pnt_mask"]
    B, R = pnt_mask.shape[0], pnt_mask.shape[1] - 1
    dev = pnt_mask.device
    i32 = torch.int32

    def core(xt, state):
        return model.core_step_beam(
            xt, enc["fc_feats"], enc["conv_feats"], enc["p_conv_feats"],
            enc["pool_feats"], enc["p_pool_feats"], pnt_mask, state, W)

    def argmaxes(att2_w):
        """(the argmax ROI (B, W), the per-frame argmaxes (B, W, F))."""
        return (att2_w.view(B, W, R).argmax(dim=-1),
                att2_w.view(B, W, F, Ppf).argmax(dim=-1))

    # the BOS step (model.py:723-733)
    xt = model.embed_words(torch.zeros((B * W,), dtype=torch.long,
                                       device=dev))
    rnn_out, state, att2_w = core(xt, model.init_state(B * W, dev))
    att2_ind, att2f = argmaxes(att2_w)
    att2_first, att2f_first = att2_ind[:, 0], att2f[:, 0]

    beam_seq = torch.zeros((B, W, Lq), dtype=i32, device=dev)
    beam_lp = torch.zeros((B, W, Lq), dtype=torch.float32, device=dev)
    beam_att2 = torch.full((B, W, Lq), -1, dtype=torch.long, device=dev)
    beam_att2f = torch.zeros((B, W, Lq, F), dtype=torch.long, device=dev)
    beam_sum = torch.zeros((B, W), dtype=torch.float32, device=dev)
    best_score = torch.full((B,), NEG_INF, dtype=torch.float32, device=dev)
    best_seq = torch.zeros((B, Lq), dtype=i32, device=dev)
    best_lp = torch.zeros((B, Lq), dtype=torch.float32, device=dev)
    best_att2 = torch.full((B, Lq), -1, dtype=torch.long, device=dev)
    best_att2f = torch.zeros((B, Lq, F), dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)

    for t in range(Lq):
        logprobs = model.logit_logprobs(rnn_out).view(B, W, V)
        total = beam_sum[:, :, None] + logprobs
        if t == 0:
            # all beams are the same at t = 0: only row 0 may spawn
            total[:, 1:] = NEG_INF
        new_sum, flat_idx = _top_w(total.view(B, W * V), W)   # (B, W)
        parent = flat_idx // V
        word = flat_idx % V
        local_lp = logprobs.view(B, W * V).gather(1, flat_idx)

        beam_seq = _gather_beams(beam_seq, parent)
        beam_seq[:, :, t] = word.to(i32)
        beam_lp = _gather_beams(beam_lp, parent)
        beam_lp[:, :, t] = local_lp
        beam_att2 = _gather_beams(beam_att2, parent)
        beam_att2f = _gather_beams(beam_att2f, parent)
        if t >= 1:
            beam_att2[:, :, t] = att2_ind.gather(1, parent)
            beam_att2f[:, :, t] = _gather_beams(att2f, parent)

        # harvest finished beams (CaptionModelBU.py:154-166)
        finished = (word == 0) if t < Lq - 1 else torch.ones_like(
            word, dtype=torch.bool)
        fin_scores = torch.where(finished, new_sum, NEG_INF)
        best_w = fin_scores.argmax(dim=1)                     # (B,)
        cand_score = fin_scores[rows, best_w]
        improved = cand_score > best_score
        best_score = torch.where(improved, cand_score, best_score)
        best_seq = torch.where(improved[:, None], beam_seq[rows, best_w],
                               best_seq)
        best_lp = torch.where(improved[:, None], beam_lp[rows, best_w],
                              best_lp)
        best_att2 = torch.where(improved[:, None], beam_att2[rows, best_w],
                                best_att2)
        best_att2f = torch.where(improved[:, None, None],
                                 beam_att2f[rows, best_w], best_att2f)
        beam_sum = torch.where(finished, FINISHED_SCORE, new_sum)

        if t == Lq - 1:
            break       # the last step's core step would feed nothing
        # re-index the recurrent state by parent, then advance every beam
        # (rnn_out is the step's own output: the JAX package's re-index of
        # it is overwritten before any read)
        state = type(state)(*(
            _gather_beams(s.view(B, W, -1), parent).view(B * W, -1)
            for s in state))
        xt = model.embed_words(word.reshape(B * W))
        rnn_out, state, att2_w = core(xt, state)
        att2_ind, att2f = argmaxes(att2_w)

    best_att2[:, 0] = att2_first
    best_att2f[:, 0] = att2f_first
    return best_seq, best_lp, best_att2.to(i32), best_att2f.to(i32)
