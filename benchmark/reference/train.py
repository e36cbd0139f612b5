"""Plain PyTorch reference of the supervised GVD train step: the
teacher-forced TopDown forward with its dropout, the four losses
(misc/model.py:283-489, misc/utils.py:117-152, main.py:197-311), the
backward by autograd, the global-norm clip and Adam, over sequential
microbatches whose masked means are scaled by their mask counts over the
whole batch's (so their gradients sum to the batch's).

Dropout draws its masks as the configuration states them: every site
outside the obj_interact layers keeps an element where a uniform of one
``torch.Generator`` lies below 1 - rate, drawn site by site in the order
of the forward; the obj_interact layers, trained through the program's
fused layer (K5), take a seed from that generator per layer and hash
(murmur3's finalizer, keyed by seed, site and row) a uniform for every
element, kept where it is at least the rate. So the reference drops
what the program drops when both start from one generator state.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.gvd import (MIN_VALUE, EncoderLayer, GVDReference,
                                     Ops, attention_heads, layer_norm,
                                     layer_norm_std)

M32 = 0xFFFFFFFF
SITE_PROBS, SITE_RESID1, SITE_RESID2 = 0x10000000, 0x20000000, 0x30000000
ROW_STRIDE = 8          # the probs site's salt per row: max(heads, 8)
FINETUNE = ("ctx2pool_grd", "vis_embed")   # trained at 0.1 x the rate


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x below 2**32, in 16-bit halves."""
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hashed_uniform(rows: int, cols: int, seed: torch.Tensor,
                   salt: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1), salt.shape + (rows, cols): element (i, j) from
    the counter i * cols + j, keyed by seed and salt."""
    dev = salt.device
    ctr = (torch.arange(rows, device=dev)[:, None] * cols
           + torch.arange(cols, device=dev)[None, :])
    key = _fmix32(((seed.reshape(()) & M32) + _fmix32(salt & M32)) & M32)
    return (_fmix32(ctr ^ key[..., None, None]) >> 8).float() / (1 << 24)


class Dropout:
    """The masks of one train step, from one generator, in call order."""

    def __init__(self, generator: torch.Generator):
        self.g = generator

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=self.g, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)

    def seed(self, device) -> torch.Tensor:
        return torch.randint(0, 1 << 32, (1,), generator=self.g,
                             device=device, dtype=torch.int64)


def _hashed_drop(t, u, rate):
    return torch.where(u >= rate, t / (1.0 - rate), 0.0)


def obj_layer_train(ops: Ops, layer: EncoderLayer, x: torch.Tensor,
                    seed: torch.Tensor, rate: float, n_heads: int = 6):
    """One obj_interact layer in training with hashed dropout on the
    attention probabilities (an (Rp, Rp) counter per row and head, Rp =
    R rounded up to 128) and on both residual branches (an (R, D)
    counter per row)."""
    B, R, D = x.shape
    rows = torch.arange(B, device=x.device)

    def probs_drop(p, h):
        if rate <= 0.0:
            return p
        Rp = -(-R // 128) * 128
        u = hashed_uniform(Rp, Rp, seed, SITE_PROBS + rows * ROW_STRIDE + h)
        return _hashed_drop(p, u[:, :R, :R], rate)

    def resid_drop(t, site):
        if rate <= 0.0:
            return t
        return _hashed_drop(t, hashed_uniform(R, D, seed, site + rows), rate)

    a = attention_heads(ops, layer.selfattn.layer, x, x, n_heads,
                        probs=probs_drop)
    x1 = layer_norm_std(layer.selfattn.layernorm,
                        x + resid_drop(a, SITE_RESID1))
    ff = layer.feedforward.layer
    f = ops.lin(F.relu(ops.lin(x1, ff.linear1)), ff.linear2)
    return layer_norm_std(layer.feedforward.layernorm,
                          x1 + resid_drop(f, SITE_RESID2))


def iou(ppls: torch.Tensor, gt: torch.Tensor, off_frame: torch.Tensor):
    """(B, R, K) IoU of proposals and GT boxes (+1 pixel sizes), 0 off
    the GT box's frame and for an empty GT box, -1 for an empty
    proposal (misc/utils.py:293-297, bbox_overlaps_batch)."""
    a, g = ppls[..., :4].float(), gt[..., :4].float()
    gw, gh = g[..., 2] - g[..., 0] + 1, g[..., 3] - g[..., 1] + 1
    aw, ah = a[..., 2] - a[..., 0] + 1, a[..., 3] - a[..., 1] + 1
    iw = (torch.minimum(a[:, :, None, 2], g[:, None, :, 2])
          - torch.maximum(a[:, :, None, 0], g[:, None, :, 0]) + 1)
    ih = (torch.minimum(a[:, :, None, 3], g[:, None, :, 3])
          - torch.maximum(a[:, :, None, 1], g[:, None, :, 1]) + 1)
    inter = iw.clamp_min(0) * ih.clamp_min(0)
    out = inter / ((aw * ah)[:, :, None] + (gw * gh)[:, None, :] - inter)
    out = out * ~off_frame
    out = out.masked_fill(((gw == 1) & (gh == 1))[:, None, :], 0.0)
    return out.masked_fill(((aw == 1) & (ah == 1))[:, :, None], -1.0)


def supervision(b: Dict[str, torch.Tensor], L: int) -> Dict:
    """The targets of the losses (one caption a segment): the GT class
    of each (box, proposal) with IoU > 0.5, each step's proposals that
    overlap its GT box, the proposals off every frame of the step's
    boxes, and the mask counts."""
    pnt = b["pnt_mask"].bool()
    frm = b["frm_mask"].bool()
    boxes = b["mask_boxes"].bool()[:, 0]                    # (B, K, L+1)
    tgt = b["gt_seq"][:, 0].long()                          # (B, L)
    ov = iou(b["ppls"], b["gt_boxes"], frm | pnt[:, 1:, None])
    sim_target = ((ov > 0.5).long()
                  * b["gt_boxes"][:, None, :, 5].long()).transpose(1, 2)
    roi = torch.stack([(ov.masked_fill(boxes[:, None, :, t + 1], 0.0)
                        .max(2).values > 0.5).float() for t in range(L)], 1)
    off = torch.stack([(~(boxes[:, None, :, t + 1] | frm)).sum(2) <= 0
                       for t in range(L)], 1)               # (B, L, R)
    step_pnt = torch.cat([torch.zeros_like(off[:, :, :1]), off], 2) \
        | pnt[:, None, :]
    return {"sim_target": sim_target, "roi": roi, "step_pnt": step_pnt,
            "txt_count": ((tgt[:, :L - 1] > 0).sum() + tgt.shape[0]).float(),
            "roi_count": (roi > 0).sum().float(),
            "cls_count": (sim_target > 0).sum().float()}


def _masked_mean(x, mask):
    return torch.where(mask, x, 0.0).sum() / mask.sum().float().clamp_min(1.0)


def microbatch_losses(ref: GVDReference, ops: Ops, drop: Dropout,
                      b: Dict[str, torch.Tensor], sup: Dict, rates: Dict
                      ) -> Dict[str, torch.Tensor]:
    """The four masked-mean losses of a microbatch, teacher-forced, with
    dropout at every site of the model."""
    m = ref.m
    L, V = m["seq_length"], m["vocab_size"]
    p_lm, p_loc, p_enc = rates["drop_prob_lm"], rates["loc_drop"], \
        rates["enc_drop"]
    dev = b["seg_feat"].device
    seg, ppls = b["seg_feat"].float(), b["ppls"].float()
    pnt = b["pnt_mask"].bool()
    B = seg.shape[0]
    # encode (model.py:302-409) in training
    seg_info = drop(F.relu(ops.lin(b["num"].float()[:, 3:7],
                                   ref.seg_info_embed[0])), p_lm)
    fc = torch.cat([layer_norm(seg.mean(1)), layer_norm(seg_info)], -1)
    g_pool = drop(F.relu(ops.lin(b["ppls_feat"].float(),
                                 ref.ctx2pool_grd[0])), p_lm)
    words = drop(F.relu(ref.vis_embed[0].weight), p_lm)
    sim = ops.mm(words, g_pool.transpose(1, 2)) \
        + ref.vis_classifiers_bias[None, :, None]
    sim = torch.softmax(sim.masked_fill(pnt[:, None, 1:], MIN_VALUE), dim=1)
    loc = drop(F.relu(ops.lin(torch.cat(
        [ppls[..., :4] / 720.0, ppls[..., 4:5] / m["num_sampled_frm"]], -1),
        ref.loc_fc[0])), p_loc)
    pool = F.relu(ops.lin(torch.cat(
        [layer_norm(g_pool), layer_norm(loc), layer_norm(sim.transpose(1, 2))],
        -1), ref.pool_embed[0]))
    fc = drop(F.relu(ops.lin(fc, ref.fc_embed[0])), p_lm)
    pool = drop(pool, p_lm)
    layers = ref.obj_interact.encoder.layers
    seeds = [drop.seed(dev) for _ in layers]
    for layer, seed in zip(layers, seeds):
        pool = obj_layer_train(ops, layer, pool, seed, p_enc)
    p_pool = ops.lin(pool, ref.ctx2pool)
    rgb = seg[..., :m["rgb_feat_size"]]
    conv = torch.cat([
        drop(F.relu(ops.lin(rgb, ref.att_embed[0][0])), p_lm),
        drop(F.relu(ops.lin(seg[..., m["rgb_feat_size"]:],
                            ref.att_embed[1][0])), p_lm)], -1)
    bn = ref.att_embed_aux[0]
    mean, var = conv.mean((0, 1)), conv.var((0, 1), unbiased=False)
    conv = (conv - mean) / torch.sqrt(var + 1e-5) * bn.weight + bn.bias
    conv = ref.context_enc(ops, F.relu(conv),
                           between=lambda x: drop(x, p_enc))
    t = torch.arange(conv.shape[1], device=dev)[None]
    idx = b["sample_idx"].long()
    conv = conv * ((t >= idx[:, :1]) & (t < idx[:, 1:2]))[..., None]
    enc = {"fc": fc, "conv": conv, "p_conv": ops.lin(conv, ref.ctx2att),
           "pool": pool, "p_pool": p_pool}

    # the teacher-forced steps (model.py:421-453)
    tgt = b["gt_seq"][:, 0].long()
    inp = torch.cat([tgt.new_zeros(B, 1), tgt[:, :L - 1]], 1)
    xt = drop(F.relu(ref.embed[0].weight[inp]), p_lm)
    state = ref.zero_state(B, dev)
    lps, scores = [], []
    for s in range(L):
        h_lang, s2, state = ref.core_step(ops, enc, xt[:, s], state,
                                          pnt[:, 1:], sup["step_pnt"][:, s,
                                                                      1:])
        lps.append(torch.log_softmax(ops.lin(drop(h_lang, p_lm), ref.logit),
                                     -1))
        scores.append(s2)
    lp, att2 = torch.stack(lps, 1), torch.stack(scores, 1)

    # the grounder over the target's visual words (model.py:467-480)
    vis = (b["input_seq"][:, 0, 1:, 0].long() - V).clamp_min(0)
    xv = drop(F.relu(ref.vis_embed[0].weight[vis]), p_lm)
    grd = ops.mm(xv, g_pool.transpose(1, 2)) \
        + ref.vis_classifiers_bias[vis][..., None] + att2
    grd = grd.masked_fill(sup["step_pnt"][:, :, 1:], MIN_VALUE)

    # the losses (misc/utils.py:117-152, model.py:345-350)
    txt = torch.cat([torch.ones_like(tgt[:, :1], dtype=torch.bool),
                     tgt[:, :-1] > 0], 1)
    lm = _masked_mean(-lp.gather(2, tgt[..., None])[..., 0], txt)
    roi = sup["roi"] > 0
    att2_loss = -_masked_mean(torch.log_softmax(att2, 2), roi)
    ground = -_masked_mean(torch.log_softmax(grd, 2), roi)
    picked = sim.gather(1, sup["sim_target"])
    zero = picked <= 0
    bce = torch.where(zero, 100.0, torch.clamp(
        -torch.log(torch.where(zero, 1.0, picked)), max=100.0))
    cls = _masked_mean(bce, sup["sim_target"] > 0)
    return {"lm_loss": lm, "att2_loss": att2_loss, "ground_loss": ground,
            "cls_loss": cls}


TERMS = (("lm_loss", "txt_count", "w_lm"), ("att2_loss", "roi_count", "w_att2"),
         ("ground_loss", "roi_count", "w_grd"), ("cls_loss", "cls_count",
                                                 "w_cls"))


class ReferenceTrainer:
    """The reference model, Adam over its trainable parameters (the
    transferred layers at ``finetune_lr_scale`` of the rate), and one
    dropout generator seeded like the program's."""

    def __init__(self, ref: GVDReference, train: Dict, precision: str,
                 generator_seed: int, device, accum: int,
                 keep_rows: Optional[float] = None):
        self.ref, self.train, self.accum = ref, train, accum
        self.ops = Ops(precision)
        self.keep_rows = keep_rows
        self.gen = torch.Generator(device=device).manual_seed(generator_seed)
        main, fine = [], []
        for name, p in ref.named_parameters():
            if p.requires_grad:
                (fine if name.split(".")[0] in FINETUNE else main).append(p)
        self.opt = torch.optim.Adam(
            [{"params": main, "lr": train["learning_rate"]},
             {"params": fine, "lr": train["learning_rate"]
              * train["finetune_lr_scale"]}],
            betas=(0.9, 0.999), eps=1e-8)
        self.params = main + fine

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update on ``batch``: the loss terms (the batch's values) and
        the gradient's global norm before the clip."""
        t, L = self.train, self.ref.m["seq_length"]
        weights = {"w_lm": 1.0, "w_att2": t["w_att2"], "w_grd": t["w_grd"],
                   "w_cls": t["w_cls"]}
        n = batch["seg_feat"].shape[0] // self.accum
        parts = [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                 for i in range(self.accum)]
        if self.keep_rows is not None:       # a fault: rows left out
            keep = int(n * self.keep_rows)
            parts = [{k: v[:keep] for k, v in p.items()} for p in parts]
        sups = [supervision(p, L) for p in parts]
        totals = {c: sum(s[c] for s in sups).clamp_min(1.0)
                  for c in ("txt_count", "roi_count", "cls_count")}
        drop = Dropout(self.gen)
        out = {k: 0.0 for k, _, _ in TERMS}
        out["loss"] = 0.0
        for p, sup in zip(parts, sups):
            losses = microbatch_losses(self.ref, self.ops, drop, p, sup, t)
            loss = 0.0
            for name, count, w in TERMS:
                frac = losses[name] * (sup[count] / totals[count])
                out[name] += float(frac.detach())
                if weights[w]:
                    loss = loss + weights[w] * frac
            loss.backward()
            out["loss"] += float(loss.detach())
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        factor = torch.where(norm < t["grad_clip"], 1.0, t["grad_clip"] / norm)
        for g in grads:
            g.mul_(factor)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        out["grad_norm"] = float(norm)
        return out

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Adam's first moment of every trainable parameter, by name."""
        names = {id(p): n for n, p in self.ref.named_parameters()}
        return {names[id(p)]: self.opt.state[p]["exp_avg"]
                for p in self.params if p in self.opt.state}


def first_gradient(exp_avg: torch.Tensor, beta1: float = 0.9):
    """The gradient Adam took at its first step, from its first moment."""
    return exp_avg / (1.0 - beta1)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               leaves: Optional[List[str]] = None) -> float:
    """The widest gap between two norms of a leaf, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    leaves = list(want) if leaves is None else leaves
    median = sorted(want[k] for k in leaves)[len(leaves) // 2]
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30)
               for k in leaves)


def moved_leaves(grad_norms: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is above a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    median = sorted(grad_norms.values())[len(grad_norms) // 2]
    return [k for k, v in grad_norms.items() if v >= 1e-3 * median]


def relative(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """The numbers of a train cell from the readings of the program and
    of the reference after the same three steps: ``losses`` (per step,
    the terms, the loss and the pre-clip norm), ``grad`` (leaf norms of
    the first step's clipped gradient, as Adam holds it) and ``delta``
    (leaf norms of the parameters' change after the third step)."""
    loss_err = max(relative(p[k], r[k])
                   for p, r in zip(program["losses"], reference["losses"])
                   for k in ("loss", "lm_loss", "att2_loss", "ground_loss",
                             "cls_loss"))
    norm_err = max(relative(p["grad_norm"], r["grad_norm"])
                   for p, r in zip(program["losses"], reference["losses"]))
    moved = moved_leaves(reference["grad"])
    return {"loss_err": loss_err, "norm_err": norm_err,
            "grad_err": worst_leaf(program["grad"], reference["grad"]),
            "step_err": worst_leaf(program["delta"], reference["delta"],
                                   moved)}


def follow(ref: GVDReference, train: Dict, precision: str,
           generator_seed: int, batches: List[Dict[str, torch.Tensor]],
           accum: int, keep_rows: Optional[float] = None) -> Dict:
    """Three reference steps on ``batches`` from the weights ``ref``
    holds: the readings ``numbers`` compares."""
    before = {k: v.detach().clone() for k, v in ref.named_parameters()}
    rt = ReferenceTrainer(ref, train, precision, generator_seed,
                          batches[0]["seg_feat"].device, accum, keep_rows)
    losses, grad = [], None
    for i, b in enumerate(batches):
        losses.append(rt.step(b))
        if i == 0:
            grad = leaf_norms({k: first_gradient(v) for k, v in
                               rt.first_moments().items()})
    after = dict(ref.named_parameters())
    delta = leaf_norms({k: after[k].detach() - before[k] for k in grad})
    return {"losses": losses, "grad": grad, "delta": delta}


