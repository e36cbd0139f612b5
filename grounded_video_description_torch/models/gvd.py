"""The Grounded-Video-Description model, PyTorch port: the inference
path of greedy captioning.

Counterpart of ``grounded_video_description_tpu/models/gvd.py``: the
encode path (model.py:302-409 / 504-568), the TopDown core
(AttModel.py:134-164) and greedy UNK-suppressed sampling
(model.py:492-624).  Beam search, the training forward and its losses,
GRD mode and the transformer captioner are not ported yet.

Parameters are float32 and named after the reference state dict, so
``engine/checkpoint.py::import_torch_checkpoint`` of the JAX package
reads a port ``state_dict()`` as it is.  Activations run in
``cfg.dtype``; weights are cast where they are used, as in the JAX
package.  Three config flags select the hand-written kernels:
``use_pallas_rnn`` (K2, the BiRNN recurrence), ``use_pallas_encoder``
(K1, the obj_interact layer) and ``use_pallas`` (K3, the per-token region
attention).  A kernel wrapper runs its plain version on CPU tensors.
The config is the port's own (``config.py``), field for field a subset
of the JAX package's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from grounded_video_description_torch.config import GVDConfig
from grounded_video_description_torch.models import transformer as xf
from grounded_video_description_torch.nn import (
    BiRNNParams, LSTMCellParams, batch_norm, birnn, dropout, embedding,
    init_embedding_, init_linear_, layer_norm, linear, lstm_cell,
)
from grounded_video_description_torch.ops import (
    MIN_VALUE, grounder, region_attention, temporal_attention,
)


class CoreState(NamedTuple):
    h_att: torch.Tensor
    c_att: torch.Tensor
    h_lang: torch.Tensor
    c_lang: torch.Tensor


def _lin(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return linear(x, m.weight, m.bias)


def _seq(m: nn.Module) -> nn.Sequential:
    """A one-layer nn.Sequential: gives the reference's ``name.0.*``
    state-dict keys."""
    return nn.Sequential(m)


class AttentionParams(nn.Module):
    def __init__(self, rnn_size: int, att_hid: int, alpha_in: int = 0):
        super().__init__()
        self.h2att = nn.Linear(rnn_size, att_hid)
        if alpha_in:
            self.alpha_net = nn.Linear(alpha_in, 1)


class TopDownCore(nn.Module):
    """TopDown core (AttModel.py:111-131).  The reference also allocates
    unused i2h_2/h2h_2 layers; not reproduced."""

    def __init__(self, cfg: GVDConfig):
        super().__init__()
        rnn, hid = cfg.rnn_size, cfg.att_hid_size
        attn_width = {"add": hid, "mix": hid, "mix_mul": hid,
                      "cat": 2 * hid}.get(cfg.region_attn_mode, 0)
        self.att_lstm = LSTMCellParams(cfg.input_encoding_size + rnn, rnn)
        self.lang_lstm = LSTMCellParams(2 * rnn, rnn)
        self.attention = AttentionParams(rnn, hid, hid)
        self.attention2 = AttentionParams(rnn, hid, attn_width)
        if cfg.att_input_mode == "dual_region":
            self.attention2_dual = AttentionParams(rnn, hid, attn_width)
            self.dual_pointer = _seq(nn.Linear(rnn, 1))


class GVDModel(nn.Module):
    """Build with ``GVDModel(cfg).init(generator)`` or load a state dict
    (``weights.from_jax_variables``)."""

    def __init__(self, cfg: GVDConfig):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        # grounder head style (model.py:55-58): additive only for
        # region_attn_mode add/cat; 'mix'/'mix_mul'/'dp' -> dot product
        self.grounder_additive = cfg.region_attn_mode in ("add", "cat")
        self.unk_idx = (cfg.unk_idx if cfg.unk_idx >= 0
                        else cfg.vocab_size - 1)
        self.dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                      else torch.float32)
        rnn = cfg.rnn_size
        self.loc_fc = _seq(nn.Linear(5, cfg.loc_encoding_size))
        self.embed = _seq(nn.Embedding(cfg.vocab_size,
                                       cfg.input_encoding_size))
        self.vis_embed = _seq(nn.Embedding(cfg.detect_size + 1,
                                           cfg.vis_encoding_size))
        self.fc_embed = _seq(nn.Linear(cfg.fc_feat_size_full, rnn))
        self.seg_info_embed = _seq(nn.Linear(4, cfg.seg_info_size))
        self.att_embed = nn.ModuleList([
            _seq(nn.Linear(cfg.rgb_feat_size, rnn // 2)),
            _seq(nn.Linear(cfg.motion_feat_size, rnn // 2))])
        self.att_embed_aux = _seq(nn.BatchNorm1d(rnn))
        self.pool_embed = _seq(nn.Linear(cfg.pool_feat_size, rnn))
        self.ctx2att = nn.Linear(rnn, cfg.att_hid_size)
        self.ctx2pool = nn.Linear(rnn, cfg.att_hid_size)
        # logit width padded to vocab_pad_to (pad columns masked)
        self.logit = nn.Linear(rnn, cfg.vocab_size_padded)
        self.ctx2pool_grd = _seq(nn.Linear(cfg.att_feat_size,
                                           cfg.vis_encoding_size))
        self.context_enc = BiRNNParams(rnn, rnn // 2, 2, cfg.t_attn_mode)
        # model-level grounder head (model.py:55-58), sized by the
        # embeddings it scores
        if cfg.region_attn_mode == "add":
            self.alpha_net = nn.Linear(cfg.vis_encoding_size, 1)
        elif cfg.region_attn_mode == "cat":
            self.alpha_net = nn.Linear(2 * cfg.vis_encoding_size, 1)
        if cfg.transfer_mode in ("cls", "both"):
            self.vis_classifiers_bias = nn.Parameter(
                torch.zeros(cfg.detect_size + 1))
        self.core = TopDownCore(cfg)
        if cfg.obj_interact:
            # 2 layers, 6 heads, d_hidden = rnn/2 (model.py:126-135)
            self.obj_interact = xf.ObjInteract(rnn, rnn // 2, 2)

    # ------------------------------------------------------------------ #
    # init: the JAX package's distributions, from an explicit generator
    # ------------------------------------------------------------------ #

    def init(self, generator: torch.Generator) -> "GVDModel":
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)
            elif isinstance(m, nn.Embedding):
                init_embedding_(m, generator)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
            elif isinstance(m, (LSTMCellParams, BiRNNParams,
                                xf.Encoder)):
                m.reset_parameters(generator)
        if hasattr(self, "vis_classifiers_bias"):
            with torch.no_grad():
                self.vis_classifiers_bias.zero_()
        return self

    # ------------------------------------------------------------------ #
    # shared encode path (model.py:302-409 / 504-568), inference
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def encode(self, batch: Dict[str, torch.Tensor]) -> Dict:
        cfg, dt = self.cfg, self.dtype
        segs_feat = batch["seg_feat"].to(dt)                  # (B, T, F)
        ppls = batch["ppls"].float()                          # (B, R, 7)
        ppls_feat = batch["ppls_feat"].to(dt)                 # (B, R, 2048)
        num = batch["num"].to(dt)                             # (B, 7)
        sample_idx = batch["sample_idx"].long()               # (B, 2)
        pnt_mask = batch["pnt_mask"].bool()                   # (B, R+1)
        B, R = ppls.shape[:2]
        drop = cfg.drop_prob_lm

        # fc feature: mean frame feat (LN) ++ segment-position info (LN)
        fc_raw = segs_feat.mean(dim=1)
        seg_info = F.relu(_lin(self.seg_info_embed[0], num[:, 3:7]))
        seg_info = dropout(seg_info, drop, train=False)
        fc_feats = torch.cat([layer_norm(fc_raw), layer_norm(seg_info)],
                             dim=-1)

        # region features through the (transferred) fc7 layer
        g_pool_feats = F.relu(_lin(self.ctx2pool_grd[0], ppls_feat))
        g_pool_feats = dropout(g_pool_feats, drop, train=False)

        # visual-word embeddings for all classes (model.py:321-326)
        vis_word_embed = F.relu(self.vis_embed[0].weight)
        vis_word_embed = dropout(vis_word_embed, drop, train=False).to(dt)
        p_vis_word = vis_word_embed[None].expand(
            (B,) + tuple(vis_word_embed.shape))

        bias = None
        if hasattr(self, "vis_classifiers_bias"):
            bias = self.vis_classifiers_bias[None, :, None].expand(
                B, cfg.detect_size + 1, R)
        sim_logits = grounder(
            p_vis_word, g_pool_feats, pnt_mask[:, 1:], bias,
            alpha_net=(self.alpha_net if self.grounder_additive else None),
            additive_cat=cfg.region_attn_mode == "cat")
        sim_mat_static = torch.softmax(sim_logits.float(), dim=1)

        if not cfg.enable_BUTD:
            loc_input = torch.cat(
                [ppls[:, :, :4] / 720.0,
                 ppls[:, :, 4:5] / cfg.num_sampled_frm], dim=-1).to(dt)
            loc_feats = F.relu(_lin(self.loc_fc[0], loc_input))
            loc_feats = dropout(loc_feats, cfg.loc_drop, train=False)
            label_feat = sim_mat_static.transpose(1, 2).to(dt)  # (B,R,C+1)
            # pool_embed(concat(LN(g), LN(loc), LN(label))) as three
            # column-block products: the (B, R, 2780) concat never exists
            pe = self.pool_embed[0]
            w = pe.weight.to(dt)
            d1 = g_pool_feats.shape[-1]
            d2 = d1 + loc_feats.shape[-1]
            pool_pre = (F.linear(layer_norm(g_pool_feats), w[:, :d1])
                        + F.linear(layer_norm(loc_feats), w[:, d1:d2])
                        + F.linear(layer_norm(label_feat), w[:, d2:]))
            pool_feats = F.relu(pool_pre + pe.bias.to(dt))
        else:
            pool_feats = F.relu(_lin(self.pool_embed[0], g_pool_feats))

        fc_emb = F.relu(_lin(self.fc_embed[0], fc_feats))
        fc_emb = dropout(fc_emb, drop, train=False)
        pool_feats = dropout(pool_feats, drop, train=False)

        if cfg.obj_interact:
            pool_feats = xf.encoder_apply(
                self.obj_interact.encoder, pool_feats, n_heads=6,
                use_kernel=cfg.use_pallas_encoder)[-1]

        p_pool_feats = _lin(self.ctx2pool, pool_feats)

        if cfg.att_input_mode in ("both", "featmap"):
            rgb = segs_feat[:, :, :cfg.rgb_feat_size]
            motion = segs_feat[:, :, cfg.rgb_feat_size:]
            conv = torch.cat([
                dropout(F.relu(_lin(self.att_embed[0][0], rgb)), drop,
                        train=False),
                dropout(F.relu(_lin(self.att_embed[1][0], motion)), drop,
                        train=False)], dim=-1)
            conv = F.relu(batch_norm(self.att_embed_aux[0], conv))
            conv = birnn(self.context_enc, conv,
                         use_kernel=cfg.use_pallas_rnn)
            # zero frames outside the segment window (model.py:303-305)
            t_ids = torch.arange(cfg.t_attn_size,
                                 device=conv.device)[None, :]
            inside = ((t_ids >= sample_idx[:, :1])
                      & (t_ids < sample_idx[:, 1:2]))        # (B, T)
            conv_feats = conv.masked_fill(~inside[..., None], 0.0)
            p_conv_feats = _lin(self.ctx2att, conv_feats)
        else:
            conv_feats = torch.zeros((B, 1, cfg.rnn_size), dtype=dt,
                                     device=ppls.device)
            p_conv_feats = torch.zeros((B, 1, cfg.att_hid_size), dtype=dt,
                                       device=ppls.device)

        return {
            "fc_feats": fc_emb,
            "conv_feats": conv_feats,
            "p_conv_feats": p_conv_feats,
            "pool_feats": pool_feats,
            "p_pool_feats": p_pool_feats,
            "g_pool_feats": g_pool_feats,
            "sim_mat_static": sim_mat_static,       # class-softmaxed
            "sim_logits": sim_logits,               # pre-softmax
            "pnt_mask": pnt_mask,
        }

    # ------------------------------------------------------------------ #
    # TopDown core step (AttModel.py:134-164)
    # ------------------------------------------------------------------ #

    def core_step(self, xt, fc_feats, conv_feats, p_conv_feats, pool_feats,
                  p_pool_feats, att_mask, pnt_mask, state: CoreState):
        cfg, core = self.cfg, self.core
        att_in = torch.cat([fc_feats, xt], dim=1)
        h_att, (h_att_, c_att) = lstm_cell(
            core.att_lstm, att_in, (state.h_att, state.c_att))

        if cfg.att_input_mode != "region":
            att = temporal_attention(core.attention, h_att, conv_feats,
                                     p_conv_feats)
        att2, att2_weight, att_h = region_attention(
            core.attention2, h_att, pool_feats, p_pool_feats,
            att_mask[:, 1:], pnt_mask[:, 1:], mode=cfg.region_attn_mode,
            use_kernel=cfg.use_pallas)

        if cfg.att_input_mode == "both":
            lang_in = att + att2
        elif cfg.att_input_mode == "featmap":
            lang_in = att
        elif cfg.att_input_mode == "region":
            lang_in = att2
        else:                                   # dual_region
            att2_dual, _, _ = region_attention(
                core.attention2_dual, h_att, pool_feats, p_pool_feats,
                att_mask[:, 1:], pnt_mask[:, 1:], mode=cfg.region_attn_mode,
                use_kernel=cfg.use_pallas)
            dual_p = torch.sigmoid(_lin(core.dual_pointer[0], h_att))
            lang_in = dual_p * att2 + (1.0 - dual_p) * att2_dual

        lang_lstm_in = torch.cat([lang_in, h_att], dim=1)
        h_lang, (h_lang_, c_lang) = lstm_cell(
            core.lang_lstm, lang_lstm_in, (state.h_lang, state.c_lang))
        output = dropout(h_lang, cfg.drop_prob_lm, train=False)
        return output, CoreState(h_att_, c_att, h_lang_, c_lang), \
            att2_weight, att_h

    def init_state(self, batch_size: int, device) -> CoreState:
        z = torch.zeros((batch_size, self.cfg.rnn_size), dtype=self.dtype,
                        device=device)
        return CoreState(z, z, z, z)

    # ------------------------------------------------------------------ #
    # embeddings and the vocab head
    # ------------------------------------------------------------------ #

    def embed_words(self, ids: torch.Tensor) -> torch.Tensor:
        x = F.relu(embedding(self.embed[0].weight, ids))
        return dropout(x, self.cfg.drop_prob_lm, train=False).to(self.dtype)

    def logit_logprobs(self, x: torch.Tensor) -> torch.Tensor:
        """Vocab log-probabilities; pad columns of the padded logit head
        are forced to MIN_VALUE before the log_softmax and sliced away
        (model.py:464, 612)."""
        V, Vp = self.cfg.vocab_size, self.cfg.vocab_size_padded
        logits = _lin(self.logit, x).float()
        if Vp > V:
            logits[..., V:] = MIN_VALUE
        lp = torch.log_softmax(logits, dim=-1)
        return lp[..., :V] if Vp > V else lp

    # ------------------------------------------------------------------ #
    # greedy sampling (model.py:492-624)
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def sample_greedy(self, batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, ...]:
        """UNK-suppressed greedy decode.  Returns (seq (B, L) int32,
        seqLogprobs (B, L) f32, att2_weights (B, L, R) — the pnt-masked
        region logits of each step — and sim_mat_static (B, C+1, R))."""
        cfg = self.cfg
        enc = self.encode(batch)
        pnt_mask = enc["pnt_mask"]
        B = pnt_mask.shape[0]
        dev = pnt_mask.device
        state = self.init_state(B, dev)
        tok = torch.zeros((B,), dtype=torch.long, device=dev)
        toks, lps, att2s = [], [], []
        for _ in range(cfg.seq_length):
            xt = self.embed_words(tok)
            out, state, att2_w, _ = self.core_step(
                xt, enc["fc_feats"], enc["conv_feats"], enc["p_conv_feats"],
                enc["pool_feats"], enc["p_pool_feats"], pnt_mask, pnt_mask,
                state)
            logprobs = self.logit_logprobs(out)
            # UNK-suppressed argmax (model.py:589-594): two argmaxes,
            # ties go to the first index
            i1 = logprobs.argmax(dim=1)
            v1 = logprobs.gather(1, i1[:, None])[:, 0]
            masked = logprobs.scatter(1, i1[:, None], MIN_VALUE)
            i2 = masked.argmax(dim=1)
            v2 = masked.gather(1, i2[:, None])[:, 0]
            use_first = i1 != self.unk_idx
            tok = torch.where(use_first, i1, i2)
            toks.append(tok)
            lps.append(torch.where(use_first, v1, v2))
            att2s.append(att2_w)
        seq = torch.stack(toks, dim=1).to(torch.int32)
        return (seq, torch.stack(lps, dim=1), torch.stack(att2s, dim=1),
                enc["sim_mat_static"])


def batch_to_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A numpy batch of ``data.synthetic_batch`` / the dataset as tensors
    on ``device`` (the string ``seg_id`` column is dropped)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if k != "seg_id"}
