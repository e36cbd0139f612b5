"""The Grounded-Video-Description model, PyTorch port: greedy captioning
and the teacher-forced forward of training and grounding.

Counterpart of ``grounded_video_description_tpu/models/gvd.py``: the
encode path (model.py:302-409 / 504-568), the TopDown core
(AttModel.py:134-164), the MLE forward with its four losses and the GRD
forward (model.py:283-489), greedy UNK-suppressed sampling
(model.py:492-624) and batched beam search (``models/beam.py``, reference
misc/CaptionModelBU.py).  With ``att_model`` "transformer" the caption
model is the Masked-Transformer decoder of ``models/transformer.py``
(model.py:411-419, 570-578): its LM loss alone in training, its argmax
greedy decode at inference, over the same encode.  With ``att_model``
"lm" it is the language model of ``models/lm.py`` (its ``lm`` block):
the frame and region encodings through its projector as visual tokens,
a prefill and greedy steps through its latent cache; it has no TopDown
core, word embedding or logit head, and no training forward.
``quantize_banks`` decodes greedily over int8 attention banks
(``ops/quantize.py``).

Parameters are float32 and named after the reference state dict, so
``engine/checkpoint.py::import_torch_checkpoint`` of the JAX package
reads a port ``state_dict()`` as it is.  Activations run in
``cfg.dtype``; weights are cast where they are used, as in the JAX
package.  Config flags select the hand-written kernels: at inference
``use_pallas_encoder`` (K1, the obj_interact layer), ``use_pallas_mha``
(K7, the obj_interact self-attention when K1 is off), ``use_pallas`` (K3,
the per-token region attention) and ``use_pallas_decode`` (K6, the whole
greedy decode), which have no backward and are off in training; in
training ``use_pallas_encoder_train`` (K5, the whole obj_interact layer),
else ``attn_train_impl`` (K4, the obj_interact attention); in both
``use_pallas_rnn`` (K2, the BiRNN recurrence: in training its route with
a backward kernel).  A kernel wrapper
runs its plain version on CPU tensors.  The config is the port's own
(``config.py``), field for field a subset of the JAX package's.

Training draws every dropout mask from one ``torch.Generator`` on the
model's device, passed down explicitly; without one, dropout is the
identity, as the JAX package's is without an rng.  A data-parallel rank
passes a ``parallel.RowShard`` instead: the generator every rank shares,
its rows of the microbatch and the group that BatchNorm's statistics are
summed over.  On a model-axis rank (``parallel/tensor.py``) the model
holds its slice of the vocab head and of the visual-word table, and the
forward gathers them whole where it uses them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from grounded_video_description_torch import losses as L
from grounded_video_description_torch.config import GVDConfig
from grounded_video_description_torch.data import staging
from grounded_video_description_torch.models import lm as lm_model
from grounded_video_description_torch.models import transformer as xf
from grounded_video_description_torch.models.beam import beam_search
from grounded_video_description_torch.nn import (
    BiRNNParams, LSTMCellParams, batch_norm, batch_norm_train, birnn,
    dropout, embedding, init_embedding_, init_linear_, layer_norm, linear,
    lstm_cell,
)
from grounded_video_description_torch.ops import (
    MIN_VALUE, grounder, region_attention, region_attention_beam,
    temporal_attention, temporal_attention_beam,
)
from grounded_video_description_torch.ops.geometry import (
    bbox_overlaps, bbox_target, sim_mat_target,
)
from grounded_video_description_torch.ops.kernels.decode_scan import (
    greedy_decode_fused, greedy_decode_fused_plain,
)
from grounded_video_description_torch.ops.quantize import (
    dequantize, quantize_rows,
)
from grounded_video_description_torch.parallel.mesh import (
    generator_of, group_of,
)
from grounded_video_description_torch.parallel.tensor import (
    head_logits, vis_embed_weight,
)
from grounded_video_description_torch.utils.logging import span


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
        captioner = cfg.att_model != "lm"
        self.loc_fc = _seq(nn.Linear(5, cfg.loc_encoding_size))
        if captioner:
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
        if captioner:
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
        if captioner:
            self.core = TopDownCore(cfg)
        if cfg.obj_interact:
            # 2 layers, 6 heads, d_hidden = rnn/2 (model.py:126-135)
            self.obj_interact = xf.ObjInteract(rnn, rnn // 2, 2)
        if cfg.att_model == "transformer":
            # 2 layers, 6 heads, d_hidden = rnn/2 (gvd.py:152-154)
            self.cap_model = xf.CaptionModel(rnn, rnn // 2, cfg.vocab_size,
                                             2)
        elif cfg.att_model == "lm":
            # 16 B parameters at the published size: build the model on
            # the meta device and load with ``assign=True``
            self.cap_model = lm_model.LanguageModel(cfg.lm, rnn)

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
        if self.cfg.att_model == "lm":
            self.cap_model.reset_parameters(generator)
        return self

    def set_bn_state(self, state: Optional[Dict[str, torch.Tensor]]):
        """Carry the BatchNorm statistics a training forward returned
        into the running buffers (a no-op for None)."""
        if state is None:
            return
        bn = self.att_embed_aux[0]
        with torch.no_grad():
            for name, value in state.items():
                getattr(bn, name).copy_(value)

    # ------------------------------------------------------------------ #
    # shared encode path (model.py:302-409 / 504-568)
    # ------------------------------------------------------------------ #

    def encode(self, batch: Dict[str, torch.Tensor], *, train: bool = False,
               generator: Optional[torch.Generator] = None) -> Dict:
        """The attention banks, under the ``encode`` span.  In training,
        dropout at every site of the JAX package's encode, BatchNorm on
        batch statistics (the new running statistics under "bn_state",
        None at eval), the BiRNN and the obj_interact encoder on their
        training paths."""
        with span("encode"):
            return self._encode(batch, train, generator)

    def _encode(self, batch: Dict[str, torch.Tensor], train: bool,
                generator: Optional[torch.Generator]) -> Dict:
        cfg, dt = self.cfg, self.dtype
        segs_feat = batch["seg_feat"].to(dt)                  # (B, T, F)
        ppls = batch["ppls"].float()                          # (B, R, 7)
        ppls_feat = batch["ppls_feat"].to(dt)                 # (B, R, 2048)
        num = batch["num"].to(dt)                             # (B, 7)
        sample_idx = batch["sample_idx"].long()               # (B, 2)
        pnt_mask = batch["pnt_mask"].bool()                   # (B, R+1)
        B, R = ppls.shape[:2]

        def drop(x, rate=cfg.drop_prob_lm):
            return dropout(x, rate, train=train, generator=generator)

        # fc feature: mean frame feat (LN) ++ segment-position info (LN)
        fc_raw = segs_feat.mean(dim=1)
        seg_info = drop(F.relu(_lin(self.seg_info_embed[0], num[:, 3:7])))
        fc_feats = torch.cat([layer_norm(fc_raw), layer_norm(seg_info)],
                             dim=-1)

        # region features through the (transferred) fc7 layer
        g_pool_feats = drop(F.relu(_lin(self.ctx2pool_grd[0], ppls_feat)))

        # visual-word embeddings for all classes (model.py:321-326)
        vis_word_embed = F.relu(vis_embed_weight(self))
        # one mask for the class table, which no row owns: every rank
        # draws it whole
        vis_word_embed = dropout(vis_word_embed, cfg.drop_prob_lm,
                                 train=train,
                                 generator=generator_of(generator)).to(dt)
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
            loc_feats = drop(loc_feats, cfg.loc_drop)
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

        fc_emb = drop(F.relu(_lin(self.fc_embed[0], fc_feats)))
        pool_feats = drop(pool_feats)

        if cfg.obj_interact:
            pool_feats = xf.encoder_apply(
                self.obj_interact.encoder, pool_feats, n_heads=6,
                use_kernel=cfg.use_pallas_encoder,
                use_mha=cfg.use_pallas_mha, train=train,
                drop=cfg.enc_drop, generator=generator,
                attn_train_impl=cfg.attn_train_impl,
                fused_train=cfg.use_pallas_encoder_train)[-1]

        p_pool_feats = _lin(self.ctx2pool, pool_feats)

        bn_state = None
        if cfg.att_input_mode in ("both", "featmap"):
            rgb = segs_feat[:, :, :cfg.rgb_feat_size]
            motion = segs_feat[:, :, cfg.rgb_feat_size:]
            conv = torch.cat([
                drop(F.relu(_lin(self.att_embed[0][0], rgb))),
                drop(F.relu(_lin(self.att_embed[1][0], motion)))], dim=-1)
            if train:
                conv, bn_state = batch_norm_train(
                    self.att_embed_aux[0], conv,
                    group=group_of(generator))
            else:
                conv = batch_norm(self.att_embed_aux[0], conv)
            conv = birnn(self.context_enc, F.relu(conv),
                         use_kernel=cfg.use_pallas_rnn, train=train,
                         drop=cfg.enc_drop, generator=generator)
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
            "bn_state": bn_state,
        }

    # ------------------------------------------------------------------ #
    # TopDown core step (AttModel.py:134-164)
    # ------------------------------------------------------------------ #

    def core_step(self, xt, fc_feats, conv_feats, p_conv_feats, pool_feats,
                  p_pool_feats, att_mask, pnt_mask, state: CoreState, *,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None):
        cfg, core = self.cfg, self.core
        use_k3 = cfg.use_pallas and not train     # K3 has no backward
        att_in = torch.cat([fc_feats, xt], dim=1)
        h_att, (h_att_, c_att) = lstm_cell(
            core.att_lstm, att_in, (state.h_att, state.c_att))

        if cfg.att_input_mode != "region":
            att = temporal_attention(core.attention, h_att, conv_feats,
                                     p_conv_feats)
        att2, att2_weight, att_h = region_attention(
            core.attention2, h_att, pool_feats, p_pool_feats,
            att_mask[:, 1:], pnt_mask[:, 1:], mode=cfg.region_attn_mode,
            use_kernel=use_k3)

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
                use_kernel=use_k3)
            dual_p = torch.sigmoid(_lin(core.dual_pointer[0], h_att))
            lang_in = dual_p * att2 + (1.0 - dual_p) * att2_dual

        lang_lstm_in = torch.cat([lang_in, h_att], dim=1)
        h_lang, (h_lang_, c_lang) = lstm_cell(
            core.lang_lstm, lang_lstm_in, (state.h_lang, state.c_lang))
        output = dropout(h_lang, cfg.drop_prob_lm, train=train,
                         generator=generator)
        return output, CoreState(h_att_, c_att, h_lang_, c_lang), \
            att2_weight, att_h

    def core_step_beam(self, xt, fc_feats, conv_feats, p_conv_feats,
                       pool_feats, p_pool_feats, pnt_mask,
                       state: CoreState, W: int):
        """TopDown core step for beam search with SHARED attention banks:
        the state is (B*W, ...) but the conv and pool banks stay (B, ...),
        where the reference tiles them W-fold (model.py:710-718).  As the
        JAX package's does, it passes ``pnt_mask`` as the attention mask
        too (at inference both are the same mask).  Returns (h_lang,
        state, att2 logits (B*W, R))."""
        cfg, core = self.cfg, self.core
        B = fc_feats.shape[0]
        fc_bw = fc_feats[:, None].expand(
            B, W, fc_feats.shape[-1]).reshape(B * W, -1)
        att_in = torch.cat([fc_bw, xt], dim=1)
        h_att, (h_att_, c_att) = lstm_cell(
            core.att_lstm, att_in, (state.h_att, state.c_att))
        h3 = h_att.view(B, W, -1)
        mask = pnt_mask[:, 1:]

        if cfg.att_input_mode != "region":
            att = temporal_attention_beam(core.attention, h3, conv_feats,
                                          p_conv_feats)
        att2, att2_w, _ = region_attention_beam(
            core.attention2, h3, pool_feats, p_pool_feats, mask, mask,
            mode=cfg.region_attn_mode)

        if cfg.att_input_mode == "both":
            lang_in = att + att2
        elif cfg.att_input_mode == "featmap":
            lang_in = att
        elif cfg.att_input_mode == "region":
            lang_in = att2
        else:                                   # dual_region
            att2_dual, _, _ = region_attention_beam(
                core.attention2_dual, h3, pool_feats, p_pool_feats, mask,
                mask, mode=cfg.region_attn_mode)
            dual_p = torch.sigmoid(_lin(core.dual_pointer[0], h3))
            lang_in = dual_p * att2 + (1.0 - dual_p) * att2_dual

        lang_lstm_in = torch.cat([lang_in.reshape(B * W, -1), h_att], dim=1)
        h_lang, (h_lang_, c_lang) = lstm_cell(
            core.lang_lstm, lang_lstm_in, (state.h_lang, state.c_lang))
        return h_lang, CoreState(h_att_, c_att, h_lang_, c_lang), \
            att2_w.reshape(B * W, -1)

    def _transformer_encodings(self, conv_feats, pool_feats):
        """What decoder layers 0 and 1 cross-attend (model.py:411-417)."""
        mode = self.cfg.att_input_mode
        if mode == "both":
            return [conv_feats, pool_feats]
        if mode == "featmap":
            return [conv_feats, conv_feats]
        return [pool_feats, pool_feats]

    def init_state(self, batch_size: int, device) -> CoreState:
        z = torch.zeros((batch_size, self.cfg.rnn_size), dtype=self.dtype,
                        device=device)
        return CoreState(z, z, z, z)

    # ------------------------------------------------------------------ #
    # embeddings and the vocab head
    # ------------------------------------------------------------------ #

    def embed_words(self, ids: torch.Tensor, *, train: bool = False,
                    generator: Optional[torch.Generator] = None):
        x = F.relu(embedding(self.embed[0].weight, ids))
        return dropout(x, self.cfg.drop_prob_lm, train=train,
                       generator=generator).to(self.dtype)

    def embed_vis_words(self, ids: torch.Tensor, *, train: bool = False,
                        generator: Optional[torch.Generator] = None):
        x = F.relu(embedding(vis_embed_weight(self), ids))
        return dropout(x, self.cfg.drop_prob_lm, train=train,
                       generator=generator).to(self.dtype)

    def logit_logprobs(self, x: torch.Tensor) -> torch.Tensor:
        """Vocab log-probabilities; pad columns of the padded logit head
        are forced to MIN_VALUE before the log_softmax and sliced away
        (model.py:464, 612).  A model-axis rank gathers its columns of
        the head whole first."""
        V, Vp = self.cfg.vocab_size, self.cfg.vocab_size_padded
        logits = head_logits(self, x, _lin).float()
        if Vp > V:
            # out of place: .float() of an f32 tensor is no copy
            pad = torch.arange(Vp, device=logits.device) >= V
            logits = logits.masked_fill(pad, MIN_VALUE)
        lp = torch.log_softmax(logits, dim=-1)
        return lp[..., :V] if Vp > V else lp

    # ------------------------------------------------------------------ #
    # MLE / GRD forward (model.py:283-489)
    # ------------------------------------------------------------------ #

    def supervision(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Parameter-free supervision of the MLE losses and their mask
        counts, from the batch alone (utils.py:293-328, model.py:342-355,
        436-440).  Gradient accumulation computes it once for the full
        batch and slices it per microbatch: the counts are the
        denominators of the count renormalization.

        Returns sim_target (B, K, R), roi_labels (sb, L, R), step_pnt
        (sb, L, R+1), and f32 txt/roi/cls counts (sb = B * seq_per_img).
        The transformer family has no box supervision: its counts alone,
        the txt count the non-pad targets that ``decoder_xe_loss``
        averages over, roi and cls counts 1."""
        cfg = self.cfg
        S, Lq = cfg.seq_per_img, cfg.seq_length
        gt_seq = batch["gt_seq"].long()
        B = gt_seq.shape[0]
        sb = B * S
        tgt = gt_seq[:, :S, :].reshape(sb, Lq)
        if cfg.att_model == "transformer":
            one = torch.ones((), device=gt_seq.device)
            return {"txt_count": (tgt > 0).sum().float(), "roi_count": one,
                    "cls_count": one}
        # the txt mask counts the END position: [1, tgt[:-1] > 0]
        txt_count = ((tgt[:, :Lq - 1] > 0).sum() + sb).float()
        gt_boxes = batch["gt_boxes"].float()
        mask_boxes = batch["mask_boxes"].bool()              # (B, S, K, L+1)
        frm_mask = batch["frm_mask"].bool()                  # (B, R, K)
        pnt_mask = batch["pnt_mask"].bool()                  # (B, R+1)
        overlaps = bbox_overlaps(batch["ppls"].float(), gt_boxes,
                                 frm_mask | pnt_mask[:, 1:, None])
        sim_target = sim_mat_target(overlaps, gt_boxes[:, :, 5])

        def expand(x):
            return x.repeat_interleave(S, dim=0) if S > 1 else x

        # ROI labels: the box mask of step t + 1 over every caption
        # (utils.py:307-328 via model.py:431-433)
        overlaps_sb = expand(overlaps)
        mb = mask_boxes.reshape(sb, -1, Lq + 1)             # (sb, K, L+1)
        roi_labels = torch.stack([bbox_target(mb[:, :, t + 1], overlaps_sb)
                                  for t in range(Lq)], dim=1)  # (sb, L, R)
        # proposals on no frame of the step's GT boxes (model.py:436-440),
        # from the FIRST caption's box mask (a reference quirk)
        bm0 = mask_boxes[:, 0, :, 1:]                         # (B, K, L)
        no_frame = torch.stack(
            [(~(bm0[:, None, :, t] | frm_mask)).sum(dim=2) <= 0
             for t in range(Lq)], dim=1)                      # (B, L, R)
        step_pnt = torch.cat(
            [torch.zeros_like(no_frame[:, :, :1]), no_frame], dim=2)
        step_pnt = step_pnt | pnt_mask[:, None, :]            # (B, L, R+1)
        return {"txt_count": txt_count,
                "roi_count": (roi_labels > 0).sum().float(),
                "cls_count": (sim_target > 0).sum().float(),
                "sim_target": sim_target, "roi_labels": roi_labels,
                "step_pnt": expand(step_pnt)}

    def batch_loss_counts(self, batch: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
        """The mask counts of the MLE losses (the scalars of
        ``supervision``)."""
        sup = self.supervision(batch)
        return {k: sup[k] for k in ("txt_count", "roi_count", "cls_count")}

    def forward(self, batch: Dict[str, torch.Tensor], *, mode: str = "MLE",
                train: bool = True,
                generator: Optional[torch.Generator] = None,
                sup: Optional[Dict[str, torch.Tensor]] = None):
        """Teacher-forced pass over the first seq_per_img GT captions.

        mode "MLE": returns (losses, bn_state): the four losses and their
        mask counts, and the BatchNorm statistics after this batch (None
        at eval or without the temporal encoder; ``set_bn_state`` carries
        them).  ``sup``: ``supervision(batch)``, or the slice of the full
        batch's that gradient accumulation passes.
        mode "GRD": grounding on GT sentences at eval, without gradients:
        returns sim_target, pred_cls (B, R) and the per-frame argmaxes
        att2_ind / grd_ind (sb, L, num_sampled_frm).

        With att_model "transformer", MLE is the decoder's LM loss alone
        (the other three 0, roi and cls counts 1); GRD, which grounds
        through the TopDown core's attention, raises."""
        if mode not in ("MLE", "GRD"):
            raise ValueError(f"unknown mode {mode!r}")
        if self.cfg.att_model == "lm":
            raise ValueError("att_model lm captions at inference only: it "
                             "has no training or grounding forward")
        if self.cfg.att_model == "transformer":
            if mode == "GRD":
                raise ValueError("mode GRD grounds through the TopDown "
                                 "core's region attention; att_model "
                                 "transformer has none")
            return self._transformer_lm(batch, train=train,
                                        generator=generator)
        if mode == "GRD":
            with torch.no_grad():
                return self._teacher_forced(batch, grd=True, train=False,
                                            generator=None, sup=sup)
        return self._teacher_forced(batch, grd=False, train=train,
                                    generator=generator, sup=sup)

    def _transformer_lm(self, batch, *, train: bool, generator):
        """The Masked-Transformer family's MLE forward (gvd.py:638-655 of
        the JAX package): the decoder's cross-entropy over the first
        seq_per_img captions at dropout ``enc_drop``; txt_count is its
        exact denominator, so count renormalization holds."""
        cfg = self.cfg
        S, Lq = cfg.seq_per_img, cfg.seq_length
        gt_seq = batch["gt_seq"].long()
        sb = gt_seq.shape[0] * S
        seq = torch.cat([torch.zeros((sb, 1), dtype=torch.long,
                                     device=gt_seq.device),
                         gt_seq[:, :S, :].reshape(sb, Lq)], dim=1)
        enc = self.encode(batch, train=train, generator=generator)

        def expand(x):
            return x.repeat_interleave(S, dim=0) if S > 1 else x

        lm_loss = xf.decoder_xe_loss(
            self.cap_model.decoder, self._transformer_encodings(
                expand(enc["conv_feats"]), expand(enc["pool_feats"])),
            seq, n_heads=6, drop=cfg.enc_drop, train=train,
            generator=generator)
        zero = torch.zeros((), device=seq.device)
        one = torch.ones((), device=seq.device)
        return ({"lm_loss": lm_loss, "att2_loss": zero, "ground_loss": zero,
                 "cls_loss": zero, "txt_count": (seq[:, 1:] > 0).sum().float(),
                 "roi_count": one, "cls_count": one}, enc["bn_state"])

    def _teacher_forced(self, batch, *, grd: bool, train: bool, generator,
                        sup):
        cfg = self.cfg
        S, Lq = cfg.seq_per_img, cfg.seq_length
        if sup is None:
            sup = self.supervision(batch)
        gt_seq = batch["gt_seq"].long()                       # (B, 10, L)
        B = gt_seq.shape[0]
        sb = B * S
        dev = gt_seq.device
        seq = torch.cat([torch.zeros((sb, 1), dtype=torch.long, device=dev),
                         gt_seq[:, :S, :].reshape(sb, Lq)], dim=1)
        iseq = batch["input_seq"].long().reshape(sb, Lq + 1, 4)

        enc = self.encode(batch, train=train, generator=generator)

        def expand(x):
            return x.repeat_interleave(S, dim=0) if S > 1 else x

        fc_feats, conv_feats, p_conv_feats, pool_feats, p_pool_feats, \
            g_pool_feats, pnt_mask = (expand(enc[k]) for k in (
                "fc_feats", "conv_feats", "p_conv_feats", "pool_feats",
                "p_pool_feats", "g_pool_feats", "pnt_mask"))
        # per-step pnt mask: proposals off the step's frames are masked
        # too in MLE; GRD masks the padded proposals only
        step_pnt = (pnt_mask[:, None].expand(sb, Lq, pnt_mask.shape[1])
                    if grd else sup["step_pnt"])              # (sb, L, R+1)

        # the decode steps (model.py:421-453)
        xt_all = self.embed_words(seq[:, :Lq], train=train,
                                  generator=generator)        # (sb, L, E)
        state = self.init_state(sb, dev)
        outs, att2s = [], []
        for xt, step_mask in zip(xt_all.unbind(1), step_pnt.unbind(1)):
            out, state, att2_w, _ = self.core_step(
                xt, fc_feats, conv_feats, p_conv_feats, pool_feats,
                p_pool_feats, pnt_mask, step_mask, state, train=train,
                generator=generator)
            outs.append(out)
            att2s.append(att2_w)
        att2_weights = torch.stack(att2s, dim=1)              # (sb, L, R)
        decoded = self.logit_logprobs(torch.stack(outs, dim=1))

        # grounding scorer over the target's visual words (model.py:467-480)
        xt_clamp = (iseq[:, 1:Lq + 1, 0] - cfg.vocab_size).clamp_min(0)
        xt_vis = self.embed_vis_words(xt_clamp, train=train,
                                      generator=generator)
        g_bias = (self.vis_classifiers_bias[xt_clamp][..., None]
                  if hasattr(self, "vis_classifiers_bias") else 0.0)
        ground_weights = grounder(
            xt_vis, g_pool_feats,
            pnt_mask[:, 1:] if grd else step_pnt[:, :, 1:],
            g_bias + att2_weights,
            alpha_net=(self.alpha_net if self.grounder_additive else None),
            additive_cat=cfg.region_attn_mode == "cat")

        if grd:
            # per-frame argmax over proposals (model.py:487-489)
            frames = (sb, Lq, cfg.num_sampled_frm, cfg.num_prop_per_frm)
            return {"sim_target": sup["sim_target"],
                    "pred_cls": enc["sim_mat_static"].argmax(dim=1),
                    "att2_ind": att2_weights.reshape(frames).argmax(dim=-1),
                    "grd_ind": ground_weights.reshape(frames).argmax(dim=-1)}
        cls_loss, cls_count = L.cls_criterion_with_counts(
            enc["sim_mat_static"], sup["sim_target"])
        lm_loss, att2_loss, ground_loss, txt_count, roi_count = \
            L.lm_criterion_with_counts(decoded, att2_weights, ground_weights,
                                       seq[:, 1:Lq + 1], sup["roi_labels"])
        return ({"lm_loss": lm_loss, "att2_loss": att2_loss,
                 "ground_loss": ground_loss, "cls_loss": cls_loss,
                 "txt_count": txt_count, "roi_count": roi_count,
                 "cls_count": cls_count}, enc["bn_state"])

    # ------------------------------------------------------------------ #
    # greedy sampling (model.py:492-624)
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def sample_greedy(self, batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, ...]:
        """UNK-suppressed greedy decode.  Returns (seq (B, L) int32,
        seqLogprobs (B, L) f32, att2_weights (B, L, R) — the pnt-masked
        region logits of each step, in the compute dtype — and
        sim_mat_static (B, C+1, R)).

        With ``use_pallas_decode``, ``att_input_mode`` both and
        ``region_attn_mode`` add or mix, the decode is one K6 launch
        (``greedy_decode_fused``; any batch size, where the TPU kernel's
        tile needed B % 4 == 0); otherwise the step loop
        ``greedy_decode_fused_plain``.  Both give the same outputs,
        dtypes and shapes.

        With ``quantize_banks`` the four attention banks are quantized to
        int8 (gvd.py:788-795 of the JAX package) and dequantized once into
        the compute dtype, and the step loop decodes over them (K3 inside
        it where ``use_pallas`` asks), not K6 (gvd.py:812).

        With att_model "transformer" the decoder's argmax greedy decode
        over the encodings (gvd.py:799-807): seq, zero f32 logprobs, zero
        f32 att2 (B, L, max_proposal) and sim_mat_static.  With att_model
        "lm" the language model's greedy decode over the same encodings
        (``LanguageModel.greedy``: spans ``lm_prefill`` and ``lm_decode``):
        seq (ids of its vocabulary, int32), the served words' f32
        log-probabilities, zero f32 att2 and sim_mat_static.

        All after ``encode`` is the ``decode`` span."""
        cfg = self.cfg
        enc = self.encode(batch)
        with span("decode"):
            return self._decode_greedy(enc)

    def _decode_greedy(self, enc: Dict) -> Tuple[torch.Tensor, ...]:
        cfg = self.cfg
        pnt_mask = enc["pnt_mask"]
        if cfg.att_model == "transformer":
            seq = xf.decoder_greedy(
                self.cap_model.decoder, self._transformer_encodings(
                    enc["conv_feats"], enc["pool_feats"]),
                cfg.seq_length, n_heads=6)
            B, L, dev = seq.shape[0], cfg.seq_length, seq.device
            return (seq, torch.zeros((B, L), device=dev),
                    torch.zeros((B, L, cfg.max_proposal), device=dev),
                    enc["sim_mat_static"])
        if cfg.att_model == "lm":
            seq, seq_lp = self.cap_model.greedy(self._transformer_encodings(
                enc["conv_feats"], enc["pool_feats"]), cfg.seq_length)
            B, L, dev = seq.shape[0], cfg.seq_length, seq.device
            return (seq, seq_lp,
                    torch.zeros((B, L, cfg.max_proposal), device=dev),
                    enc["sim_mat_static"])
        if cfg.quantize_banks:
            for k in ("pool_feats", "p_pool_feats", "conv_feats",
                      "p_conv_feats"):
                enc[k] = dequantize(quantize_rows(
                    enc[k], cfg.quantize_group_size), self.dtype)
        decode = (greedy_decode_fused
                  if (cfg.use_pallas_decode and not cfg.quantize_banks
                      and cfg.att_input_mode == "both"
                      and cfg.region_attn_mode in ("add", "mix"))
                  else greedy_decode_fused_plain)
        seq, seq_lp, att2 = decode(self, enc, pnt_mask)
        return seq, seq_lp, att2, enc["sim_mat_static"]

    @torch.no_grad()
    def sample_beam(self, batch: Dict[str, torch.Tensor], *,
                    beam_size: int) -> Tuple[torch.Tensor, ...]:
        """Batched beam search (``models/beam.py::beam_search``) over the
        banks of one encode.  Returns (seq (B, L) int32, seq_logprobs (B,
        L) f32, att2_ind (B, L) int32, att2_frm_ind (B, L,
        num_sampled_frm) int32).  The TopDown family only; the search is
        the ``decode`` span."""
        if self.cfg.att_model != "topdown":
            raise ValueError("beam search decodes with the TopDown core; "
                             f"att_model {self.cfg.att_model!r} decodes "
                             "greedily")
        enc = self.encode(batch)
        with span("decode"):
            return beam_search(self, enc, beam_size=beam_size)


def batch_to_tensors(batch: Dict, device,
                     dtypes: Optional[Dict[str, torch.dtype]] = None
                     ) -> Dict[str, torch.Tensor]:
    """A numpy batch of ``data.synthetic_batch`` / the dataset as tensors
    on ``device`` (the string ``seg_id`` column is dropped), each cast to
    its entry of ``dtypes`` where it has one.  To a CUDA device the batch
    goes through the device's pinned staging ring
    (``data/staging.py``): views of one device buffer, filled by chunked
    DMAs that overlap the host's staging of the next chunk, ordered before
    the kernels queued after them on the current stream.  To the CPU it
    takes ``Tensor.to``."""
    return staging.to_device(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in batch.items() if k != "seg_id"}, device, dtypes)
