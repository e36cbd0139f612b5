"""Evaluation entry point of the port.

The port's copy of ``grounded_video_description_tpu/engine/evaluator.py``
(reference: main.py:314-517 ``eval`` and main.py:89-194
``eval_grounding``) and of ``main.py::grounding_eval_cfg``: greedy or
beam caption generation over the validation batches, the densecap
submission JSON and its language metrics, localization on generated
sentences (lemma-mapped words -> detection classes) and on GT sentences
(attention and grounding argmax boxes, region-cls accuracy).  The JSON
writers, the lemma mapping, the per-frame argmax reshape and the
cls-accuracy aggregation are the JAX package's line for line, so the
files come out byte-identical on the same model outputs
(tests/test_torch_eval.py).

Batches are the numpy dicts of the dataset loader; ``generate`` moves
each to the model's device and calls ``GVDModel.sample_greedy`` or
``GVDModel.forward(mode="GRD")`` directly (PyTorch runs eagerly: there is
nothing to jit); ``beam_size > 1`` takes ``GVDModel.sample_beam``, whose
per-frame argmaxes of the best beam ground the generated words.  The
transformer family's greedy decode returns zero region logits, so its
generated words ground on proposal 0 of each frame, as in the JAX
evaluator; so do the language-model captioner's (``att_model`` "lm"),
whose ``seq`` holds ids of its own vocabulary (up to 163839 at the
published size) in the same int32 arrays.  The model
holds its weights, so unlike the JAX evaluator no ``variables`` are
passed.  Under ``vis_attn`` the greedy decode's attention is drawn over
the frames under ``image_path`` (``utils/visualize.py``).

With a ``Mesh`` (the batch-parallel decode of the JAX evaluator's mesh,
evaluator.py:37-51, 263-266) every rank holds the whole batch and runs
the model on its share of the rows (``parallel.split_rows``, over all D x
M ranks); the outputs are gathered to rank 0 as host arrays, and rank 0
alone writes the JSONs and scores them, then broadcasts the scores so
that every rank sees the same ones.  On a model axis each ``evaluate``
and ``eval_grounding_gt`` first gathers the split vocab head and
visual-word table once (``parallel.whole_model``), so every rank decodes
with the whole model, K6 included.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from grounded_video_description_torch.config import GVDConfig
from grounded_video_description_torch.data import staging
from grounded_video_description_torch.data.vocab import decode_sequence
from grounded_video_description_torch.models.gvd import (
    GVDModel, batch_to_tensors)
from grounded_video_description_torch.parallel.mesh import (
    Mesh, broadcast_object, gather_rows, split_rows)
from grounded_video_description_torch.parallel.tensor import whole_model
from grounded_video_description_torch.utils.logging import span

EXTERNAL_DATA = {"used": True, "details": "Object detector pre-trained on "
                 "Visual Genome on object detection task."}


def grounding_eval_cfg(cfg: GVDConfig) -> GVDConfig:
    """The config the EVALUATOR should run with (``main.py::
    grounding_eval_cfg``): with ``pallas_encoder_grounding_guard`` on and
    a grounding eval active, K1 is off, because grounding metrics consume
    region-attention argmaxes that a reordered encoder moves (the JAX
    package measured -13% relative box_accu_att from its bf16 kernel,
    GROUNDING_KERNEL_DELTA.json).  Returns ``cfg`` itself when no gating
    applies."""
    if (cfg.pallas_encoder_grounding_guard and cfg.use_pallas_encoder
            and (cfg.eval_obj_grounding or cfg.eval_obj_grounding_gt)):
        return cfg.replace(use_pallas_encoder=False)
    return cfg


class Evaluator:
    def __init__(self, cfg: GVDConfig, model: GVDModel, vocab,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.model = model
        self.vocab = vocab
        self.mesh = mesh
        self.writer = mesh is None or mesh.writer
        # what decodes: the model, or on a model axis the whole model,
        # gathered at the start of each evaluation and at the first
        # ``generate`` / ``ground`` before one
        self.decoder = None

    def _gather_model(self):
        self.decoder = whole_model(self.model)

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _sharded(self, fn, arrays) -> Dict[str, np.ndarray]:
        """``fn`` of the batch ``arrays``: on one device, of all of it;
        with a mesh, each rank's of its rows, gathered on rank 0 (None on
        the others)."""
        if self.mesh is None:
            return fn(arrays)
        rows = split_rows(len(arrays["seg_feat"]), self.mesh.rank,
                          self.mesh.world)
        mine = ({k: v[rows] for k, v in arrays.items()}
                if rows.stop > rows.start else None)
        return gather_rows(self.mesh, fn(mine) if mine else None)

    def _shared(self, stats: Optional[Dict]) -> Dict:
        """Rank 0's scores on every rank."""
        if self.mesh is None:
            return stats
        return broadcast_object(self.mesh, stats)

    # ------------------------------------------------------------------ #

    def generate(self, batch_arrays) -> Optional[Dict[str, np.ndarray]]:
        """The decode of one batch of host arrays, as host arrays (with a
        mesh, on rank 0; None on the others)."""
        if self.decoder is None:
            self._gather_model()
        return self._sharded(self._generate, batch_arrays)

    def _generate(self, batch_arrays) -> Dict[str, np.ndarray]:
        """One batch under the ``generate`` span: the copy in (``h2d``),
        the model's ``encode`` and ``decode``, the copies back (``d2h``).
        On a CUDA device both copies go through the device's pinned
        staging ring (``data/staging.py``): in, chunked DMAs into views of
        one device buffer, each overlapping the host's staging of the
        next; back, chunked DMAs into the ring, each copied out into
        fresh host arrays (bf16 as f32) while the next is in flight."""
        with span("generate"):
            batch = self._to_device(batch_arrays)
            if self.cfg.beam_size > 1:
                names = ("seq", "logprobs", "att2_ind", "att2_frm_ind")
                out = self.decoder.sample_beam(
                    batch, beam_size=self.cfg.beam_size)
            else:
                names = ("seq", "logprobs", "att2_weights", "sim_mat")
                out = self.decoder.sample_greedy(batch)
            return self._to_host(names, out)

    def _to_device(self, arrays) -> Dict[str, torch.Tensor]:
        """``batch_to_tensors`` to the model's device, under the ``h2d``
        span with the host arrays' bytes."""
        with span("h2d", nbytes=lambda: sum(
                np.asarray(v).nbytes for k, v in arrays.items()
                if k != "seg_id")):
            return batch_to_tensors(arrays, self._device())

    @staticmethod
    def _to_host(names, tensors) -> Dict[str, np.ndarray]:
        """``tensors`` as host arrays by ``names`` (bf16 as f32, which
        keeps every value and argmax), under the ``d2h`` span with their
        bytes."""
        host: Dict[str, np.ndarray] = {}
        with span("d2h", nbytes=lambda: sum(
                a.nbytes for a in host.values())):
            host.update(zip(names, staging.to_host(
                [t for _, t in zip(names, tensors)])))
        return host

    # ------------------------------------------------------------------ #

    def evaluate(self, loader, *, epoch: int = 0,
                 out_dir: str = ".") -> Dict[str, float]:
        """Generated-sentence eval: captions (+ language metrics) and
        grounding on generated words (main.py:314-467)."""
        cfg = self.cfg
        self._gather_model()
        if self.writer:
            os.makedirs(os.path.join(out_dir, "densecap_results"),
                        exist_ok=True)
            os.makedirs(os.path.join(out_dir, "results"), exist_ok=True)
            with open(cfg.grd_reference) as f:
                timestamp_file = json.load(f)

        predictions = defaultdict(list)
        grd_output: Dict = defaultdict(dict)
        lemma_det_dict = {self.vocab.wtol[k]: i
                          for k, i in self.vocab.wtod.items()
                          if k in self.vocab.wtol}

        n_caps = 0
        t0 = time.time()
        for batch in loader:
            # optional cap on evaluated segments (opts.py:142-143)
            if 0 < cfg.val_images_use <= n_caps:
                break
            n_valid = batch.get("n_valid", len(batch["seg_id"]))
            seg_ids = batch["seg_id"][:n_valid]
            arrays = {k: v for k, v in batch.items()
                      if k not in ("seg_id", "n_valid")}
            out = self.generate(arrays)
            n_caps += n_valid
            if not self.writer:
                continue
            seq = out["seq"][:n_valid]

            if cfg.eval_obj_grounding:
                # per-frame argmax box per generated word
                # (main.py:361-384).  The reference hard-asserts
                # beam_size == 1 here (main.py:362); the beam carries the
                # best beam's per-frame argmaxes, so every decode mode
                # grounds its words.
                if "att2_frm_ind" in out:
                    att2_ind = out["att2_frm_ind"][:n_valid]
                else:
                    att2_ind = out["att2_weights"][:n_valid].reshape(
                        seq.shape[0], seq.shape[1], cfg.num_sampled_frm,
                        cfg.num_prop_per_frm).argmax(-1)
                ppls = np.array(arrays["ppls"]).reshape(
                    -1, cfg.num_sampled_frm, cfg.num_prop_per_frm, 7)
                for i in range(seq.shape[0]):
                    vid_id, seg_idx = seg_ids[i].split("_segment_")
                    seg_idx = str(int(seg_idx))
                    tmp = {"clss": [], "idx_in_sent": [],
                           "bbox_for_all_frames": []}
                    for j in range(seq.shape[1]):
                        w = int(seq[i, j])
                        if w == 0:
                            break
                        lemma = self.vocab.wtol.get(
                            self.vocab.itow[str(w)])
                        if lemma in lemma_det_dict:
                            boxes = [ppls[i, f, att2_ind[i, j, f], :4]
                                     .tolist()
                                     for f in range(cfg.num_sampled_frm)]
                            tmp["bbox_for_all_frames"].append(boxes)
                            tmp["clss"].append(
                                self.vocab.itod[lemma_det_dict[lemma]])
                            tmp["idx_in_sent"].append(j)
                    grd_output[vid_id][seg_idx] = tmp

            sents = decode_sequence(self.vocab.itow, seq)

            # attention-overlay visualization (main.py:47-85, 402-410);
            # requires extracted frames under cfg.image_path
            if cfg.vis_attn and "att2_weights" in out and cfg.image_path:
                self._visualize_batch(batch, out, sents)

            for k, sent in enumerate(sents):
                vid_id, seg_idx = seg_ids[k].split("_segment_")
                seg_idx = str(int(seg_idx))
                ts = timestamp_file["annotations"][vid_id]["segments"][
                    seg_idx]["timestamps"]
                predictions[vid_id].append(
                    {"sentence": sent,
                     "timestamp": [round(t, 2) for t in ts]})

        stats: Dict[str, float] = defaultdict(float)
        stats["captions_per_sec"] = n_caps / max(time.time() - t0, 1e-9)
        if not self.writer:
            return self._shared(None)

        if cfg.language_eval:
            submission = os.path.join(
                out_dir, "densecap_results",
                f"densecap-{cfg.val_split}-{cfg.id}.json")
            with open(submission, "w") as f:
                json.dump({"version": "VERSION 1.0",
                           "results": predictions,
                           "external_data": {
                               "used": "true",
                               "details": "Visual Genome for Faster "
                                          "R-CNN pre-training"}}, f)
            refs_exist = all(os.path.isfile(r)
                             for r in cfg.densecap_references)
            if refs_exist:
                from grounded_video_description_torch.evalmetrics import (
                    DensecapEvaluator)
                from grounded_video_description_torch.evalmetrics.spice \
                    import make_spice_fn
                ev = DensecapEvaluator(
                    ground_truth_filenames=cfg.densecap_references,
                    prediction_filename=submission,
                    tious=[0.3, 0.5, 0.7, 0.9], max_proposals=1000,
                    verbose=cfg.densecap_verbose,
                    spice_fn=make_spice_fn(data_path=cfg.data_path))
                ev.evaluate()
                for m, v in ev.scores.items():
                    stats[m] = float(np.mean(v))
                # which of the 3 scorer variants produced METEOR
                stats["meteor_impl"] = ev.meteor_impl
                print("\nResults Summary (lang eval):")
                for m in ("Bleu_1", "Bleu_4", "METEOR", "CIDEr", "SPICE"):
                    if m in stats:
                        print(f"{m}: {stats[m] * 100:.3f}")

        if cfg.eval_obj_grounding:
            attn_file = os.path.join(
                out_dir, "results",
                f"attn-gen-sent-results-{cfg.val_split}-{cfg.id}.json")
            with open(attn_file, "w") as f:
                json.dump({"results": grd_output, "eval_mode": "gen",
                           "external_data": EXTERNAL_DATA}, f)
            if not cfg.test_mode and os.path.isfile(cfg.grd_reference) \
                    and os.path.isfile(cfg.split_file):
                from grounded_video_description_torch.evalmetrics import (
                    GroundingEvaluator)
                ev = GroundingEvaluator(
                    reference_file=cfg.grd_reference,
                    submission_file=attn_file,
                    split_file=cfg.split_file,
                    val_split=[cfg.val_split], iou_thresh=0.5)
                for mode in ("all", "loc"):
                    p, r, f1, ps, rs, fs = ev.grd_eval(mode=mode)
                    stats[f"grd_prec_{mode}"] = p
                    stats[f"grd_recall_{mode}"] = r
                    stats[f"grd_f1_{mode}"] = f1

        return self._shared(dict(stats))

    # ------------------------------------------------------------------ #

    def _visualize_batch(self, batch, out, sents):
        """Draw top-1 attended boxes per word onto sampled frames
        (frames expected at <image_path>/<seg_id>/NN.jpg, the
        reference's frames_10frm layout, dataloader_anet.py:305-308)."""
        cfg = self.cfg
        from grounded_video_description_torch.utils.visualize import (
            vis_infer)

        att2_w = out["att2_weights"]
        att2_soft = np.exp(att2_w - att2_w.max(-1, keepdims=True))
        att2_soft /= att2_soft.sum(-1, keepdims=True)
        ppls = np.array(batch["ppls"])
        num = np.array(batch["num"])
        sim = out.get("sim_mat")
        for i, (sent, seg_id) in enumerate(zip(sents, batch["seg_id"])):
            frame_dir = os.path.join(cfg.image_path, seg_id)
            if not os.path.isdir(frame_dir) or not sent:
                continue
            try:
                from PIL import Image
                frames = []
                for f in range(cfg.num_sampled_frm):
                    path = os.path.join(frame_dir, f"{f + 1:02d}.jpg")
                    frames.append(np.array(Image.open(path).convert("RGB")))
                vis_infer(np.stack(frames), seg_id, sent, att2_soft[i],
                          ppls[i], int(num[i, 1]),
                          sim[i] if sim is not None else
                          np.zeros((1, ppls.shape[1])),
                          self.vocab.itod, run_id=cfg.id or "run")
            except Exception as e:   # missing frames are non-fatal
                print(f"[vis_attn] skipped {seg_id}: {e}")

    # ------------------------------------------------------------------ #

    def eval_grounding_gt(self, loader, *, out_dir: str = "."
                          ) -> Dict[str, float]:
        """GT-sentence localization eval (main.py:89-194)."""
        cfg = self.cfg
        self._gather_model()
        att2_output: Dict = defaultdict(dict)
        grd_output: Dict = defaultdict(dict)
        vocab_in_split = set()
        cls_pairs: List[np.ndarray] = []

        for batch in loader:
            n_valid = batch.get("n_valid", len(batch["seg_id"]))
            seg_ids = batch["seg_id"][:n_valid]
            arrays = {k: v for k, v in batch.items()
                      if k not in ("seg_id", "n_valid")}
            out = self.ground(arrays)
            if not self.writer:
                continue
            att2_ind = out["att2_ind"][:n_valid]          # (B, L, n_frm)
            grd_ind = out["grd_ind"][:n_valid]
            sim_target = out["sim_target"][:n_valid]      # (B, K, R)
            pred_cls = out["pred_cls"][:n_valid]          # (B, R)
            input_seq = np.array(arrays["input_seq"])[:n_valid]
            ppls = np.array(arrays["ppls"]).reshape(
                -1, cfg.num_sampled_frm, cfg.num_prop_per_frm, 7)

            # region-cls hit/miss pairs (model.py:351-355)
            for b in range(sim_target.shape[0]):
                mask = sim_target[b] > 0
                if mask.any():
                    tgt = sim_target[b][mask]
                    prd = np.broadcast_to(
                        pred_cls[b][None, :], sim_target[b].shape)[mask]
                    cls_pairs.append(np.stack([tgt, prd], axis=1))

            obj_mask = input_seq[:, 0, 1:, 0] > cfg.vocab_size
            for i in range(obj_mask.shape[0]):
                vid_id, seg_idx = seg_ids[i].split("_segment_")
                seg_idx = str(int(seg_idx))
                res_a = {"clss": [], "idx_in_sent": [],
                         "bbox_for_all_frames": []}
                res_g = {"clss": [], "idx_in_sent": [],
                         "bbox_for_all_frames": []}
                for j in range(obj_mask.shape[1]):
                    if not obj_mask[i, j]:
                        continue
                    cls_name = self.vocab.itod[
                        int(input_seq[i, 0, j + 1, 0]) - cfg.vocab_size]
                    vocab_in_split.add(cls_name)
                    boxes_a = [ppls[i, f, att2_ind[i, j, f], :4].tolist()
                               for f in range(cfg.num_sampled_frm)]
                    boxes_g = [ppls[i, f, grd_ind[i, j, f], :4].tolist()
                               for f in range(cfg.num_sampled_frm)]
                    for res, boxes in ((res_a, boxes_a), (res_g, boxes_g)):
                        res["clss"].append(cls_name)
                        res["idx_in_sent"].append(j)
                        res["bbox_for_all_frames"].append(boxes)
                att2_output[vid_id][seg_idx] = res_a
                grd_output[vid_id][seg_idx] = res_g

        if not self.writer:
            return self._shared(None)
        return self._shared(self._grounding_stats(
            att2_output, grd_output, cls_pairs, vocab_in_split, out_dir))

    def ground(self, batch_arrays) -> Optional[Dict[str, np.ndarray]]:
        """The GT-sentence grounding (``forward(mode="GRD")``) of one batch
        of host arrays, as host arrays (with a mesh, on rank 0; None on the
        others)."""
        if self.decoder is None:
            self._gather_model()
        return self._sharded(self._grounding, batch_arrays)

    def _grounding(self, arrays) -> Dict[str, np.ndarray]:
        out = self.decoder.forward(self._to_device(arrays), mode="GRD")
        names = ("att2_ind", "grd_ind", "sim_target", "pred_cls")
        return self._to_host(names, [out[k] for k in names])

    def _grounding_stats(self, att2_output, grd_output, cls_pairs,
                         vocab_in_split, out_dir: str) -> Dict[str, float]:
        """The GT-sentence JSONs written, and their scores."""
        cfg = self.cfg
        os.makedirs(os.path.join(out_dir, "results"), exist_ok=True)
        attn_file = os.path.join(
            out_dir, "results",
            f"attn-gt-sent-results-{cfg.val_split}-{cfg.id}.json")
        grd_file = os.path.join(
            out_dir, "results",
            f"grd-gt-sent-results-{cfg.val_split}-{cfg.id}.json")
        for path, results in ((attn_file, att2_output),
                              (grd_file, grd_output)):
            with open(path, "w") as f:
                json.dump({"results": results, "eval_mode": "GT",
                           "external_data": EXTERNAL_DATA}, f)

        if cfg.test_mode:
            print("[WARNING] Grounding eval unavailable for the test set; "
                  "submit results/grd-gt-sent-*.json to the eval server.")
            return {"box_accu_att": 0.0, "box_accu_grd": 0.0,
                    "cls_accu": 0.0}

        # classification accuracy across classes (main.py:166-171)
        cls_accu = 0.0
        if cls_pairs and vocab_in_split:
            pairs = np.concatenate(cls_pairs, axis=0)
            per_class = defaultdict(list)
            for tgt, prd in pairs:
                per_class[int(tgt)].append(float(tgt == prd))
            cls_accu = sum(np.mean(v) for v in per_class.values()) \
                / len(vocab_in_split)

        stats = {"box_accu_att": 0.0, "box_accu_grd": 0.0,
                 "cls_accu": cls_accu}
        if os.path.isfile(cfg.grd_reference) \
                and os.path.isfile(cfg.split_file):
            from grounded_video_description_torch.evalmetrics import (
                GroundingEvaluator)
            ev = GroundingEvaluator(
                reference_file=cfg.grd_reference, submission_file=attn_file,
                split_file=cfg.split_file, val_split=[cfg.val_split],
                iou_thresh=0.5)
            stats["box_accu_att"] = ev.gt_grd_eval()
            ev.import_sub(grd_file)
            stats["box_accu_grd"] = ev.gt_grd_eval()
            print("\nResults Summary (GT sent):")
            print(f"attention / grounding box accuracy: "
                  f"{stats['box_accu_att']:.4f} / "
                  f"{stats['box_accu_grd']:.4f}")
            print(f"classification accuracy: {cls_accu:.4f}\n")
        return stats
