"""Object-grounding evaluation (ANetGrdEval equivalent).

Capability contract from tools/anet_entities/scripts/
eval_grd_anet_entities.py as driven by main.py:174-184 and 454-461:

  * `gt_grd_eval()` — box accuracy on GT sentences: for every annotated
    object word, the submitted box on the object's annotated frame must
    reach IoU >= iou_thresh with the GT box; per-class accuracies are
    averaged over classes.
  * `grd_eval(mode='all'|'loc')` — precision / recall / F1 on generated
    sentences, per-class averaged and per-sentence averaged.  'all'
    scores every GT object (a missed word hurts recall); 'loc' only
    scores objects whose class was correctly predicted (pure
    localization quality).

Reference annotation format (anet_entities cleaned json):
{"annotations": {vid: {"duration": d, "segments": {seg_idx: {
    "tokens": [...], "process_clss": [cls,..], "frame_ind": [i,..],
    "process_bnd_box": [[x1,y1,x2,y2],..], "process_idx": [w,..]}}}}}

Submission format (written by main.py:157-163, 446-450):
{"results": {vid: {seg_idx: {"clss": [...], "idx_in_sent": [...],
    "bbox_for_all_frames": [[[x1,y1,x2,y2] x 10] ...]}}},
 "eval_mode": "GT"|"gen", ...}

Derivation notes (the anet_entities submodule is EMPTY in this
checkout, so the semantics below are derived from the main.py call
sites and the GVD/ANet-Entities papers, not diffed against the
upstream script; each self-derived choice is marked).  Wherever the
upstream script IS available ($ANET_ENTITIES_SCRIPTS or an
initialized submodule checkout), tests/test_grounding_upstream.py
runs BOTH evaluators on the same files and asserts equal outputs for
gt_grd_eval and both grd_eval modes — the same skip-guard pattern as
the Java-metric fidelity tests:

  * IoU uses the +1 pixel convention (`box_iou`), matching this
    repo's own geometry (bbox_transform.py:221-222) which the
    upstream shares (same codebase family).
  * gt_grd_eval matches a GT object to the FIRST submission entry
    with the same idx_in_sent (`break` below): main.py emits at
    most one entry per word position (main.py:142-151 iterates word
    positions), so duplicates cannot occur in main.py-produced files;
    the break makes hand-built files deterministic.  [self-derived]
  * gt_grd_eval averages per-class accuracies over the classes that
    HAVE GT annotations in the split (not the full detector
    vocabulary): classes without GT cannot contribute an accuracy.
    Note main.py's own cls-accu aggregation (main.py:171) divides
    by `vocab_in_split` — the classes appearing in GT sentences —
    which is the same set here.  [derived from main.py:171]
  * grd_eval per-class denominators: precision over all predicted
    occurrences of the class, recall over all GT occurrences; the
    final average runs over the UNION of predicted and GT classes
    (a class hallucinated by the captioner contributes 0 precision —
    in 'all' mode a prediction with no GT counterpart must be a
    false positive, else precision is gameable).  [self-derived]
  * grd_eval 'loc' mode skips GT classes the captioner did not
    predict (pure localization quality given correct classes), per
    the paper's attn/grd "loc" metric definition.  [paper-derived]
  * grd_eval 'all' mode counts predictions in GT-EMPTY segments as
    false positives: a submission segment with no GT annotations
    still feeds every predicted occurrence into the per-class
    precision denominator and contributes a per-sentence precision
    of 0 (no recall/F1 entry — recall is undefined without GT).
    Skipping such segments (iterating GT keys only) would inflate
    'all'-mode precision: hallucinated objects in unannotated
    segments would be free.  'loc' mode is unaffected — it only
    scores GT classes.  [self-derived]
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional


def box_iou(a: List[float], b: List[float]) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]) + 1)
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]) + 1)
    inter = ix * iy
    area_a = (a[2] - a[0] + 1) * (a[3] - a[1] + 1)
    area_b = (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


class GroundingEvaluator:
    def __init__(self, reference_file: str, submission_file: str,
                 split_file: str, val_split: List[str],
                 iou_thresh: float = 0.5, verbose: bool = False):
        with open(reference_file) as f:
            self.ref = json.load(f)["annotations"]
        with open(split_file) as f:
            split_ids = json.load(f)
        self.vids = set()
        for s in val_split:
            self.vids.update(split_ids.get(s, []))
        self.iou_thresh = iou_thresh
        self.verbose = verbose
        self.import_sub(submission_file)

    def import_sub(self, submission_file: str):
        with open(submission_file) as f:
            self.sub = json.load(f)["results"]

    # ------------------------------------------------------------------ #

    def _iter_gt_objects(self):
        """Yields (vid, seg, class, word_idx, frame_ind, box)."""
        for vid, entry in self.ref.items():
            if self.vids and vid not in self.vids:
                continue
            for seg, ann in entry["segments"].items():
                clss = ann["process_clss"]
                frames = ann["frame_ind"]
                boxes = ann["process_bnd_box"]
                idxs = ann["process_idx"]
                for c, fi, bb, wi in zip(clss, frames, boxes, idxs):
                    # entries may be per-box lists (one box, several
                    # class/idx aliases) — normalize to flat tuples
                    cs = c if isinstance(c, list) else [c]
                    ws = wi if isinstance(wi, list) else [wi]
                    for cc, ww in zip(cs, ws):
                        yield vid, seg, cc, ww, fi, bb

    def _sub_entries(self, vid: str, seg: str):
        seg_map = self.sub.get(vid, {})
        return seg_map.get(seg)

    # ------------------------------------------------------------------ #

    def gt_grd_eval(self) -> float:
        """Box accuracy per class on GT sentences (averaged over
        classes)."""
        hits = defaultdict(list)
        for vid, seg, cls_name, widx, frame_ind, gt_box in \
                self._iter_gt_objects():
            entry = self._sub_entries(vid, seg)
            hit = 0
            if entry:
                for c, wi, frames in zip(entry["clss"],
                                         entry["idx_in_sent"],
                                         entry["bbox_for_all_frames"]):
                    if wi == widx:
                        pred_box = frames[int(frame_ind)]
                        if box_iou(pred_box, gt_box) >= self.iou_thresh:
                            hit = 1
                        break
            hits[cls_name].append(hit)
        if not hits:
            return 0.0
        per_class = [sum(v) / len(v) for v in hits.values()]
        accu = sum(per_class) / len(per_class)
        if self.verbose:
            print(f"GT-grounding accuracy over {len(per_class)} classes: "
                  f"{accu:.4f}")
        return accu

    # ------------------------------------------------------------------ #

    def grd_eval(self, mode: str = "all"):
        """P/R/F1 on generated sentences; returns
        (prec, recall, f1, prec_per_sent, rec_per_sent, f1_per_sent)."""
        assert mode in ("all", "loc")
        # GT objects per (vid, seg): class -> [(frame, box)]
        gt_objs: Dict = defaultdict(lambda: defaultdict(list))
        for vid, seg, cls_name, widx, fi, bb in self._iter_gt_objects():
            gt_objs[(vid, seg)][cls_name].append((int(fi), bb))

        cls_tp = defaultdict(float)     # correctly localized predictions
        cls_pred = defaultdict(float)   # predicted occurrences
        cls_gt = defaultdict(float)     # GT occurrences
        sent_prec, sent_rec, sent_f1 = [], [], []

        for (vid, seg), objs in gt_objs.items():
            entry = self._sub_entries(vid, seg) or \
                {"clss": [], "idx_in_sent": [], "bbox_for_all_frames": []}
            pred_classes = set(entry["clss"])
            s_tp = s_pred = s_gt = 0.0
            for cls_name, sites in objs.items():
                if mode == "loc" and cls_name not in pred_classes:
                    continue
                cls_gt[cls_name] += len(sites)
                s_gt += len(sites)
            for c, frames in zip(entry["clss"],
                                 entry["bbox_for_all_frames"]):
                if c not in objs:
                    if mode == "all":
                        cls_pred[c] += 1
                        s_pred += 1
                    continue
                cls_pred[c] += 1
                s_pred += 1
                ok = any(box_iou(frames[fi], bb) >= self.iou_thresh
                         for fi, bb in objs[c])
                if ok:
                    cls_tp[c] += 1
                    s_tp += 1
            p = s_tp / s_pred if s_pred else 0.0
            r = s_tp / s_gt if s_gt else 0.0
            f = 2 * p * r / (p + r) if p + r else 0.0
            sent_prec.append(p)
            sent_rec.append(r)
            sent_f1.append(f)

        if mode == "all":
            # predictions in GT-empty segments are false positives
            # (docstring derivation note #5): per-class precision
            # denominator + a 0 per-sentence precision entry; no
            # recall/F1 entry (undefined without GT)
            for vid, segs in self.sub.items():
                if self.vids and vid not in self.vids:
                    continue
                for seg, entry in segs.items():
                    if (vid, seg) in gt_objs or not entry["clss"]:
                        continue
                    for c in entry["clss"]:
                        cls_pred[c] += 1
                    sent_prec.append(0.0)

        classes = set(cls_gt) | set(cls_pred)
        precs, recs, f1s = [], [], []
        for c in classes:
            p = cls_tp[c] / cls_pred[c] if cls_pred[c] else 0.0
            r = cls_tp[c] / cls_gt[c] if cls_gt[c] else 0.0
            f = 2 * p * r / (p + r) if p + r else 0.0
            precs.append(p)
            recs.append(r)
            f1s.append(f)

        def avg(x):
            return sum(x) / len(x) if x else 0.0

        out = (avg(precs), avg(recs), avg(f1s),
               avg(sent_prec), avg(sent_rec), avg(sent_f1))
        if self.verbose:
            print(f"[grd_eval mode={mode}] P/R/F1 per-class: "
                  f"{out[0]:.4f}/{out[1]:.4f}/{out[2]:.4f}  per-sent: "
                  f"{out[3]:.4f}/{out[4]:.4f}/{out[5]:.4f}")
        return out
