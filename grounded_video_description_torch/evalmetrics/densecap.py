"""Dense-captioning language evaluation (ANETcaptions equivalent).

Capability contract from the densevid_eval submodule as driven by
main.py:420-444: given ground-truth annotation files (each
{video_id: {"duration", "timestamps": [[s,e]..], "sentences": [..]}})
and a prediction file ({"results": {video_id: [{"sentence",
"timestamp"}..]}}), match predicted segments to GT segments at each
tIoU threshold in {0.3, 0.5, 0.7, 0.9}, score BLEU@1/@4, METEOR, CIDEr
(+ SPICE when external tooling is configured) over the matched pairs,
and average each metric over the tIoU thresholds.

SPICE requires the Java scene-graph pipeline; it is exposed behind
`spice_fn` (callable hook) and reported as 0.0 when absent — CIDEr (the
model-selection metric, main.py:703) and the n-gram metrics are always
computed.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional

from grounded_video_description_torch.evalmetrics.bleu import compute_bleu
from grounded_video_description_torch.evalmetrics.cider import compute_cider
from grounded_video_description_torch.evalmetrics.meteor import (
    compute_meteor, meteor_impl)


def segment_tiou(a, b) -> float:
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = max(a[1], b[1]) - min(a[0], b[0])
    return inter / union if union > 0 else 0.0


class DensecapEvaluator:
    def __init__(self, ground_truth_filenames: List[str],
                 prediction_filename: str,
                 tious: List[float] = (0.3, 0.5, 0.7, 0.9),
                 max_proposals: int = 1000,
                 verbose: bool = False,
                 spice_fn: Optional[Callable] = None):
        self.tious = list(tious)
        self.max_proposals = max_proposals
        self.verbose = verbose
        self.spice_fn = spice_fn
        self.ground_truths = []
        for fn in ground_truth_filenames:
            with open(fn) as f:
                self.ground_truths.append(json.load(f))
        with open(prediction_filename) as f:
            self.prediction = json.load(f)["results"]
        self.scores: Dict[str, List[float]] = {}
        # METEOR values are only comparable across environments when
        # the scorer variant matches — record which one produced them
        self.meteor_impl = meteor_impl()

    def _gt_segments(self, vid: str):
        out = []
        for gt in self.ground_truths:
            entry = gt.get(vid)
            if not entry:
                continue
            for ts, sent in zip(entry["timestamps"], entry["sentences"]):
                out.append((ts, sent))
        return out

    def evaluate(self) -> Dict[str, List[float]]:
        self.scores = {}
        for tiou in self.tious:
            res, gts = {}, {}
            uid = 0
            for vid, preds in self.prediction.items():
                gt_segs = self._gt_segments(vid)
                if not gt_segs:
                    continue
                for pred in preds[: self.max_proposals]:
                    refs = [sent for ts, sent in gt_segs
                            if segment_tiou(pred["timestamp"], ts) >= tiou]
                    if not refs:
                        continue
                    res[str(uid)] = [pred["sentence"]]
                    gts[str(uid)] = refs
                    uid += 1
            if not res:
                for m in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                          "METEOR", "CIDEr", "SPICE"):
                    self.scores.setdefault(m, []).append(0.0)
                continue
            bleu = compute_bleu(gts, res)
            for n in range(4):
                self.scores.setdefault(f"Bleu_{n + 1}", []).append(bleu[n])
            self.scores.setdefault("METEOR", []).append(
                compute_meteor(gts, res))
            self.scores.setdefault("CIDEr", []).append(
                compute_cider(gts, res))
            spice = self.spice_fn(gts, res) if self.spice_fn else 0.0
            self.scores.setdefault("SPICE", []).append(spice)
            if self.verbose:
                print(f"tIoU {tiou}: {len(res)} matched segments")
        return self.scores
