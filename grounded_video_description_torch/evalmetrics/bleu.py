"""Corpus BLEU@1..4 (Papineni et al.) with per-sentence clipped n-gram
counts and a closest-reference-length brevity penalty — the variant the
coco-caption submodule computes for the densecap harness
(main.py:429-443)."""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List

from grounded_video_description_torch.evalmetrics.tokenizer import (
    ngrams, tokenize)


def compute_bleu(gts: Dict[str, List[str]], res: Dict[str, List[str]],
                 max_n: int = 4) -> List[float]:
    """Returns [BLEU@1, ..., BLEU@max_n]."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0
    ref_len = 0

    for i in res:
        cand = tokenize(res[i][0])
        refs = [tokenize(r) for r in gts[i]]
        cand_len += len(cand)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            c_counts = Counter(ngrams(cand, n))
            max_ref = Counter()
            for r in refs:
                rc = Counter(ngrams(r, n))
                for g, v in rc.items():
                    max_ref[g] = max(max_ref[g], v)
            totals[n - 1] += max(len(cand) - n + 1, 0)
            clipped[n - 1] += sum(min(v, max_ref[g])
                                  for g, v in c_counts.items())

    bp = 1.0 if cand_len > ref_len else math.exp(
        1.0 - ref_len / max(cand_len, 1))
    out = []
    log_sum = 0.0
    for n in range(max_n):
        p = clipped[n] / totals[n] if totals[n] > 0 else 0.0
        # small-count smoothing as in coco-caption (tiny epsilon)
        log_sum += math.log(max(p, 1e-12))
        out.append(bp * math.exp(log_sum / (n + 1)))
    return out
