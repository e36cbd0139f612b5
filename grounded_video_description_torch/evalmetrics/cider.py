"""CIDEr-D metric (Vedantam et al., CVPR 2015), self-contained.

This is the model-selection metric of the reference pipeline
(main.py:703-707, computed inside the densevid_eval/coco-caption
submodules).  Standard CIDEr-D: tf-idf weighted n-gram (1..4) cosine
similarity with count clipping and a Gaussian length penalty
(sigma = 6), averaged over references, scaled by 10.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List

from grounded_video_description_torch.evalmetrics.tokenizer import (
    ngrams, tokenize)

N_MAX = 4


def _count_ngrams(tokens: List[str]) -> Counter:
    c: Counter = Counter()
    for n in range(1, N_MAX + 1):
        c.update((n, g) for g in ngrams(tokens, n))
    return c


def compute_cider(gts: Dict[str, List[str]], res: Dict[str, List[str]],
                  sigma: float = 6.0) -> float:
    """gts: {id: [reference sentences]}, res: {id: [candidate sentence]}.
    Returns the corpus CIDEr-D score (float)."""
    ids = list(res.keys())
    crefs = [[_count_ngrams(tokenize(r)) for r in gts[i]] for i in ids]
    ctest = [_count_ngrams(tokenize(res[i][0])) for i in ids]

    # document frequency over reference ngrams
    df: Dict = defaultdict(float)
    for refs in crefs:
        seen = set()
        for ref in refs:
            seen.update(ref.keys())
        for g in seen:
            df[g] += 1.0
    log_n = math.log(max(len(crefs), 1))

    def counts_to_vec(cnts: Counter):
        vec = [defaultdict(float) for _ in range(N_MAX)]
        norm = [0.0] * N_MAX
        length = 0
        for (n, g), tf in cnts.items():
            idf = log_n - math.log(max(df[g], 1.0))
            vec[n - 1][g] = tf * idf
            norm[n - 1] += (tf * idf) ** 2
            if n == 1:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def sim(vh, nh, lh, vr, nr, lr):
        delta = float(lh - lr)
        val = [0.0] * N_MAX
        for n in range(N_MAX):
            for g, w in vh[n].items():
                val[n] += min(w, vr[n].get(g, 0.0)) * vr[n].get(g, 0.0)
            if nh[n] != 0 and nr[n] != 0:
                val[n] /= nh[n] * nr[n]
            val[n] *= math.exp(-delta ** 2 / (2 * sigma ** 2))
        return val

    total = 0.0
    for test, refs in zip(ctest, crefs):
        vh, nh, lh = counts_to_vec(test)
        score_n = [0.0] * N_MAX
        for ref in refs:
            vr, nr, lr = counts_to_vec(ref)
            s = sim(vh, nh, lh, vr, nr, lr)
            for n in range(N_MAX):
                score_n[n] += s[n]
        score = sum(score_n) / N_MAX / max(len(refs), 1) * 10.0
        total += score
    return total / max(len(ids), 1)
