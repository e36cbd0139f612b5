"""METEOR (Banerjee & Lavie).

The reference scores METEOR through the coco-caption Java jar
(README.md:56); this environment has no Java.  Primary scorer: the
nltk METEOR implementation (exact + Porter-stem + WordNet-synonym
unigram alignment — the canonical formulation, max over references),
used whenever nltk and its wordnet corpus are importable.  Fallback: a
pure-Python exact+suffix-stem approximation of the same formulation.
tests/test_metric_validation.py pins the two against each other and
bounds their drift.
"""

from __future__ import annotations

from typing import Dict, List

from grounded_video_description_torch.evalmetrics.tokenizer import tokenize


class _EmptyWordnet:
    """WordNet stand-in with no synsets: drives nltk's METEOR through
    its exact + Porter-stem stages only (the synonym stage never
    matches), so the canonical alignment and scoring machinery runs
    without the wordnet corpus download."""

    def synsets(self, word):
        return []


def _nltk_meteor():
    """Returns (meteor_score, kwargs) — full WordNet matching when the
    corpus is installed, otherwise exact+stem via the empty shim — or
    None when nltk itself is unavailable."""
    try:
        from nltk.translate.meteor_score import meteor_score
    except Exception:
        return None
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("dog")          # LookupError if data absent
        return meteor_score, {}
    except Exception:
        return meteor_score, {"wordnet": _EmptyWordnet()}


def _stem(w: str) -> str:
    for suf in ("ing", "ed", "es", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


def _align(cand: List[str], ref: List[str]):
    """Greedy left-to-right alignment, exact matches first then stems.
    Returns (n_matches, n_chunks)."""
    used_ref = [False] * len(ref)
    align = [-1] * len(cand)
    for stage in (0, 1):
        for i, w in enumerate(cand):
            if align[i] >= 0:
                continue
            for j, r in enumerate(ref):
                if used_ref[j]:
                    continue
                ok = (w == r) if stage == 0 else (_stem(w) == _stem(r))
                if ok:
                    align[i] = j
                    used_ref[j] = True
                    break
    matches = sum(1 for a in align if a >= 0)
    # count chunks: maximal runs of contiguous (i, j) pairs
    chunks = 0
    prev_j = None
    for a in align:
        if a < 0:
            prev_j = None
            continue
        if prev_j is None or a != prev_j + 1:
            chunks += 1
        prev_j = a
    return matches, chunks


def _score_pair(cand: List[str], ref: List[str]) -> float:
    m, chunks = _align(cand, ref)
    if m == 0:
        return 0.0
    p = m / len(cand)
    r = m / len(ref)
    fmean = 10.0 * p * r / (r + 9.0 * p)
    penalty = 0.5 * (chunks / m) ** 3
    return fmean * (1.0 - penalty)


def compute_meteor_fallback(gts: Dict[str, List[str]],
                            res: Dict[str, List[str]]) -> float:
    """Pure-Python exact+stem METEOR (no nltk dependency)."""
    total = 0.0
    for i in res:
        cand = tokenize(res[i][0])
        if not cand:
            continue
        total += max(_score_pair(cand, tokenize(r)) for r in gts[i])
    return total / max(len(res), 1)


def meteor_impl() -> str:
    """Which of the three scorer variants `compute_meteor` will use in
    this environment.  The variants differ materially (~0.79 vs ~0.65
    on a toy pair), so logged METEOR values are only comparable across
    runs when this tag matches; evaluators record it next to the score."""
    found = _nltk_meteor()
    if found is None:
        return "fallback-exact+stem"
    _, kwargs = found
    return "nltk+wordnet" if not kwargs else "nltk+empty-wordnet"


_IMPL_LOGGED = False


def compute_meteor(gts: Dict[str, List[str]],
                   res: Dict[str, List[str]]) -> float:
    global _IMPL_LOGGED
    if not _IMPL_LOGGED:
        _IMPL_LOGGED = True
        import logging

        logging.getLogger(__name__).info(
            "METEOR scorer variant: %s", meteor_impl())
    found = _nltk_meteor()
    if found is None:
        return compute_meteor_fallback(gts, res)
    scorer, kwargs = found
    total = 0.0
    for i in res:
        cand = tokenize(res[i][0])
        if not cand:
            continue
        refs = [t for t in (tokenize(r) for r in gts[i]) if t]
        if not refs:
            continue
        total += scorer(refs, cand, **kwargs)
    return total / max(len(res), 1)
