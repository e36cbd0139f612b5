"""Sentence tokenization for metric computation.

`ptb_tokenize` is a self-contained stand-in for the coco-caption
PTBTokenizer (which shells into Stanford CoreNLP, reference
README.md:56): Penn-Treebank-style splitting of contractions and
punctuation, then the same post-pass coco-caption applies — drop the
punctuation tokens on its PUNCTUATIONS list and lowercase.

The captions this framework emits are already space-separated
lowercase vocab words, so the PTB rules only matter for ground-truth
reference sentences (which carry punctuation and contractions).
"""

import re

# coco-caption PTBTokenizer.PUNCTUATIONS (tokenizer/ptbtokenizer.py)
PUNCTUATIONS = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-",
                "-RCB-", ".", "?", "!", ",", ":", "-", "--", "...", ";",
                "(", ")", "[", "]", "{", "}", '"'}

_ELLIPSIS = re.compile(r"\.\.\.")
_PUNCT_SPLIT = re.compile(r"([;:@#$%&?!,\"\(\)\[\]{}<>])")
_FINAL_PERIOD = re.compile(r"\.(?!\d)")
_NT = re.compile(r"(?i)(?<=\w)(n't)\b")
_APOS = re.compile(r"(?i)(?<=\w)('s|'re|'ve|'ll|'d|'m)\b")
_WS = re.compile(r"\s+")


def ptb_tokenize(sentence: str):
    """PTB-style tokens, punctuation removed, lowercased."""
    s = _ELLIPSIS.sub(" ... ", sentence)
    s = _PUNCT_SPLIT.sub(r" \1 ", s)
    s = _FINAL_PERIOD.sub(" . ", s)        # periods except decimals
    s = _NT.sub(r" \1", s)                 # don't -> do n't
    s = _APOS.sub(r" \1", s)               # it's -> it 's
    return [t.lower() for t in _WS.sub(" ", s).strip().split()
            if t not in PUNCTUATIONS]


# metric modules tokenize through this alias
tokenize = ptb_tokenize


def ngrams(tokens, n):
    return [tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]
