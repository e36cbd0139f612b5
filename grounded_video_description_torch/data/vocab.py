"""Vocabulary tables of the evaluator.

The port's copy of ``VocabTables`` and ``decode_sequence`` from
``grounded_video_description_tpu/data/vocab.py`` (reference:
misc/dataloader_anet.py:49-60, misc/utils.py:90-106), the tables the
evaluator reads (``itow``, ``wtod``, ``wtol``, ``itod``).  GloVe and the
weight-transfer tables are not ported yet.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np


class VocabTables:
    """Parsed `dic_anet.json` (dataloader_anet.py:49-60)."""

    def __init__(self, dic: dict):
        self.info = dic
        self.itow = dic["ix_to_word"]                    # str idx -> word
        self.wtoi = {w: i for i, w in self.itow.items()}
        self.wtod = {w: int(i) + 1 for w, i in dic["wtod"].items()}
        self.dtoi = self.wtod
        self.itod = {i: w for w, i in self.dtoi.items()}
        self.wtol = dic["wtol"]
        self.ltow = {l: w for w, l in self.wtol.items()}
        self.vocab_size = len(self.itow) + 1             # ids start at 1
        self.detect_size = len(self.itod)
        self.itoc = self.itod

    @classmethod
    def from_file(cls, path: str) -> "VocabTables":
        with open(path) as f:
            return cls(json.load(f))


def decode_sequence(itow: Dict[str, str], seq: np.ndarray) -> List[str]:
    """Token ids -> sentences, stopping at id 0 (misc/utils.py:90-106).

    Byte-exact with the reference, including its quirk of appending the
    separator BEFORE checking the stop token (utils.py:97-101): a
    sentence terminated early at position j>=1 carries a trailing
    space.  The densecap submission JSON is diffed byte-for-byte
    against the reference main.py's, so the quirk is load-bearing."""
    out = []
    for row in np.asarray(seq):
        txt = ""
        for j, ix in enumerate(row):
            if j >= 1:
                txt += " "
            if ix == 0:
                break
            txt += itow[str(int(ix))]
        out.append(txt)
    return out
