"""Vocabulary tables and GloVe embedding construction.

The port's copy of ``grounded_video_description_tpu/data/vocab.py``
(reference: misc/dataloader_anet.py:49-126, misc/utils.py:90-106): the
tables the evaluator reads (``itow``, ``wtod``, ``wtol``, ``itod``), and
GloVe vectors for the Visual-Genome detector classes, the target
detection classes and every vocab word, which the weight transfer
(``data/transfer.py``) matches classes by.

A plain ``glove.*.300d.txt`` file is read when one is given; a word it
lacks falls back to a deterministic pseudo-random vector in [-1, 1)
seeded by the word's sha1, the JAX package's draw.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional

import numpy as np


def _word_fallback_vec(word: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
    return 2.0 * np.random.RandomState(seed).rand(dim) - 1.0


class GloVe:
    def __init__(self, path: Optional[str] = None, dim: int = 300):
        self.dim = dim
        self.table: Dict[str, np.ndarray] = {}
        if path:
            with open(path) as f:
                for line in f:
                    parts = line.rstrip().split(" ")
                    if len(parts) != dim + 1:
                        continue
                    self.table[parts[0]] = np.asarray(parts[1:], np.float32)

    def vec(self, word: str) -> np.ndarray:
        v = self.table.get(word)
        if v is None:
            return _word_fallback_vec(word, self.dim)
        return v

    def phrase_vec(self, phrase: str) -> np.ndarray:
        """Average over comma/space-split tokens (dataloader_anet.py:72-85)."""
        words = phrase.replace(",", " ").split(" ")
        words = [w for w in words if w] or [phrase]
        return np.mean([self.vec(w) for w in words], axis=0)


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


def load_vg_classes(path: str) -> List[str]:
    """VG detector class list with background prepended
    (dataloader_anet.py:62-67)."""
    with open(path) as f:
        classes = ["__background__"]
        classes.extend(line.strip() for line in f.readlines())
    return classes


def build_vg_cls_glove(classes: List[str], glove: GloVe) -> np.ndarray:
    return np.stack([glove.phrase_vec(c) for c in classes]).astype(np.float32)


def build_class_glove(itod: Dict[int, str], glove: GloVe) -> np.ndarray:
    """(detect_size+1, dim); index 0 = background fallback vector
    (dataloader_anet.py:102-110)."""
    out = np.zeros((len(itod) + 1, glove.dim), np.float32)
    out[0] = _word_fallback_vec("__background__", glove.dim)
    for i, word in enumerate(itod.values()):
        out[i + 1] = glove.vec(word)
    return out


def build_word_glove(wtoi: Dict[str, str], glove: GloVe) -> np.ndarray:
    """(vocab_size, dim) averaged over space-split tokens
    (dataloader_anet.py:112-124)."""
    out = np.zeros((len(wtoi) + 1, glove.dim), np.float32)
    for i, word in enumerate(wtoi.keys()):
        vecs = [glove.vec(w) for w in word.split(" ")]
        out[i + 1] = np.mean(vecs, axis=0)
    return out


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
