"""Pack-once on-disk ingest cache (host side).

The port's copy of ``grounded_video_description_tpu/data/packed_cache.py``
(read by the driver under ``--packed_cache_dir``).  A segment's packed
arrays are a pure function of the files on disk, so they are written once
into memory-mappable files and served from the page cache in every later
epoch, with no parsing, concatenation or packing.

Layout: ``<dir>/<key>.npy`` (one .npy per batch key, shape (N,
*item_shape), opened with ``mmap_mode="r"``) and ``<dir>/meta.json``
(seg_ids and a fingerprint of every config field that changes the packed
bytes; a mismatch rebuilds).  The files are the JAX package's, byte for
byte (tests/test_torch_cli.py).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from grounded_video_description_torch.data.dataset import (
    ARRAY_KEYS, AnetDataset)

_FINGERPRINT_FIELDS = (
    "seq_length", "max_proposal", "max_gt_box", "t_attn_size",
    "rgb_feat_size", "motion_feat_size", "att_feat_size", "prop_thresh",
    "exclude_bgd_det", "test_mode",
)


def _fingerprint(ds: AnetDataset) -> Dict:
    fp = {f: getattr(ds.cfg, f) for f in _FINGERPRINT_FIELDS}
    fp["seq_per_img"] = ds.seq_per_img
    fp["split"] = ds.split
    fp["n_segments"] = len(ds)
    return fp


def build_cache(ds: AnetDataset, directory: str,
                num_threads: int = 1) -> "PackedDataset":
    """Packs every segment of ``ds`` into ``directory`` (one pass through
    the dataset's assembly) and returns the memory-mapped dataset."""
    os.makedirs(directory, exist_ok=True)
    n = len(ds)
    shapes = ds.batch_buffers(1)
    writers = {
        k: np.lib.format.open_memmap(
            os.path.join(directory, k + ".npy"), mode="w+",
            dtype=v.dtype, shape=(n,) + v.shape[1:])
        for k, v in shapes.items()}

    seg_ids: List[Optional[str]] = [None] * n

    def pack_one(i: int):
        seg_ids[i] = ds.get_into(i, writers, i)

    if num_threads > 1:
        with ThreadPoolExecutor(max_workers=num_threads) as ex:
            list(ex.map(pack_one, range(n)))
    else:
        for i in range(n):
            pack_one(i)

    for w in writers.values():
        w.flush()
    del writers
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump({"seg_ids": seg_ids, "fingerprint": _fingerprint(ds)},
                  f)
    return PackedDataset(directory)


def open_or_build(ds: AnetDataset, directory: str,
                  num_threads: int = 1) -> "PackedDataset":
    """The cache at ``directory``, rebuilt if it is absent or its
    fingerprint does not match ``ds``'s packing config."""
    meta = os.path.join(directory, "meta.json")
    if os.path.isfile(meta):
        with open(meta) as f:
            m = json.load(f)
        if m.get("fingerprint") == _fingerprint(ds):
            return PackedDataset(directory)
    return build_cache(ds, directory, num_threads=num_threads)


class PackedDataset:
    """Packed segments served out of memory-mapped files, with the
    dataset's surface (``batch_buffers`` / ``get_into`` /
    ``__getitem__``), so ``Loader`` takes it unchanged."""

    def __init__(self, directory: str):
        self.dir = directory
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        self.seg_ids: List[str] = meta["seg_ids"]
        self.fingerprint: Dict = meta["fingerprint"]
        self.m = {k: np.load(os.path.join(directory, k + ".npy"),
                             mmap_mode="r")
                  for k in ARRAY_KEYS}
        n = len(self.seg_ids)
        assert all(v.shape[0] == n for v in self.m.values()), (
            "cache arrays disagree on segment count")

    def __len__(self) -> int:
        return len(self.seg_ids)

    def batch_buffers(self, B: int) -> Dict[str, np.ndarray]:
        return {k: np.empty((B,) + v.shape[1:], v.dtype)
                for k, v in self.m.items()}

    def get_into(self, index: int, out: Dict[str, np.ndarray],
                 row: int) -> str:
        for k, src in self.m.items():
            out[k][row] = src[index]
        return self.seg_ids[index]

    def __getitem__(self, index: int) -> Dict:
        item = {k: np.asarray(src[index]) for k, src in self.m.items()}
        item["seg_id"] = self.seg_ids[index]
        return item

    def iter_batches(self, batch_size: int, *, drop_last: bool = False,
                     pad_last: bool = False):
        """Batches in order, each a slice of the memory maps (no copy):
        the evaluation feed.  Yields dicts with 'seg_id' (list) and
        'n_valid', as ``Loader`` does."""
        n = len(self)
        nb = n // batch_size if drop_last else -(-n // batch_size)
        for b in range(nb):
            lo = b * batch_size
            hi = min(lo + batch_size, n)
            batch = {k: src[lo:hi] for k, src in self.m.items()}
            ids = self.seg_ids[lo:hi]
            n_valid = hi - lo
            if pad_last and n_valid < batch_size:
                reps = batch_size - n_valid
                batch = {k: np.concatenate(
                    [v, np.repeat(v[-1:], reps, axis=0)]) for k, v in
                    batch.items()}
                ids = ids + [ids[-1]] * reps
            batch["seg_id"] = ids
            batch["n_valid"] = n_valid
            yield batch
