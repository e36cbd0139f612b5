"""ActivityNet-Entities dataset ingest (host side, NumPy only).

The port's copy of ``grounded_video_description_tpu/data/dataset.py``
(reference: misc/dataloader_anet.py:27-358): per-segment examples
assembled from ``dic_anet.json`` (vocabulary and splits), the caption
file, the grounding reference (timestamps), the proposal HDF5 file
(``dets_num`` / ``dets_labels``, read whole into memory), the
per-segment region features and the per-video frame features, padded to
static shapes (max_proposal x 7 boxes, max_gt_box x 6, seq_length tokens,
t_attn_size frames): the batch contract of ``GVDModel``.  ``Loader``
shuffles with ``np.random.RandomState(seed + epoch)`` and drops or pads
the last batch by the same rules, so the port's batches are the JAX
package's byte for byte (tests/test_torch_cli.py).

``h5py`` is imported only when a dataset is opened.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from grounded_video_description_torch.config import GVDConfig
from grounded_video_description_torch.data.vocab import VocabTables
from grounded_video_description_torch.parallel.mesh import shard_rows

ARRAY_KEYS = ("seg_feat", "input_seq", "gt_seq", "num", "ppls", "gt_boxes",
              "mask_boxes", "ppls_feat", "frm_mask", "sample_idx",
              "pnt_mask")


class AnetDataset:
    def __init__(self, cfg: GVDConfig, split: str = "training",
                 seq_per_img: Optional[int] = None):
        self.cfg = cfg
        self.split = split
        self.seq_per_img = seq_per_img or cfg.seq_per_img
        self.max_gt_box = cfg.max_gt_box
        self.max_proposal = cfg.max_proposal
        self.test_mode = cfg.test_mode

        self.vocab = VocabTables.from_file(cfg.input_dic)
        self.info = self.vocab.info

        with open(cfg.input_json) as f:
            self.caption_file = json.load(f)
        with open(cfg.grd_reference) as f:
            self.timestamp_file = json.load(f)

        import h5py
        with h5py.File(cfg.proposal_h5, "r") as h5:
            self.num_proposals = h5["dets_num"][:]
            self.label_proposals = h5["dets_labels"][:]

        # split membership, and only segments whose feature files exist
        # (dataloader_anet.py:129-145)
        self.split_ix: List[int] = []
        self.num_seg_per_vid = defaultdict(list)
        for ix, seg in enumerate(self.info["videos"]):
            seg_id = seg["id"]
            vid_id, seg_idx = seg_id.split("_segment_")
            self.num_seg_per_vid[vid_id].append(int(seg_idx))
            if seg["split"] != split:
                continue
            if (os.path.isfile(os.path.join(cfg.feature_root, seg_id + ".npy"))
                    and os.path.isfile(os.path.join(
                        cfg.seg_feature_root, vid_id[2:] + "_bn.npy"))):
                self.split_ix.append(ix)
        print(f"assigned {len(self.split_ix)} segments to split {split}")

    def __len__(self) -> int:
        return len(self.split_ix)

    def batch_buffers(self, B: int) -> Dict[str, np.ndarray]:
        """Batch arrays of the static shapes, which ``get_into`` fills row
        by row (the packer writes each segment's region features straight
        into its row)."""
        cfg = self.cfg
        S, Lq = self.seq_per_img, cfg.seq_length
        R, K = self.max_proposal, self.max_gt_box
        return {
            "seg_feat": np.empty((B, cfg.t_attn_size,
                                  cfg.rgb_feat_size
                                  + cfg.motion_feat_size), np.float32),
            "input_seq": np.empty((B, S, Lq + 1, 4), np.int64),
            "gt_seq": np.empty((B, 10, Lq), np.int64),
            "num": np.empty((B, 7), np.float32),
            "ppls": np.empty((B, R, 7), np.float32),
            "gt_boxes": np.empty((B, K, 6), np.float32),
            "mask_boxes": np.empty((B, S, K, Lq + 1), bool),
            "ppls_feat": np.empty((B, R, cfg.att_feat_size), np.float32),
            "frm_mask": np.empty((B, R, K), bool),
            "sample_idx": np.empty((B, 2), np.int64),
            "pnt_mask": np.empty((B, R + 1), bool),
        }

    def get_into(self, index: int, out: Dict[str, np.ndarray],
                 row: int) -> str:
        """Assemble segment ``index`` into row ``row`` of ``out`` (from
        ``batch_buffers``); returns its seg_id."""
        return self._assemble(index, {k: out[k][row] for k in ARRAY_KEYS})

    def __getitem__(self, index: int) -> Dict:
        out = self.batch_buffers(1)
        seg_id = self.get_into(index, out, 0)
        item = {k: out[k][0] for k in ARRAY_KEYS}
        item["seg_id"] = seg_id
        return item

    def _assemble(self, index: int, o: Dict[str, np.ndarray]) -> str:
        cfg = self.cfg
        ix = self.split_ix[index]
        seg_id = self.info["videos"][ix]["id"]
        vid_id, seg_idx = seg_id.split("_segment_")
        seg_idx = str(int(seg_idx))

        num_proposal = int(self.num_proposals[ix])
        proposals = np.array(self.label_proposals[ix][:num_proposal, :])

        region_feature = np.load(
            os.path.join(cfg.feature_root, seg_id + ".npy"))
        region_feature = region_feature.reshape(
            -1, region_feature.shape[2])
        assert num_proposal == region_feature.shape[0]

        seg_rgb = np.load(os.path.join(
            cfg.seg_feature_root, vid_id[2:] + "_resnet.npy"))
        seg_motion = np.load(os.path.join(
            cfg.seg_feature_root, vid_id[2:] + "_bn.npy"))
        seg_raw = np.concatenate((seg_rgb, seg_motion), axis=1)

        ts_entry = self.timestamp_file["annotations"][vid_id]
        timestamps = ts_entry["segments"][seg_idx]["timestamps"]
        dur = ts_entry["duration"]
        num_frm = seg_raw.shape[0]
        sample_idx = np.array([
            np.round(num_frm * timestamps[0] / dur),
            np.round(num_frm * timestamps[1] / dur)])
        sample_idx = np.clip(np.round(sample_idx), 0,
                             cfg.t_attn_size).astype(int)
        o["sample_idx"][:] = sample_idx
        n_fill = min(cfg.t_attn_size, num_frm)
        o["seg_feat"][:n_fill] = seg_raw[:cfg.t_attn_size]
        o["seg_feat"][n_fill:] = 0.0

        caption = self.caption_file[vid_id]["segments"][seg_idx]

        # box annotations within the caption length limit
        # (dataloader_anet.py:215-248)
        bbox_ann = []
        bbox_idx = 0
        for i, clss in enumerate(caption["clss"]):
            for j, cls_name in enumerate(clss):
                if caption["idx"][i][j] < cfg.seq_length:
                    if self.test_mode:
                        bbox_ann.append(dict(
                            bbox=[0, 0, 0, 0], label=self.vocab.dtoi[cls_name],
                            clss=cls_name, bbox_idx=bbox_idx,
                            idx=caption["idx"][i][j], frm_idx=-1))
                    else:
                        bbox_ann.append(dict(
                            bbox=caption["bbox"][i],
                            label=self.vocab.dtoi[cls_name], clss=cls_name,
                            bbox_idx=bbox_idx, idx=caption["idx"][i][j],
                            frm_idx=caption["frm_idx"][i]))
                    bbox_idx += 1
        bbox_ann.sort(key=lambda x: x["idx"])

        gt_bboxs = np.zeros((len(bbox_ann), 8))
        for i, bb in enumerate(bbox_ann):
            gt_bboxs[i, :4] = bb["bbox"]
            gt_bboxs[i, 4] = bb["frm_idx"]
            gt_bboxs[i, 5] = bb["label"]
            gt_bboxs[i, 6] = bb["bbox_idx"]
            gt_bboxs[i, 7] = bb["idx"]

        if not self.test_mode:
            gt_x = gt_bboxs[:, 2] - gt_bboxs[:, 0] + 1
            gt_y = gt_bboxs[:, 3] - gt_bboxs[:, 1] + 1
            gt_bboxs = gt_bboxs[(gt_x != 1) & (gt_y != 1)]

        # which caption word is a detection word (dataloader_anet.py:147-166)
        pcats = set(gt_bboxs[:, 6].tolist())
        indicator = [(0, 0, 0)] * len(caption["caption"])
        for bb in bbox_ann:
            if bb["bbox_idx"] in pcats:
                w_idx = bb["idx"]
                bn = int(bb["clss"] != caption["caption"][w_idx]) + 1
                indicator[w_idx] = (self.vocab.wtod[bb["clss"]], bn,
                                    bb["label"])

        Lq = cfg.seq_length
        cap_seq = np.zeros((Lq, 5), np.int64)
        words = caption["caption"]
        for j in range(min(len(words), Lq)):
            wid = int(self.vocab.wtoi[words[j]])
            if indicator[j][0] != 0:
                cap_seq[j, 0] = indicator[j][0] + self.vocab.vocab_size
                cap_seq[j, 1] = indicator[j][1]
                cap_seq[j, 2] = indicator[j][2]
                cap_seq[j, 3] = wid
                cap_seq[j, 4] = wid
            else:
                cap_seq[j, 0] = wid
                cap_seq[j, 4] = wid

        # GT box word-position mask (dataloader_anet.py:273-277)
        box_mask = np.ones((gt_bboxs.shape[0], Lq), np.uint8)
        for i in range(gt_bboxs.shape[0]):
            box_mask[i, int(gt_bboxs[i, 7])] = 0

        gt_bboxs = gt_bboxs[:, :6]

        o["input_seq"][:, 0] = 0
        o["input_seq"][:, 1:] = cap_seq[None, :, :4]
        o["gt_seq"][:] = 0
        o["gt_seq"][0] = cap_seq[:, 4]

        # static-shape padding (dataloader_anet.py:317-348): the pad, mask
        # and zero pass runs in the host packer, into the batch row
        num_box = min(gt_bboxs.shape[0], self.max_gt_box)
        num_pps = min(proposals.shape[0], self.max_proposal)

        o["gt_boxes"][:num_box] = gt_bboxs[:num_box]
        o["gt_boxes"][num_box:] = 0.0
        o["mask_boxes"][:] = True
        o["mask_boxes"][:, :num_box, 1:] = \
            box_mask[None, :num_box, :].astype(bool)

        from grounded_video_description_torch.data.native_pack import (
            pack_segment)
        o["pnt_mask"][0] = False
        pack_segment(
            proposals[:num_pps], region_feature[:num_pps],
            o["gt_boxes"][:num_box, 4],
            prop_thresh=cfg.prop_thresh,
            exclude_bgd=cfg.exclude_bgd_det,
            max_proposal=self.max_proposal,
            max_box=self.max_gt_box,
            out=(o["ppls"], o["pnt_mask"][1:], o["ppls_feat"],
                 o["frm_mask"]))

        o["num"][:] = (1, num_pps, num_box, int(seg_idx),
                       max(self.num_seg_per_vid[vid_id]) + 1,
                       timestamps[0] / dur, timestamps[1] / dur)
        return seg_id


def collate(items: List[Dict]) -> Dict:
    """Items into one batch: preallocated arrays filled item by item."""
    batch = {}
    for k in ARRAY_KEYS:
        first = np.asarray(items[0][k])
        out = np.empty((len(items),) + first.shape, first.dtype)
        for i, it in enumerate(items):
            out[i] = it[k]
        batch[k] = out
    batch["seg_id"] = [it["seg_id"] for it in items]
    return batch


class Loader:
    """Shuffling, prefetching batch iterator over a dataset with
    ``__len__`` / ``__getitem__``.  Drops the last partial batch in
    training so every step has the same shape (the reference iterates
    len(dataloader) - 1 for the same reason, main.py:210); ``pad_last``
    instead repeats the last item to fill it, and every batch carries
    ``n_valid`` for the consumer to truncate.

    With ``world`` > 1 the loader is rank ``rank``'s of a data-parallel
    run: batches are drawn in the global order of ``seed`` and it reads
    only the rank's rows of each (``parallel.shard_rows``: its slice of
    each of the ``accum`` microbatches), so no rank loads another's
    features."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool,
                 seed: int = 0, drop_last: bool = True,
                 pad_last: bool = False, num_threads: int = 4,
                 rank: int = 0, world: int = 1, accum: int = 1):
        self.dataset = dataset
        self.rank, self.world, self.accum = rank, world, accum
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_threads = num_threads
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _selections(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        out = []
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            n_valid = len(sel)
            if self.pad_last and n_valid < self.batch_size:
                sel = np.concatenate(
                    [sel, np.repeat(sel[-1:],
                                    self.batch_size - n_valid)])
            if self.world > 1:
                rows = shard_rows(len(sel), self.accum, self.rank,
                                  self.world)
                sel, n_valid = sel[rows], int((rows < n_valid).sum())
            out.append((sel, n_valid))
        return out

    def __iter__(self) -> Iterator[Dict]:
        if (not self.shuffle and self.world == 1
                and hasattr(self.dataset, "iter_batches")):
            # a packed cache read in order: each batch is a slice of its
            # memory maps, with no copy
            self.epoch += 1
            yield from self.dataset.iter_batches(
                self.batch_size, drop_last=self.drop_last,
                pad_last=self.pad_last)
            return
        # items fetched by a thread pool (np.load releases the GIL), up to
        # three batches ahead of the consumer; a dataset with get_into
        # assembles each item straight into its batch row
        sels = self._selections()
        one_copy = hasattr(self.dataset, "get_into") \
            and hasattr(self.dataset, "batch_buffers")
        depth = 3
        with ThreadPoolExecutor(
                max_workers=max(self.num_threads, 1)) as ex:
            inflight: deque = deque()
            it = iter(sels)

            def submit(sel_nv):
                sel, nv = sel_nv
                if one_copy:
                    out = self.dataset.batch_buffers(len(sel))
                    futs = [ex.submit(self.dataset.get_into, int(i),
                                      out, row)
                            for row, i in enumerate(sel)]
                    inflight.append((futs, out, nv))
                else:
                    futs = [ex.submit(self.dataset.__getitem__, int(i))
                            for i in sel]
                    inflight.append((futs, None, nv))

            for _ in range(depth):
                nxt = next(it, None)
                if nxt is None:
                    break
                submit(nxt)
            while inflight:
                futs, out, n_valid = inflight.popleft()
                if out is not None:
                    batch = dict(out)
                    batch["seg_id"] = [f.result() for f in futs]
                else:
                    batch = collate([f.result() for f in futs])
                batch["n_valid"] = n_valid
                nxt = next(it, None)
                if nxt is not None:
                    submit(nxt)
                yield batch
