"""Evaluator inputs made from synthetic batches: a vocabulary of the
config's sizes and the reference files that ``Evaluator.evaluate`` and
``eval_grounding_gt`` read (the grounding reference, the split file and a
densecap reference), written from the batches' own GT captions and boxes.
chip_smoke.py's eval and driver phases and ``tools/kernel_delta.py`` use
them: the card's machine has no h5py for the on-disk dataset."""

from __future__ import annotations

import json
import os


def eval_vocab(cfg):
    """A synthetic dic_anet.json of the flagship's sizes: words w1 ..
    w4903 and UNK (ids 1 .. 4904), the first 431 words the detection
    classes, every word its own lemma."""
    from grounded_video_description_torch.data.vocab import VocabTables
    words = [f"w{i}" for i in range(1, cfg.vocab_size - 1)] + ["UNK"]
    return VocabTables({
        "ix_to_word": {str(i + 1): w for i, w in enumerate(words)},
        "wtod": {w: i for i, w in enumerate(words[:cfg.detect_size])},
        "wtol": {w: w for w in words}})


def eval_references(root, cfg, vocab, batches):
    """The files the evaluator reads, made from the batches: the grounding
    reference (timestamps and, per GT box, its class, frame, box and word
    position), the split file and one densecap reference (the GT
    captions).  Returns the config fields that name them."""
    ann, dense = {}, {}
    for batch in batches:
        for b, seg_id in enumerate(batch["seg_id"]):
            vid, seg = seg_id.split("_segment_")
            seg = str(int(seg))
            iseq = batch["input_seq"][b, 0, 1:]
            objs = [(j, int(iseq[j, 0]) - cfg.vocab_size)
                    for j in range(iseq.shape[0])
                    if iseq[j, 0] > cfg.vocab_size]
            boxes = {int(box[5]): box for box in batch["gt_boxes"][b][::-1]
                     if box[5] > 0}
            ts = [float(b), float(b) + 10.0]
            ann.setdefault(vid, {"segments": {}})["segments"][seg] = {
                "timestamps": ts,
                "process_clss": [vocab.itod[c] for _, c in objs],
                "frame_ind": [int(boxes[c][4]) for _, c in objs],
                "process_bnd_box": [boxes[c][:4].tolist() for _, c in objs],
                "process_idx": [j for j, _ in objs]}
            words = [vocab.itow[str(int(w))] for w in batch["gt_seq"][b, 0]
                     if w > 0]
            d = dense.setdefault(vid, {"duration": 200.0, "timestamps": [],
                                       "sentences": []})
            d["timestamps"].append(ts)
            d["sentences"].append(" ".join(words))
    paths = {}
    for key, obj in (("grd_reference", {"annotations": ann}),
                     ("split_file", {"validation": sorted(ann)}),
                     ("densecap_reference", dense)):
        paths[key] = os.path.join(root, f"{key}.json")
        with open(paths[key], "w") as f:
            json.dump(obj, f)
    return {"grd_reference": paths["grd_reference"],
            "split_file": paths["split_file"],
            "densecap_references": [paths["densecap_reference"]],
            "data_path": root}
