"""Visual-Genome detector knowledge transfer ("weight surgery").

The port's copy of ``grounded_video_description_tpu/data/transfer.py``
(reference: misc/model.py:172-217), applied to a port ``GVDModel``'s own
parameters:

  * the detector's fc7 layer (weights and bias) seeds the region-feature
    projection ``ctx2pool_grd``;
  * each target detection class is matched to its nearest VG class by
    GloVe cosine similarity, and the VG classifier row (cls_score_w/b)
    seeds the visual-word embedding ``vis_embed`` and the per-class
    grounder bias ``vis_classifiers_bias`` (transfer_mode 'cls'/'both');
  * transfer_mode 'glove' seeds ``vis_embed`` with the class GloVe
    vectors.

It runs once, at model build, before the model moves to its device.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def load_detectron_weights(path_prefix: str) -> Dict[str, np.ndarray]:
    """Loads fc7_w/fc7_b (+ cls_score_w/cls_score_b if present) pickles
    from `<path_prefix>/fc7_w.pkl` etc. (model.py:173-185)."""
    out = {}
    for name in ("fc7_w", "fc7_b", "cls_score_w", "cls_score_b"):
        try:
            with open(f"{path_prefix}/{name}.pkl", "rb") as f:
                out[name] = np.asarray(pickle.load(f, encoding="latin1"))
        except FileNotFoundError:
            pass
    return out


def match_classes_by_glove(glove_vg_cls: np.ndarray,
                           glove_clss: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Cosine-similarity nearest VG class per target class
    (model.py:190-195).

    glove_vg_cls: (n_vg, 300) — VG detector classes incl. background@0.
    glove_clss:   (C+1, 300)  — target classes incl. background@0.
    Returns (max_sim (C+1,), matched_cls (C+1,) int indices into VG).
    """
    def norm(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    sim = norm(glove_vg_cls) @ norm(glove_clss).T    # (n_vg, C+1)
    matched = np.argmax(sim, axis=0)
    max_sim = sim[matched, np.arange(sim.shape[1])]
    return max_sim, matched


def _set(param: torch.Tensor, value: np.ndarray) -> None:
    """Copy ``value`` into ``param`` (same shape; cast to its dtype)."""
    value = torch.from_numpy(np.ascontiguousarray(value))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"transfer: {tuple(value.shape)} into a parameter "
                         f"of {tuple(param.shape)}")
    param.copy_(value)


@torch.no_grad()
def apply_weight_transfer(model, *, transfer_mode: str,
                          detectron: Dict[str, np.ndarray],
                          glove_vg_cls: Optional[np.ndarray] = None,
                          glove_clss: Optional[np.ndarray] = None,
                          verbose: bool = False):
    """Applies the surgery to ``model`` (a ``GVDModel``) in place and
    returns it."""
    if "fc7_w" in detectron:
        fc7_w = detectron["fc7_w"]        # (2048, 2048) torch (out, in)
        fc7_b = detectron["fc7_b"]
        lin = model.ctx2pool_grd[0]       # ours: torch (out, in) too
        n = fc7_w.shape[0]
        # the JAX package's w[:, :n] = fc7_w.T[:in, :] on its (in, out) w
        _set(lin.weight[:n], fc7_w[:, :lin.weight.shape[1]])
        _set(lin.bias[:n], fc7_b)

    vis_embed = model.vis_embed[0].weight
    if transfer_mode in ("cls", "both"):
        if glove_vg_cls is None or glove_clss is None:
            raise ValueError(f"transfer_mode {transfer_mode!r} needs the "
                             "GloVe vectors of both class lists")
        cls_w = detectron["cls_score_w"]   # (n_vg, 2048)
        cls_b = detectron["cls_score_b"]   # (n_vg,)
        C1 = glove_clss.shape[0]
        max_sim, matched = match_classes_by_glove(glove_vg_cls, glove_clss)
        matched = matched.copy()
        matched[0] = 0                      # background -> background
        vis_classifiers = cls_w[matched]    # (C+1, 2048)
        if verbose:
            low = np.sum(max_sim[1:] < 0.9)
            print(f"[transfer] {low}/{C1 - 1} classes matched with "
                  f"similarity < 0.9")
        if transfer_mode == "cls":
            _set(vis_embed, vis_classifiers.astype(np.float32))
        else:
            _set(vis_embed, np.concatenate(
                [vis_classifiers, glove_clss], axis=1).astype(np.float32))
        _set(model.vis_classifiers_bias, cls_b[matched].astype(np.float32))
    elif transfer_mode == "glove":
        if glove_clss is None:
            raise ValueError("transfer_mode 'glove' needs the class GloVe "
                             "vectors")
        _set(vis_embed, glove_clss.astype(np.float32))
    elif transfer_mode != "none":
        raise NotImplementedError(transfer_mode)
    return model
