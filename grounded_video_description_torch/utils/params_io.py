"""Flat-npz save and load of variable trees.

The port's copy of ``grounded_video_description_tpu/utils/params_io.py``:
the format the JAX tools pass trained checkpoints around in
(tools/overfit_checkpoint.py, tools/encoder_agreement.py,
tools/quantize_report.py, tools/bench_decode_kernel.py).  One ``.npz``
holds ``{"params": tree, "state": tree, ...}``, each leaf under its
``jax.tree_util.keystr`` path after the top-level name, as
``params['logit']['w']`` or ``params['obj_interact']['layers'][0]['ff']
['l1']['b']``; dtypes are kept.  The trees are nested dicts and lists of
arrays, flattened in JAX's order (dict keys sorted, list items in
order), and the paths are written here without JAX.

``weights.to_jax_variables`` makes such a tree of a port model and
``weights.from_jax_variables`` a state dict of one, so a checkpoint saved
by the JAX tools loads into the port and the port's checkpoints load into
the JAX tools.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np


def _flatten(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in ``jax.tree_util`` flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves taken from ``leaves`` in
    flatten order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def save_variables(path: str, variables: Dict[str, Any]) -> None:
    """Writes {'params': tree, 'state': tree, ...} as one flat npz."""
    flat = {}
    for top, tree in variables.items():
        for kp, leaf in _flatten(tree):
            flat[top + kp] = np.asarray(leaf)
    np.savez(path, **flat)


def load_variables(path: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """Restores onto ``template``'s structure (``weights.to_jax_variables``
    of a model of the same config, or a JAX ``init`` result); every
    template leaf must be in the file with the template's shape
    (``KeyError``, ``ValueError``), and takes the template's dtype."""
    with np.load(path) as z:
        data = dict(z)
    out = {}
    for top, tree in template.items():
        vals: List[np.ndarray] = []
        for kp, leaf in _flatten(tree):
            key = top + kp
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            v = data[key]
            leaf = np.asarray(leaf)
            if v.shape != leaf.shape:
                raise ValueError(
                    f"{key}: shape {v.shape} != template {leaf.shape}")
            vals.append(v.astype(leaf.dtype))
        out[top] = _rebuild(tree, iter(vals))
    return out
