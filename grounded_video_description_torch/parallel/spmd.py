"""Count renormalization of the data-parallel train step.

The counterpart of ``grounded_video_description_tpu/parallel/spmd.py``.
Every loss is a masked mean, and the ranks (and the microbatches of one
rank) hold different mask counts, so averaging their means would bias the
step.  Each rank scales its local mean by its local count over the
global count; the scaled losses, and their gradients, then sum to the
whole batch's (spmd.py:47-58 of the JAX package).  The sums run over the
mesh's data group: the M ranks of a model axis hold the same rows, and
summing over the world would count each row M times.  With no mesh, or
one data index, the global count is the process's own, which is gradient
accumulation on one device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from grounded_video_description_torch.parallel.mesh import Mesh

# (loss, the mask count that is its masked-mean denominator)
TERMS = (("lm_loss", "txt_count"), ("att2_loss", "roi_count"),
         ("ground_loss", "roi_count"), ("cls_loss", "cls_count"))
COUNTS = ("txt_count", "roi_count", "cls_count")


def _summed(mesh: Optional[Mesh], values: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """0-d tensors summed over the data group in one collective."""
    if mesh is None or mesh.data == 1:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(stacked, group=mesh.data_group)
    return {k: stacked[i] for i, k in enumerate(keys)}


def global_counts(mesh: Optional[Mesh], sup: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The batch's mask counts over every data index (at least 1), from
    a rank's ``supervision``."""
    return {k: v.clamp_min(1.0)
            for k, v in _summed(mesh, {k: sup[k] for k in COUNTS}).items()}


def renormalized(losses: Dict[str, torch.Tensor],
                 totals: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each local masked mean times its local count over the global
    one."""
    return {name: losses[name] * (losses[ck] / totals[ck])
            for name, ck in TERMS}


def sum_metrics(mesh: Optional[Mesh], metrics: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The data indices' renormalized loss terms summed: the batch's
    values."""
    return _summed(mesh, metrics)
