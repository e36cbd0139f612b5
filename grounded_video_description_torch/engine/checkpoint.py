"""Checkpoint and resume of the port.

The counterpart of ``grounded_video_description_tpu/engine/checkpoint.py::
CheckpointManager`` (reference: main.py:620-652, 702-743), with the same
file names and JSON sidecars in the checkpoint directory: ``model`` and
``model-best`` (directories), ``infos.json`` and ``infos-best.json`` (the
driver's metadata, with the trainer's ``step`` added).  Where the JAX
package writes its parameter and optimizer trees with Orbax, ``model``
holds one ``torch.save`` file: the model's ``state_dict`` (whose keys the
JAX package's ``import_torch_checkpoint`` reads), the optimizer's
``state_dict``, the step and the dropout generator's state, so a resumed
run draws the masks the uninterrupted one would have.

Under a ``Mesh`` every rank holds the same generator state and the same
weights and optimizer state, but for a model axis's slices of the vocab
head and the visual-word table (``parallel/tensor.py``): those, and
their moments, are gathered whole, and rank 0 alone writes one copy of a
whole model.  Every rank restores it and keeps its slices, so a run
resumed on one device or on another mesh goes on with the run it came
from.  A barrier follows each save and each restore.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from grounded_video_description_torch.parallel.mesh import Mesh, barrier
from grounded_video_description_torch.parallel.tensor import (
    local_optimizer_state, local_state_dict, whole_optimizer_state,
    whole_state_dict)

STATE_FILE = "checkpoint.pt"


class CheckpointManager:
    def __init__(self, directory: str, mesh: Optional[Mesh] = None):
        self.dir = os.path.abspath(directory)
        self.mesh = mesh
        if mesh is None or mesh.writer:
            os.makedirs(self.dir, exist_ok=True)
        barrier(mesh)

    def _save(self, name: str, blob: Dict, infos: Dict, infos_name: str):
        path = os.path.join(self.dir, name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(blob, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        with open(os.path.join(self.dir, infos_name), "w") as f:
            json.dump(infos, f)

    def save(self, trainer, infos: Dict, *, best: bool = False):
        """``model`` (and ``model-best`` when ``best``) from the trainer's
        model, optimizer, step and generator, with ``infos`` (plus the
        step) beside it."""
        blob = {"model": whole_state_dict(trainer.model),
                "optimizer": whole_optimizer_state(trainer),
                "step": trainer.step,
                "generator": trainer.generator.get_state()}
        infos = {**infos, "step": trainer.step}
        if self.mesh is None or self.mesh.writer:
            self._save("model", blob, infos, "infos.json")
            if best:
                self._save("model-best", blob, infos, "infos-best.json")
        barrier(self.mesh)

    def restore(self, trainer, *, load_best: bool = True) -> Dict:
        """Loads ``model-best`` when ``load_best`` and it exists, else
        ``model``, into the trainer; returns that checkpoint's infos."""
        name = "model-best" if load_best and os.path.isdir(
            os.path.join(self.dir, "model-best")) else "model"
        # loaded to the host: load_state_dict copies each tensor to where
        # its parameter lives, and Adam keeps its step counts on the host
        blob = torch.load(os.path.join(self.dir, name, STATE_FILE),
                          map_location="cpu", weights_only=True)
        trainer.model.load_state_dict(local_state_dict(trainer.model,
                                                       blob["model"]))
        trainer.optimizer.load_state_dict(local_optimizer_state(
            trainer, blob["optimizer"]))
        trainer.generator.set_state(blob["generator"])
        infos_file = os.path.join(
            self.dir, "infos-best.json" if name == "model-best"
            else "infos.json")
        infos = {}
        if os.path.isfile(infos_file):
            with open(infos_file) as f:
                infos = json.load(f)
        trainer.step = infos.get("step", blob["step"])
        barrier(self.mesh)
        return infos
