"""Parallelism of the port over ``torch.distributed``: the (data,
model) device mesh (``mesh``), the count renormalization of the sharded
step (``spmd``) and the model axis's split vocab head (``tensor``)."""

from grounded_video_description_torch.parallel.mesh import (  # noqa: F401
    Mesh, RowShard, all_reduce_grads_sum, broadcast_module, close_mesh,
    gather_rows, init_mesh, shard_rows, spawn, split_rows)
from grounded_video_description_torch.parallel.tensor import (  # noqa: F401
    shard_model, whole_model)
