"""Data parallelism of the port over ``torch.distributed``."""

from grounded_video_description_torch.parallel.mesh import (  # noqa: F401
    DataMesh, RowShard, all_reduce_grads_sum, broadcast_module,
    close_data_mesh, gather_rows, init_data_mesh, shard_rows, spawn,
    split_rows)
