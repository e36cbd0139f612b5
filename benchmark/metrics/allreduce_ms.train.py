"""Device ms per traced step inside the ``allreduce`` spans: the sum of
the gradients over the data mesh's ranks (``all_reduce_grads_sum``, one
NCCL all-reduce per dtype), on rank 0's stream, which waits for it."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "allreduce")
