"""The rate of the copy in, per traced batch: the bytes of the host arrays
that ``Evaluator.generate`` copies to the card over the host time of its
``h2d`` spans (the pageable copy with its staging, as the caller waits for
it; ``h2d_ms.serve`` reads the device's memcpy records alone)."""

from benchmark.spans import host_gbps


def read(run):
    return host_gbps(run, "h2d")
