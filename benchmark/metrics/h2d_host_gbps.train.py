"""The rate of ``batch_to_device``: the bytes it copies to the card over
the host time of its ``h2d`` spans, in the traced steps."""

from benchmark.spans import host_gbps


def read(run):
    return host_gbps(run, "h2d")
