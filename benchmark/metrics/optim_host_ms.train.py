"""Host ms per traced step inside the ``optimizer`` span: the clip and the
optimizer's step with ``zero_grad`` (and a mesh's reductions)."""

from benchmark.spans import host_ms


def read(run):
    return host_ms(run, "optimizer")
