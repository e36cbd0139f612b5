"""Host ms per traced step inside the ``backward`` spans: each
microbatch's ``loss.backward()``."""

from benchmark.spans import host_ms


def read(run):
    return host_ms(run, "backward")
