"""Host ms per traced step inside the ``forward`` spans: each
microbatch's model call and total loss, as the host issues them."""

from benchmark.spans import host_ms


def read(run):
    return host_ms(run, "forward")
