"""Device ms per traced batch inside the ``decode`` spans: all the work
after the encode up to the decoded tensors (K6 in greedy, the beam search,
the transformer decoder's launches), from each span's CUDA events."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "decode")
