"""Device ms per traced batch inside the ``d2h`` spans: the copies of the
decoded tensors back to host arrays (in greedy, mostly sim_mat), from each
span's CUDA events."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "d2h")
