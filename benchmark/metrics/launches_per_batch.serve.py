"""Kernels that ran on the device per traced batch (the profiler's
kernel records): what the host had to launch."""


def read(run):
    t = run.trace
    if t is None or not t.units or not t.kernels:
        return None
    return len(t.kernels) / t.units
