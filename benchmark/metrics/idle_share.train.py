"""The share of the traced stretch in which no kernel ran on the device
(one minus the union of the kernel intervals over the stretch)."""

from benchmark.harness import busy_ns


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    busy = busy_ns([(a, b) for _, a, b in t.kernels])
    return 100.0 * (1.0 - busy / (t.end - t.start))
