"""Device ms per traced batch inside the ``encode`` spans
(``GVDModel.encode``: the BiRNN through K2, the obj_interact encoder
through K1, the grounder and the banks), from each span's CUDA events."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "encode")
