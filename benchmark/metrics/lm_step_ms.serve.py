"""Device ms of one decode step through the latent cache: the device ms
per traced batch inside the ``lm_decode`` spans over the batch's
``seq_length`` - 1 steps."""

from benchmark.spans import device_ms


def read(run):
    ms = device_ms(run, "lm_decode")
    return None if ms is None else ms / (run.cell.model["seq_length"] - 1)
