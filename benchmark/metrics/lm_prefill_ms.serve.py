"""Device ms per traced batch inside the ``lm_prefill`` spans: the
language model's prefill of every segment's visual tokens and start id
(its 27 layers over 148,100 tokens at the benchmark's size), from each
span's CUDA events."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "lm_prefill")
