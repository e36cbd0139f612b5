"""Model FLOPs of the captions served in the measured window (without
the profiler), over the window's seconds times the dtype's peak
(``work.py``: 495 TFLOP/s for f32, whatever route a product takes)."""

from benchmark.work import PEAK_FLOPS


def read(run):
    w = run.window
    if not w.get("units"):
        return None
    flops = run.work["flops_per_unit"] * w["units"]
    return 100.0 * flops / (w["seconds"] * PEAK_FLOPS[run.work["dtype"]])
