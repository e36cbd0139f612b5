"""Metrics logging of the port.

The port's copy of ``MetricLogger`` from
``grounded_video_description_tpu/utils/logging.py``: an append-only JSONL
sink every run can tail, with an optional TensorBoard scalar mirror
through ``torch.utils.tensorboard`` (imported when first written).  If
that import fails, the logger says the sink is unavailable and keeps the
JSONL sink, as the JAX package does.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional


class MetricLogger:
    """Append-only JSONL metrics sink (timestamps added), with an
    optional TensorBoard scalar mirror."""

    def __init__(self, path: Optional[str] = None, echo: bool = False,
                 tensorboard_dir: Optional[str] = None):
        self.path = path
        self.echo = echo
        self.history = []
        self._tb = None
        self._tb_dir = tensorboard_dir
        self._tb_step = 0

    def _tb_writer(self):
        if self._tb is None and self._tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(self._tb_dir)
            except Exception as e:  # tensorboard not installed: JSONL only
                print(f"[logging] tensorboard sink unavailable: {e}")
                self._tb_dir = None
        return self._tb

    def log(self, metrics: Dict):
        rec = {"ts": time.time(),
               **{k: (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}}
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        tb = self._tb_writer()
        if tb is not None:
            step = int(rec.get("step", self._tb_step))
            self._tb_step = max(self._tb_step, step) + 1
            for k, v in rec.items():
                if k not in ("ts", "step") and isinstance(v, float):
                    tb.add_scalar(k, v, step)
        if self.echo:
            print(json.dumps(rec))

    def close(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
