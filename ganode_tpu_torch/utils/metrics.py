"""Metrics: JSONL step logs and the clips/s tracker (the port's own copy of
``ganode_tpu/utils/metrics.py``, which imports no JAX).

One JSON object per logged step, appended to a file (cheap, greppable,
plottable); a line of text on stdout every ``print_every`` steps.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: str, *, print_every: int = 100):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.print_every = print_every
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any], *, extra: Optional[dict] = None):
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        if extra:
            record.update(extra)
        self._f.write(json.dumps(record) + "\n")
        if self.print_every and step % self.print_every == 0:
            parts = " ".join(f"{k} {v:.4f}" for k, v in record.items()
                             if isinstance(v, float) and k != "time")
            print(f"step {step}: {parts}", flush=True)

    def close(self):
        self._f.close()


class Throughput:
    """Clips/s/card tracker.

    On the card, PyTorch returns before the work it queued has run, so
    ``clips_per_sec_per_chip`` is true only when read after a host sync: the
    runner reads it at a log boundary, after ``float()`` of each loss has
    waited for the step."""

    def __init__(self, clips_per_step: int, n_chips: int = 1):
        self.clips_per_step = clips_per_step
        self.n_chips = n_chips
        self._t = None
        self._steps = 0

    def start(self):
        self._t = time.time()
        self._steps = 0

    def update(self, n_steps: int = 1):
        self._steps += n_steps

    def clips_per_sec_per_chip(self) -> float:
        dt = time.time() - self._t
        return self.clips_per_step * self._steps / dt / self.n_chips
