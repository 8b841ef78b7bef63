"""Profiling hooks (twin of ``ganode_tpu/utils/profiling.py``): a
``torch.profiler`` trace of any region, named regions inside it, and a
host-side step timer.

    with trace("runs/x/trace"):
        with annotate("serve"):
            sess.sample_videos(64)

writes ``<host>_<pid>.<ns>.pt.trace.json`` into the directory, a Chrome
trace that TensorBoard's profiler plugin and Perfetto open: the host's ops,
and on a CUDA card every kernel the region launched (CUPTI).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed work: ``with trace('runs/x/trace'):
    step(...)``. CPU activity always, CUDA activity when torch finds a card.
    The trace is written when the block ends (after a synchronisation on the
    card, so that every launched kernel is in it); yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (shows up in the profiler timeline)."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Rolling wall-clock stats for train steps (host-side; on the card,
    pair with a synchronisation per window, since PyTorch launches
    asynchronously)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: List[float] = []
        self._last = None

    def tick(self):
        now = time.time()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        return {
            "step_ms_p50": ts[n // 2] * 1000,
            "step_ms_p90": ts[int(n * 0.9)] * 1000,
            "step_ms_mean": sum(ts) / n * 1000,
        }
