"""``ganode_tpu_torch.utils.profiling`` against ``ganode_tpu.utils.profiling``:
the trace file and its named regions, and ``StepTimer``'s window and stats on
one patched clock."""
import glob
import json
import time

import pytest
import torch

from ganode_tpu.utils import profiling as jax_profiling
from ganode_tpu_torch.ops import quant
from ganode_tpu_torch.utils import profiling


def test_trace_writes_a_file_with_the_annotation(tmp_path):
    x = torch.randn(64, 64)
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as prof:
        with profiling.annotate("int8_serve"):
            xq = torch.randint(-127, 128, (2, 3, 3, 8), dtype=torch.int8)
            w = torch.randint(-127, 128, (4, 4, 5, 8), dtype=torch.int8)
            quant.deconv_i8(xq, w, 2, 1)
            (x @ x).sum()
    assert prof is not None
    files = glob.glob(str(logdir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "int8_serve" in names
    assert any(n and n.startswith("aten::conv_transpose2d") for n in names)


def test_step_timer_matches_jax(monkeypatch):
    clock = iter([0.0, 0.010, 0.025, 0.027, 0.100, 0.101, 0.2015, 0.30,
                  0.3004, 0.4] * 2)
    ticks = [next(clock) for _ in range(20)]
    for window in (3, 50):
        timers = {}
        for name, mod in (("port", profiling), ("jax", jax_profiling)):
            feed = iter(ticks)
            monkeypatch.setattr(time, "time", lambda: next(feed))
            t = mod.StepTimer(window=window)
            assert t.stats() == {}
            for _ in range(20):
                t.tick()
            timers[name] = t.stats()
        assert timers["port"] == timers["jax"]
        assert set(timers["port"]) == {"step_ms_p50", "step_ms_p90",
                                       "step_ms_mean"}


def test_step_timer_window_keeps_the_newest(monkeypatch):
    feed = iter([0.0, 1.0, 3.0, 6.0])
    monkeypatch.setattr(time, "time", lambda: next(feed))
    t = profiling.StepTimer(window=2)
    for _ in range(4):
        t.tick()
    assert t.stats()["step_ms_mean"] == pytest.approx(2500.0)
