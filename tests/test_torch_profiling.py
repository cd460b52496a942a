"""The port's profiling helpers (``utils/profiling.py``) on CPU: the Chrome
trace ``trace`` writes, ``sync`` (no wait for CPU tensors), and
``Stopwatch`` / ``ThroughputMeter`` against the JAX package's on the same
clock readings."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from parler_tts_tpu.utils import profiling as jprof
from parler_tts_tpu_torch.utils import profiling as pprof

torch.set_num_threads(1)  # tier-1 runs several pytest workers


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    x = torch.randn(64, 64)
    with pprof.trace(str(tmp_path / "logs")) as prof:
        with torch.profiler.record_function("parler_block"):
            y = x @ x
    names = {e["name"] for e in json.loads((tmp_path / "logs" / pprof.TRACE_FILE).read_text())["traceEvents"]
             if "name" in e}
    assert {"parler_block", "aten::mm"} <= names
    assert "aten::mm" in {e.key for e in prof.key_averages()}
    assert y.shape == (64, 64)


def test_sync_waits_for_no_cpu_tensor(monkeypatch):
    def refuse(*_):
        raise AssertionError("synchronize called for CPU tensors")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    t = torch.ones(3)
    pprof.sync({"a": [t, (t, 1)], "b": "text"})
    pprof.sync(None)
    assert list(pprof._tensors({"a": [t, (t, 2)], "b": t})) == [t, t, t]


class _Clock:
    def __init__(self, readings):
        self.readings = iter(readings)

    def __call__(self) -> float:
        return next(self.readings)


@pytest.mark.parametrize("work", [[dict(steps=1, frames=86, tokens=900)],
                                  [dict(steps=2, frames=10), dict(tokens=5), dict(steps=1, frames=172)]])
def test_meters_report_as_the_jax_package_s(monkeypatch, work):
    readings = list(np.cumsum([0.5] + [0.25 * (i + 1) for i in range(len(work))]))
    monkeypatch.setattr(jprof.time, "time", _Clock(readings))
    monkeypatch.setattr(pprof.time, "perf_counter", _Clock(readings))
    ref, got = jprof.ThroughputMeter().start(), pprof.ThroughputMeter().start()
    for w in work:
        ref.add(**w)
        got.add(**w)
    assert got.report() == ref.report()
    assert set(got.report()) == {"steps_per_sec", "tokens_per_sec", "audio_seconds_per_sec", "wall_seconds"}
    monkeypatch.setattr(jprof.time, "time", _Clock([1.0, 3.5]))
    monkeypatch.setattr(pprof.time, "perf_counter", _Clock([1.0, 3.5]))
    assert pprof.Stopwatch().start().stop(torch.ones(2)) == jprof.Stopwatch().start().stop() == 2.5
