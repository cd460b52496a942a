"""The port's profiling helpers (``utils/profiling.py``) on CPU: the Chrome
trace ``trace`` writes and ``sync`` (no wait for CPU tensors).  The spans
and counters are ``tests/test_torch_tracing.py``'s."""

from __future__ import annotations

import json

import torch

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
