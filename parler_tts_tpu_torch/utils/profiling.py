"""Tracing, timing and throughput counters (port of
``parler_tts_tpu/utils/profiling.py``).

* ``trace(logdir)``: ``torch.profiler`` around a block (the host, and the
  card when there is one), written as a Chrome trace, ``logdir/trace.json``;
* ``sync(x)``: wait for the card's work behind ``x``;
* ``Stopwatch`` and ``ThroughputMeter``: wall time with that wait at the
  stop, and steps, tokens and audio seconds per second, with the JAX
  package's method names and ``report()`` keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the block; yields the profiler (``key_averages()`` for sums
    by kernel) and writes ``logdir/trace.json`` when the block ends."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):  # an output record
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def sync(x: Any) -> None:
    """Wait until the work behind ``x`` (tensors, also inside lists, tuples,
    dicts or an output dataclass) is done: ``torch.cuda.synchronize`` on each
    card they live on, nothing for CPU tensors."""
    for device in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


class Stopwatch:
    """Wall-clock timer that waits for ``result`` at the stop."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def start(self) -> "Stopwatch":
        self.t0 = time.perf_counter()
        return self

    def stop(self, result: Any = None) -> float:
        if result is not None:
            sync(result)
        self.elapsed = time.perf_counter() - self.t0
        return self.elapsed


@dataclass
class ThroughputMeter:
    """Work done against wall time; ``frames`` are codec frames, at
    ``frame_rate`` per audio second."""

    frame_rate: int = 86
    tokens: int = 0
    frames: int = 0
    steps: int = 0
    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> "ThroughputMeter":
        self._t0 = time.perf_counter()
        return self

    def add(self, *, steps: int = 0, frames: int = 0, tokens: int = 0, result: Any = None) -> None:
        if result is not None:
            sync(result)
        now = time.perf_counter()
        self.seconds += now - self._t0
        self._t0 = now
        self.steps += steps
        self.frames += frames
        self.tokens += tokens

    def report(self) -> dict:
        s = max(self.seconds, 1e-9)
        return {"steps_per_sec": self.steps / s, "tokens_per_sec": self.tokens / s,
                "audio_seconds_per_sec": self.frames / self.frame_rate / s, "wall_seconds": self.seconds}
