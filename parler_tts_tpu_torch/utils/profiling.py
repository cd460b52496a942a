"""Spans, counters and the device wait (port of
``parler_tts_tpu/utils/profiling.py``).

* ``span(name, device=None, **attrs)``: a context manager around one layer's
  work.  Off, it is a shared no-op after one flag read: no clock, no event,
  no record.  On (inside ``tracing()``, between ``start()`` and ``stop()``,
  and while a ``torch.profiler`` records, so that every profile of the
  program holds its layers), it records its name, span id, parent span id
  and call id (the id of the outermost span open on its thread: a thread
  has its own tree), host start and end (``time.perf_counter_ns``), its
  attributes (``units`` among them: the work it did, summed by name), and,
  when ``device`` is a CUDA device and its current stream is not being
  captured, two timing events on that stream, read only when the records
  are.  It enters ``torch.profiler.record_function(name)``, so a profiler's
  trace holds it beside the device's kernels on one clock.  Records stay in
  memory, the newest ``RECORDS``; ``records()`` and ``summary()`` (count,
  host seconds, device seconds and units by name) read them, ``reset()``
  clears them.  No span sits inside a function that a graph captures.
* ``count(name, n=1)`` and ``count_max(name, value)``: counters, always on;
  ``counters()`` is a snapshot.
* ``trace(logdir)``: ``torch.profiler`` around a block (the host, and the
  card when there is one), written as a Chrome trace, ``logdir/trace.json``,
  with the program's spans in it;
* ``sync(x)``: wait for the card's work behind ``x``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Iterator

import torch
from torch.autograd import profiler as _torch_profiler
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
#: span records kept in memory; the oldest go first
RECORDS = 100_000

_on = False
_ids = itertools.count(1)
_local = threading.local()  # .stack: the thread's open spans; .anchor: its call's first device event
_lock = threading.Lock()
_records: collections.deque[Span] = collections.deque(maxlen=RECORDS)
_unread: collections.deque[Span] = collections.deque()  # records whose device events are not read yet
_sums: dict[str, dict[str, float]] = {}
_counters: dict[str, float] = {}


class _Off:
    """The span of tracing off: enters, leaves and takes attributes, and
    records nothing."""

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _stack() -> list[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One layer's work; see the module docstring.  ``set(**attrs)`` adds
    attributes learnt inside it."""

    __slots__ = ("name", "device", "attrs", "id", "parent", "call", "thread", "start_ns", "end_ns", "device_s",
                 "device_start_s", "device_end_s", "_events", "_annotation")

    def __init__(self, name: str, device: torch.device | None, attrs: dict):
        self.name, self.device, self.attrs = name, device, attrs
        self.device_s = self.device_start_s = self.device_end_s = None
        self._events = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _place(self, stack: list[Span]) -> None:
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.call = self.id if parent is None else parent.call
        self.thread = threading.current_thread().name

    def __enter__(self) -> "Span":
        stack = _stack()
        self._place(stack)
        self._annotation = record_function(self.name)
        self._annotation.__enter__()
        stack.append(self)
        if self.device is not None and self.device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            if getattr(_local, "anchor", None) is None:
                _local.anchor = start
            self._events = (_local.anchor, start, torch.cuda.Event(enable_timing=True))
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[2].record(torch.cuda.current_stream(self.device))
        self.end_ns = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        if not stack:
            _local.anchor = None
        self._annotation.__exit__(None, None, None)
        _keep(self)
        return False

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent, "call": self.call, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "attrs": dict(self.attrs),
                "device_s": self.device_s, "device_start_s": self.device_start_s,
                "device_end_s": self.device_end_s}


def _read_events(span: Span) -> None:
    """The span's device seconds, and its start and end from its call's
    first device event; the events are then let go.  Caller holds
    ``_lock``."""
    anchor, start, end = span._events
    end.synchronize()
    span.device_s = start.elapsed_time(end) / 1e3
    span.device_start_s = anchor.elapsed_time(start) / 1e3
    span.device_end_s = span.device_start_s + span.device_s
    span._events = None
    _sums[span.name]["device_s"] += span.device_s


def span(name: str, device: torch.device | None = None, **attrs) -> Span | _Off:
    """A span named ``name`` around the ``with`` block (module docstring);
    ``device``: the card whose current stream it times, None for host
    work."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, device, attrs)


def _keep(span: Span) -> None:
    with _lock:
        _records.append(span)
        s = _sums.setdefault(span.name, {"count": 0, "host_s": 0.0, "device_s": 0.0, "units": 0.0})
        s["count"] += 1
        s["host_s"] += (span.end_ns - span.start_ns) / 1e9
        s["units"] += span.attrs.get("units", 0.0)
        if span._events is not None:
            _unread.append(span)
            if len(_unread) > RECORDS:
                _read_events(_unread.popleft())


def add_span(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """A finished host span (``time.perf_counter_ns`` ends) under the span
    open on this thread: a wait that began on another thread."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return
    s = Span(name, None, attrs)
    s._place(_stack())
    s.start_ns, s.end_ns = start_ns, end_ns
    _keep(s)


def start() -> None:
    """Tracing on."""
    global _on
    _on = True


def stop() -> None:
    """Tracing off (a profiler that records keeps it on)."""
    global _on
    _on = False


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Tracing on inside the block."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def _read_all() -> None:
    with _lock:
        while _unread:
            _read_events(_unread.popleft())


def records() -> list[dict]:
    """The kept span records, oldest first (their device events read:
    waits for the card to pass them)."""
    _read_all()
    with _lock:
        return [s.as_dict() for s in _records]


def summary() -> dict[str, dict[str, float]]:
    """Count, host seconds, device seconds and units by span name, over every
    span since the last ``reset()``, dropped records included."""
    _read_all()
    with _lock:
        return {name: dict(s) for name, s in _sums.items()}


def reset() -> None:
    """Forget the span records and their sums (not the counters)."""
    _read_all()
    with _lock:
        _records.clear()
        _sums.clear()


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def count_max(name: str, value: float) -> None:
    """The counter ``name`` raised to ``value`` if it is below."""
    with _lock:
        _counters[name] = max(_counters.get(name, value), value)


def counters() -> dict[str, float]:
    """Every counter's value now."""
    with _lock:
        return dict(_counters)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the block; yields the profiler (``key_averages()`` for sums
    by kernel) and writes ``logdir/trace.json`` when the block ends.  The
    program's spans are on while it records."""
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
