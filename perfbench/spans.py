"""The program's own spans, read after a traced run.

A running ``torch.profiler`` turns the program's spans on
(``parler_tts_tpu_torch/utils/profiling.py``), so the driver's profiled
call leaves its span records in the program's memory: the last ``tts`` call
there is that call.  A program without these spans leaves nothing to read,
and every reader here then reads None.

A span's device start and end come from its CUDA events, in seconds from
its call's first event: the card's event clock, not the profiler's.
``offset_us`` finds the one shift that puts them on the profiler's clock:
every span boundary is an event on the stream the call's work runs on, so
it completes between two device operations and never inside one; of the
shifts that keep the whole call's device work inside its ``tts`` span, the
one that puts the fewest boundaries inside a device operation is taken
(the median of those that tie).  On the H100 the two clocks part by up to
0.1 % for seconds of a call and meet again, so no shift fits every
boundary; the shares move little with the shift, since a misplaced
boundary between two spans of one kind moves idle time from one to the
other and not out of their sum (PERF.md, PR 18).
"""

from __future__ import annotations

import numpy as np

#: how far inside a device operation a boundary may seem to fall and still
#: count as on its edge: the event clock's resolution and float32 ms
EDGE_US = 3.0


def program_spans() -> list[dict]:
    """The span records of the program's last ``tts`` call, or [] when the
    program keeps none."""
    try:
        from parler_tts_tpu_torch.utils import profiling
    except ImportError:
        return []
    records = getattr(profiling, "records", None)
    if records is None:
        return []
    spans = records()
    roots = [s for s in spans if s["name"] == "tts" and s["parent"] is None]
    return [s for s in spans if s["call"] == roots[-1]["id"]] if roots else []


def timed(spans: list[dict], name: str) -> list[dict]:
    return [s for s in spans if s["name"] == name and s.get("device_s") is not None]


def prefill_ms(spans: list[dict]) -> float | None:
    """Device ms of the ``generate.prefill`` spans per ``tts`` call."""
    prefills, calls = timed(spans, "generate.prefill"), {s["call"] for s in spans if s["name"] == "tts"}
    if not prefills or not calls:
        return None
    return 1e3 * sum(s["device_s"] for s in prefills) / len(calls)


def _merged(trace) -> tuple[np.ndarray, np.ndarray]:
    merged = np.array(trace.merged(), dtype=np.float64).reshape(-1, 2)
    return merged[:, 0], merged[:, 1]


def _inside(starts: np.ndarray, ends: np.ndarray, t: np.ndarray) -> np.ndarray:
    """How many of the times ``t`` (us) fall inside a merged device
    interval by more than ``EDGE_US``."""
    i = np.searchsorted(starts, t, side="right") - 1
    ok = i >= 0
    j = np.where(ok, i, 0)
    return ok & (t > starts[j] + EDGE_US) & (t < ends[j] - EDGE_US)


def _offset(starts: np.ndarray, ends: np.ndarray, spans: list[dict]) -> float | None:
    roots = [s for s in timed(spans, "tts") if s["parent"] is None]
    if not roots or not len(starts):
        return None
    root = roots[-1]
    hi = starts[0] - 1e6 * root["device_start_s"]
    lo = ends[-1] - 1e6 * root["device_end_s"]
    if lo > hi:
        return None
    events = np.unique([1e6 * s[k] for s in spans if s.get("device_s") is not None
                        for k in ("device_start_s", "device_end_s")])
    edges = np.sort(np.concatenate([starts, ends]))
    near = [edges[np.searchsorted(edges, e + lo):np.searchsorted(edges, e + hi, side="right")] - e for e in events]
    candidates = np.unique(np.concatenate(near + [np.array([lo, hi])]))
    cost = np.array([_inside(starts, ends, events + c).sum() for c in candidates])
    return float(np.median(candidates[cost == cost.min()]))


def offset_us(trace, spans: list[dict]) -> float | None:
    """The shift (us) from the spans' device clock to the trace's (module
    docstring), or None without a timed ``tts`` span or device work."""
    if trace is None or not trace.device:
        return None
    return _offset(*_merged(trace), spans)


def idle_share(trace, spans: list[dict], name: str) -> float | None:
    """Percent of the device-side extent of the ``name`` spans in which no
    device operation of ``trace`` ran."""
    chosen = timed(spans, name)
    if trace is None or not trace.device or not chosen:
        return None
    starts, ends = _merged(trace)
    shift = _offset(starts, ends, spans)
    if shift is None:
        return None
    busy_before = np.concatenate([[0.0], np.cumsum(ends - starts)])
    extent = idle = 0.0
    for s in chosen:
        a, b = 1e6 * s["device_start_s"] + shift, 1e6 * s["device_end_s"] + shift
        i, j = np.searchsorted(ends, a, side="right"), np.searchsorted(starts, b)  # the intervals [i, j) meet (a, b)
        busy = 0.0
        if j > i:
            busy = busy_before[j] - busy_before[i] - max(0.0, a - starts[i]) - max(0.0, ends[j - 1] - b)
        extent += b - a
        idle += (b - a) - busy
    return 100.0 * idle / extent if extent > 0 else None
