"""The readers of the program's spans (``perfbench/spans.py`` and the three
metrics over it) on a synthetic profiled call: nothing to read reads None,
the spans' event clock is placed on the trace's, and an idle gap counts in
the metric of the span it falls in and in no other."""

from __future__ import annotations

from pathlib import Path

import pytest

from perfbench import harness, spans
from perfbench.trace import Trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"
READERS = ["prefill_ms_per_call.offline", "decode_idle_share.offline", "vocode_idle_share.offline"]
SHIFT_US = 5000.0  # the trace's clock minus the events' clock


def record(name, start_us, end_us, *, ident, parent=1):
    return {"name": name, "id": ident, "parent": parent, "call": 1, "attrs": {},
            "device_start_s": start_us / 1e6, "device_end_s": end_us / 1e6, "device_s": (end_us - start_us) / 1e6}


def call(gap: tuple[float, float] | None = None):
    """A call on the events' clock: prefill 10-110 us, two segments
    120-520 and 530-930 us, a codec group 940-1340 us, in a root 0-1400 us;
    the trace's device operations fill each span from 5 us after its start
    to 5 us before its end, in 50 us kernels, less an optional idle
    ``gap`` (events' clock)."""
    spans_ = [record("tts", 0, 1400, ident=1, parent=None), record("generate.prefill", 10, 110, ident=2),
              record("generate.segment", 120, 520, ident=3), record("generate.segment", 530, 930, ident=4),
              record("codec.decode", 940, 1340, ident=5)]
    device = []
    for s in spans_[1:]:
        t, end = 1e6 * s["device_start_s"] + 5, 1e6 * s["device_end_s"] - 5
        while t < end:
            a, b = t, min(t + 50, end)
            if gap is not None and a < gap[1] and b > gap[0]:
                if a < gap[0]:
                    device.append((a + SHIFT_US, gap[0] + SHIFT_US, "k"))
                if b > gap[1]:
                    device.append((gap[1] + SHIFT_US, b + SHIFT_US, "k"))
            else:
                device.append((a + SHIFT_US, b + SHIFT_US, "k"))
            t = b
    return spans_, Trace(window_s=1400e-6, device=device, host=[])


def read(name: str, facts: dict, records: list[dict], monkeypatch) -> float | None:
    monkeypatch.setattr(spans, "program_spans", lambda: records)
    return harness.load_module(METRICS / f"{name}.py").read(facts)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_without_its_spans(name, monkeypatch):
    records, trace = call()
    assert read(name, {}, records, monkeypatch) is None  # an untraced run
    assert read(name, {"trace": trace}, [], monkeypatch) is None  # a program without spans
    untimed = [dict(r, device_s=None, device_start_s=None, device_end_s=None) for r in records]
    assert read(name, {"trace": trace}, untimed, monkeypatch) is None  # spans without device events


def test_the_events_clock_is_placed_on_the_trace_s():
    records, trace = call()
    assert spans.offset_us(trace, records) == pytest.approx(SHIFT_US, abs=5.0)


def test_an_idle_gap_counts_only_in_the_span_it_falls_in(monkeypatch):
    """A 100 us gap in the codec group's kernels raises the vocoder's idle
    share by 100 us of its 400 and moves neither the decode loop's share
    nor the prefill."""
    before = {name: read(name, {"trace": call()[1]}, call()[0], monkeypatch) for name in READERS}
    records, trace = call(gap=(1100.0, 1200.0))
    after = {name: read(name, {"trace": trace}, records, monkeypatch) for name in READERS}
    assert before["prefill_ms_per_call.offline"] == after["prefill_ms_per_call.offline"] == pytest.approx(0.1)
    assert before["decode_idle_share.offline"] == pytest.approx(after["decode_idle_share.offline"], abs=1e-6)
    assert before["decode_idle_share.offline"] == pytest.approx(100 * 20 / 800, abs=0.01)
    assert after["vocode_idle_share.offline"] - before["vocode_idle_share.offline"] == pytest.approx(25.0, abs=0.01)
