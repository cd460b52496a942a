"""Percent of the device-side extent of the profiled call's
``codec.decode`` spans (the vocoder, per group of rows) in which no device
operation ran (``perfbench/spans.py``)."""

from perfbench import spans


def read(facts: dict) -> float | None:
    return spans.idle_share(facts.get("trace"), spans.program_spans(), "codec.decode")
