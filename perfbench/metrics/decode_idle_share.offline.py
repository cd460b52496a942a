"""Percent of the device-side extent of the profiled call's
``generate.segment`` spans (the captured decode loop) in which no device
operation ran (``perfbench/spans.py``)."""

from perfbench import spans


def read(facts: dict) -> float | None:
    return spans.idle_share(facts.get("trace"), spans.program_spans(), "generate.segment")
