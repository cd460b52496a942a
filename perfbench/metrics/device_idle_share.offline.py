"""Percent of the profiled call in which no device operation ran."""


def read(facts: dict) -> float | None:
    trace = facts.get("trace")
    return None if trace is None else trace.idle_share()
