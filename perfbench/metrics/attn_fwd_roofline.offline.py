"""Percent of its roofline that the attention forward reaches in the
profiled call: the least time ``perfbench/flops.py`` gives for the call's
prefill attention, over the device time of the kernels listed under
``perfbench/kernels/attn_fwd/``."""

from perfbench import flops


def read(facts: dict) -> float | None:
    trace, bound = facts.get("trace"), facts.get("bounds", {}).get("attn_fwd")
    if trace is None or not bound:
        return None
    seconds = trace.kernel_seconds(facts["kernels"]["attn_fwd"])
    return flops.share(bound, seconds) if seconds > 0 else None
