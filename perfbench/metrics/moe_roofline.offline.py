"""Percent of their roofline that the expert matmuls reach in the profiled
call: ``perfbench/flops_lfm2.py``'s least time for the call's experts (each
touched expert's weights read once per MoE call against the routed pairs'
operations, from the program's ``moe.*`` counters) over the device time of
the kernels listed under ``perfbench/kernels/moe_experts/``."""

from perfbench import flops


def read(facts: dict) -> float | None:
    trace, bound = facts.get("trace"), facts.get("bounds", {}).get("moe_experts")
    if trace is None or not bound or not facts.get("kernels", {}).get("moe_experts"):
        return None
    seconds = trace.kernel_seconds(facts["kernels"]["moe_experts"])
    return flops.share(bound, seconds) if seconds > 0 else None
