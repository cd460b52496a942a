"""Device ms of the expert matmuls (the kernels listed under
``perfbench/kernels/moe_experts/``) per decode step of the profiled call,
the steps from the program's ``decode.replays`` counter."""


def read(facts: dict) -> float | None:
    trace, steps = facts.get("trace"), facts.get("counters", {}).get("decode.replays")
    if trace is None or not steps or not facts.get("kernels", {}).get("moe_experts"):
        return None
    seconds = trace.kernel_seconds(facts["kernels"]["moe_experts"])
    return 1e3 * seconds / steps if seconds > 0 else None
