"""Device ms of K8, the Mamba-2 state update (the kernels listed under
``perfbench/kernels/ssm_step/``; every Mamba layer's launch), per decode
step of the profiled call, the steps from the program's ``decode.replays``
counter."""


def read(facts: dict) -> float | None:
    trace, steps = facts.get("trace"), facts.get("counters", {}).get("decode.replays")
    if trace is None or not steps or not facts.get("kernels", {}).get("ssm_step"):
        return None
    seconds = trace.kernel_seconds(facts["kernels"]["ssm_step"])
    return 1e3 * seconds / steps if seconds > 0 else None
