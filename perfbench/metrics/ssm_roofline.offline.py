"""Percent of its roofline that K8, the Mamba-2 state update, reaches in
the profiled call: ``perfbench/flops_nemotron_h.py``'s least time for the
call's launches (the fp32 state read and written once a step, from the
program's ``decode.ssm_state_bytes``, and the step's inputs and outputs at
3.35 TB/s) over the device time of the kernels listed under
``perfbench/kernels/ssm_step/``."""

from perfbench import flops


def read(facts: dict) -> float | None:
    trace, bound = facts.get("trace"), facts.get("bounds", {}).get("ssm_step")
    if trace is None or not bound or not facts.get("kernels", {}).get("ssm_step"):
        return None
    seconds = trace.kernel_seconds(facts["kernels"]["ssm_step"])
    return flops.share(bound, seconds) if seconds > 0 else None
