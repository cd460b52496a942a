"""Percent of the card's bf16 peak that the window's model FLOPs (T5,
decoder prefill, decode steps and vocode over the real rows, counted from
shapes by ``perfbench/flops.py``) reach over the window."""

from perfbench import flops


def read(facts: dict) -> float | None:
    if not facts.get("model_flops") or not facts.get("window_s"):
        return None
    return 100.0 * facts["model_flops"] / (facts["window_s"] * flops.PEAK_BF16_FLOPS)
