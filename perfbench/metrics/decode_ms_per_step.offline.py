"""Wall ms per decoded position of ``generate_tokens`` (prefill and decode
loop) over every call of the traced window, from the benchmark's span."""


def read(facts: dict) -> float | None:
    span = facts.get("spans", {}).get("decode")
    if not span or not span["units"]:
        return None
    return 1e3 * span["seconds"] / span["units"]
