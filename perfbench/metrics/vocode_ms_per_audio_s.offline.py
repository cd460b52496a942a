"""Wall ms of the codec's decode per audio second it produced, over every
call of the traced window, from the benchmark's span."""


def read(facts: dict) -> float | None:
    span = facts.get("spans", {}).get("vocode")
    if not span or not span["units"]:
        return None
    return 1e3 * span["seconds"] / span["units"]
