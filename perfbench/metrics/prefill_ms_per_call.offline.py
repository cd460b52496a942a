"""Device ms of the program's ``generate.prefill`` spans (T5 encode, prompt
embedding, decoder prefill; CUDA events) per ``tts`` call, over the
profiled call (``perfbench/spans.py``)."""

from perfbench import spans


def read(facts: dict) -> float | None:
    if facts.get("trace") is None:
        return None
    return spans.prefill_ms(spans.program_spans())
