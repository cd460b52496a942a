"""Quality metrics of the eval generation pass: WER and CLAP.

Port of ``parler_tts_tpu/training/eval_metrics.py``.  ``word_error_rate``
is the JAX package's corpus-level word Levenshtein, copied.  ``WerMetric``
(an ASR model's transcripts against the prompts) and ``ClapMetric`` (CLAP
text-audio similarity) keep the JAX constructors and output keys, but their
models come from ``transformers``, which the port does not use and the
card's machine does not have.  They therefore report what the JAX hooks
report on a machine without the checkpoints: ``{"wer": nan,
"wer_available": 0.0}`` and ``{"clap": nan, "clap_available": 0.0}``.
Running the models waits for ROADMAP.md queue 1 ("WER and CLAP models").
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_WAITS = "the ASR and CLAP models need transformers, which the port does not use (ROADMAP.md queue 1)"


class WerMetric:
    """Word error rate of an ASR model's transcripts against the prompts;
    always unavailable in the port (see the module docstring)."""

    def __init__(self, asr_model_name_or_path: str, *, device: str = "cpu", batch_size: int = 8):
        self.model_name = asr_model_name_or_path
        self.device, self.batch_size = device, batch_size
        self.available = False
        self.error = _WAITS

    def __call__(self, prompts: Sequence[str], audio: Sequence[np.ndarray], sampling_rate: int) -> dict:
        return {"wer": float("nan"), "wer_available": 0.0}


class ClapMetric:
    """CLAP text-audio cosine similarity; always unavailable in the port."""

    def __init__(self, clap_model_name_or_path: str):
        self.model_name = clap_model_name_or_path
        self.available = False
        self.error = _WAITS

    def __call__(self, descriptions: Sequence[str], audio: Sequence[np.ndarray], sampling_rate: int) -> dict:
        return {"clap": float("nan"), "clap_available": 0.0}


def word_error_rate(refs: Sequence[str], hyps: Sequence[str]) -> float:
    """Corpus-level WER: word-level Levenshtein distance over the reference
    word count, after lower-casing and replacing punctuation by spaces."""
    total_err, total_words = 0, 0
    for ref, hyp in zip(refs, hyps):
        r, h = _norm(ref), _norm(hyp)
        total_err += _edit_distance(r, h)
        total_words += len(r)
    return total_err / max(total_words, 1)


def _norm(s: str) -> list[str]:
    return "".join(c.lower() if c.isalnum() or c.isspace() else " " for c in s).split()


def _edit_distance(a: list[str], b: list[str]) -> int:
    dp = list(range(len(b) + 1))
    for i, wa in enumerate(a, 1):
        prev, dp[0] = dp[0], i
        for j, wb in enumerate(b, 1):
            cur = min(dp[j] + 1, dp[j - 1] + 1, prev + (wa != wb))
            prev, dp[j] = dp[j], cur
    return dp[len(b)]
