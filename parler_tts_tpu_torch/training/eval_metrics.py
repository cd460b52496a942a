"""Quality metrics of the eval generation pass: WER and CLAP.

Port of ``parler_tts_tpu/training/eval_metrics.py``.  ``word_error_rate``
is the JAX package's corpus-level word Levenshtein, copied.  ``WerMetric``
(an ASR model's transcripts against the prompts) and ``ClapMetric`` (CLAP
text-audio cosine similarity) run ``transformers`` models from a local
checkpoint directory, as the JAX hooks do; ``transformers`` is imported
inside their constructors only, since the card's machine has none.  A hook
whose checkpoint is not a local directory, or whose import or load fails,
reports itself unavailable, ``{"wer": nan, "wer_available": 0.0}`` or
``{"clap": nan, "clap_available": 0.0}``, with the reason in ``error``.
A Hub id is not resolved: the hooks never reach the network.
"""

from __future__ import annotations

import inspect
import os
from typing import Sequence

import numpy as np
import torch

from parler_tts_tpu_torch.utils.audio_io import resample_linear


def _no_checkpoint(path: str) -> str | None:
    if os.path.isdir(path):
        return None
    return f"{path}: not a local checkpoint directory (the hooks load nothing over the network)"


class WerMetric:
    """Word error rate of an ASR model's transcripts against the prompts.
    The ASR pipeline runs on ``device`` (the host's CPU by default, as in
    the JAX package), ``batch_size`` clips per call."""

    def __init__(self, asr_model_name_or_path: str, *, device: str = "cpu", batch_size: int = 8):
        self.available = False
        self.batch_size = batch_size
        self.error = _no_checkpoint(asr_model_name_or_path)
        if self.error:
            return
        try:
            from transformers import pipeline

            self.pipe = pipeline("automatic-speech-recognition", model=asr_model_name_or_path, device=device)
            self.available = True
        except Exception as e:  # no transformers, or a checkpoint it cannot load
            self.error = str(e)

    def __call__(self, prompts: Sequence[str], audio: Sequence[np.ndarray], sampling_rate: int) -> dict:
        if not self.available:
            return {"wer": float("nan"), "wer_available": 0.0}
        outs = self.pipe([{"array": np.asarray(a, np.float32), "sampling_rate": sampling_rate} for a in audio],
                         batch_size=self.batch_size)
        return {"wer": word_error_rate(prompts, [o["text"] for o in outs]), "wer_available": 1.0}


class ClapMetric:
    """CLAP text-audio cosine similarity, the mean over the clips; each clip
    is resampled (``utils/audio_io.resample_linear``) to the processor's
    rate first, which CLAP's feature extractor requires."""

    def __init__(self, clap_model_name_or_path: str):
        self.available = False
        self.error = _no_checkpoint(clap_model_name_or_path)
        if self.error:
            return
        try:
            from transformers import AutoProcessor, ClapModel

            self.model = ClapModel.from_pretrained(clap_model_name_or_path).eval()
            self.processor = AutoProcessor.from_pretrained(clap_model_name_or_path)
            self.available = True
        except Exception as e:  # no transformers, or a checkpoint it cannot load
            self.error = str(e)

    def __call__(self, descriptions: Sequence[str], audio: Sequence[np.ndarray], sampling_rate: int) -> dict:
        if not self.available:
            return {"clap": float("nan"), "clap_available": 0.0}
        clap_sr = getattr(getattr(self.processor, "feature_extractor", None), "sampling_rate", sampling_rate)
        clips = [np.asarray(a, np.float32) for a in audio]
        if clap_sr != sampling_rate:
            clips = [resample_linear(c[None], sampling_rate, clap_sr)[0] for c in clips]
        # newer processors name the keyword ``audio``; older ones only ``audios``
        audio_kw = "audio" if "audio" in inspect.signature(self.processor.__call__).parameters else "audios"
        inputs = self.processor(text=list(descriptions), **{audio_kw: clips}, sampling_rate=clap_sr,
                                return_tensors="pt", padding=True)
        with torch.no_grad():
            out = self.model(**inputs)
        sim = torch.nn.functional.cosine_similarity(out.audio_embeds, out.text_embeds).mean()
        return {"clap": float(sim), "clap_available": 1.0}


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
