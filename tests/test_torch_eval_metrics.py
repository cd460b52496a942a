"""The port's WER and CLAP hooks (``training/eval_metrics.py``) against the
JAX package's on tiny Whisper and CLAP checkpoints built locally with
``tokenizers`` and ``transformers`` (``tests/test_eval_metrics_models.py``'s
fixtures; nothing is downloaded): the same WER exactly, CLAP within 1e-6 on
48 kHz clips and on 44.1 kHz clips (the resampling path), with numpy's
global generator seeded alike before each call (CLAP's fusion feature
extractor marks one random clip "longer" with it when none is over 10 s); a
missing
checkpoint, or a directory that holds none, reports unavailable with the
reason in ``error``."""

from __future__ import annotations

import numpy as np
import pytest

from parler_tts_tpu.training import eval_metrics as jeval
from parler_tts_tpu_torch.training import eval_metrics as peval
from tests.test_eval_metrics_models import tiny_clap, tiny_whisper  # noqa: F401  (fixtures)

CLAP_TOL = 1e-6


def _clips(sr: int, seconds=(1.0, 0.5, 0.75)) -> list[np.ndarray]:
    rng = np.random.default_rng(sr)
    return [(0.1 * rng.standard_normal(int(s * sr))).astype(np.float32) for s in seconds]


def test_wer_equals_the_jax_hook(tiny_whisper):  # noqa: F811
    prompts = ["hey how are you", "say row number zero", "doing today"]
    audio = _clips(16000)
    port, ref = peval.WerMetric(tiny_whisper, batch_size=2), jeval.WerMetric(tiny_whisper, batch_size=2)
    assert port.available and ref.available, port.error
    got, want = port(prompts, audio, 16000), ref(prompts, audio, 16000)
    assert got["wer_available"] == want["wer_available"] == 1.0
    assert got["wer"] == want["wer"] and np.isfinite(got["wer"])


@pytest.mark.parametrize("sr", [48000, 44100])
def test_clap_equals_the_jax_hook(tiny_clap, sr):  # noqa: F811
    descriptions = ["a female speaker", "clear audio", "a low pitched voice"]
    audio = _clips(sr)
    port, ref = peval.ClapMetric(tiny_clap), jeval.ClapMetric(tiny_clap)
    assert port.available and ref.available, port.error
    np.random.seed(0)
    got = port(descriptions, audio, sr)
    np.random.seed(0)
    want = ref(descriptions, audio, sr)
    assert got["clap_available"] == want["clap_available"] == 1.0
    assert -1.0 <= got["clap"] <= 1.0 and abs(got["clap"] - want["clap"]) <= CLAP_TOL


@pytest.mark.parametrize("where", ["missing", "empty"])
def test_a_missing_checkpoint_reports_unavailable(tmp_path, where):
    path = str(tmp_path / "nope") if where == "missing" else str(tmp_path)
    for hook, key, sr in ((peval.WerMetric(path), "wer", 16000), (peval.ClapMetric(path), "clap", 48000)):
        assert not hook.available and hook.error
        out = hook(["x"], [np.zeros(160, np.float32)], sr)
        assert set(out) == {key, f"{key}_available"} and out[f"{key}_available"] == 0.0 and np.isnan(out[key])
