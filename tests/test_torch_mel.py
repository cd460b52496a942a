"""The port's mel module (``utils/mel.py``, torch) against the JAX
package's (``parler_tts_tpu/utils/mel.py``, numpy float64): the mel scale,
the filterbank and the STFT power at 1e-6 relative in float64 (besides
1e-12 absolute for the filters' and bins' exact zeros), the log-mel at 1e-3
dB in float32, ``mel_distance``'s numbers, and the cases of JAX's
``test_mel_utility_basics``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from parler_tts_tpu.utils import mel as jmel
from parler_tts_tpu_torch.utils import mel as pmel

torch.set_num_threads(1)  # tier-1 runs several pytest workers


def _wave(n: int, seed: int = 0) -> np.ndarray:
    """Two tones and some noise, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 3100.0 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_mel_scale_matches_jax():
    f = np.array([0.0, 200.0, 999.0, 1000.0, 4000.0, 22050.0])
    np.testing.assert_allclose(pmel._hz_to_mel(f).numpy(), jmel._hz_to_mel(f), rtol=1e-12, atol=0)
    m = jmel._hz_to_mel(f)
    np.testing.assert_allclose(pmel._mel_to_hz(m).numpy(), jmel._mel_to_hz(m), rtol=1e-12, atol=0)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [(16000, 1024, 80, 0.0, None), (44100, 2048, 128, 0.0, None),
                                                      (24000, 512, 40, 50.0, 8000.0)])
def test_filterbank_matches_jax(sr, n_fft, n_mels, fmin, fmax):
    got = pmel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    want = jmel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("n,n_fft,hop", [(16000, 1024, 256), (3001, 512, 128), (300, 1024, 256), (0, 1024, 256)],
                         ids=["1s", "odd", "shorter-than-pad", "empty"])
def test_stft_power_matches_jax_in_float64(n, n_fft, hop):
    wave = _wave(n).astype(np.float64)
    got = pmel.stft_power(torch.from_numpy(wave), n_fft=n_fft, hop=hop)
    want = jmel.stft_power(wave, n_fft=n_fft, hop=hop)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12 * max(want.max(), 1.0))


@pytest.mark.parametrize("sr", [16000, 44100])
def test_log_mel_matches_jax_in_float32(sr):
    wave = _wave(sr // 2, seed=1)
    got = pmel.log_mel_spectrogram(torch.from_numpy(wave), sr)
    want = jmel.log_mel_spectrogram(wave, sr)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_mel_distance_matches_jax():
    a, b = _wave(8000, seed=2), _wave(7900, seed=3)
    got = pmel.mel_distance(torch.from_numpy(a).double(), b.astype(np.float64), 16000)
    want = jmel.mel_distance(a.astype(np.float64), b.astype(np.float64), 16000)
    assert got.keys() == want.keys() and all(isinstance(v, (int, float)) for v in got.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


def test_mel_utility_basics():
    """JAX's ``test_mel_utility_basics`` on the port: a 440 Hz tone gives 80
    mel bins over more than 50 frames, identical waveforms a distance of
    exactly 0, another tone more than 3 dB."""
    sr = 16000
    t = np.arange(sr) / sr
    tone = torch.from_numpy(np.sin(2 * np.pi * 440.0 * t).astype(np.float32))
    mel = pmel.log_mel_spectrogram(tone, sr)
    assert mel.shape[1] == 80 and mel.shape[0] > 50
    d = pmel.mel_distance(tone, tone.clone(), sr)
    assert d["mel_max_abs_db"] == 0.0 and d["wave_max_abs"] == 0.0
    other = torch.from_numpy(np.sin(2 * np.pi * 880.0 * t).astype(np.float32))
    assert pmel.mel_distance(tone, other, sr)["mel_max_abs_db"] > 3.0
