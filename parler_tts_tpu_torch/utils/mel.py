"""Log-mel spectrograms and the mel distance between two waveforms.

Port of ``parler_tts_tpu/utils/mel.py`` on torch tensors of any device: a
Hann-windowed, reflect-centred STFT and a Slaney-normalized mel filterbank
(librosa's defaults), log10-compressed with a floor 80 dB below the
utterance's peak, so that silence compares as silence.  Each function
computes in its input's floating dtype (float64 reproduces the numpy
module's numbers; float32 runs faster on the card).  The quality gate
(``helpers/quality_gate_torch.py``) compares waveforms with
``mel_distance``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f) -> torch.Tensor:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = torch.as_tensor(f, dtype=torch.float64)
    log_region = 15.0 + torch.log(f.clamp(min=1e-10) / 1000.0) / _LOGSTEP
    return torch.where(f >= 1000.0, log_region, f / (200.0 / 3.0))


def _mel_to_hz(m) -> torch.Tensor:
    m = torch.as_tensor(m, dtype=torch.float64)
    return torch.where(m >= 15.0, 1000.0 * torch.exp(_LOGSTEP * (m - 15.0)), m * (200.0 / 3.0))


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None, *,
                   dtype: torch.dtype = torch.float64, device: str | torch.device = "cpu") -> torch.Tensor:
    """(n_mels, 1 + n_fft // 2) triangular filters, Slaney area-normalized,
    built in float64 and returned in ``dtype`` on ``device``."""
    fmax = fmax if fmax is not None else sr / 2.0
    fft_freqs = torch.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=torch.float64)
    mel_pts = _mel_to_hz(torch.linspace(float(_hz_to_mel(fmin)), float(_hz_to_mel(fmax)), n_mels + 2,
                                        dtype=torch.float64))
    lo, ctr, hi = mel_pts[:-2, None], mel_pts[1:-1, None], mel_pts[2:, None]
    up = (fft_freqs - lo) / (ctr - lo).clamp(min=1e-10)
    down = (hi - fft_freqs) / (hi - ctr).clamp(min=1e-10)
    fb = torch.minimum(up, down).clamp(min=0.0) * (2.0 / (hi - lo))
    return fb.to(device=device, dtype=dtype)


def _floating(wave) -> torch.Tensor:
    wave = torch.as_tensor(wave)
    return wave if wave.is_floating_point() else wave.double()


def stft_power(wave, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """|STFT|^2 of a mono waveform (T,) -> (frames, 1 + n_fft // 2): Hann
    window, reflect-padded centred frames (zero-padded when the waveform is
    no longer than the padding)."""
    wave = _floating(wave)
    pad = n_fft // 2
    if wave.numel() == 0:
        wave = wave.new_zeros(1)
    mode = "reflect" if wave.numel() > pad else "constant"
    x = F.pad(wave[None, None], (pad, pad), mode=mode)[0, 0]
    frames = x.unfold(0, n_fft, hop) * torch.hann_window(n_fft, periodic=True, dtype=wave.dtype, device=wave.device)
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real**2 + spec.imag**2


def log_mel_spectrogram(wave, sr: int, *, n_fft: int = 1024, hop: int = 256, n_mels: int = 80) -> torch.Tensor:
    """Mono waveform -> (frames, n_mels) log10 mel spectrogram in dB, floored
    80 dB below its peak."""
    power = stft_power(wave, n_fft=n_fft, hop=hop)
    mel = power @ mel_filterbank(sr, n_fft, n_mels, dtype=power.dtype, device=power.device).T
    log_mel = 10.0 * torch.log10(mel.clamp(min=1e-10))
    return torch.maximum(log_mel, log_mel.max() - 80.0) if log_mel.numel() else log_mel


def mel_distance(a, b, sr: int, **kw) -> dict:
    """Two waveforms (tensors or arrays) compared over their common length:
    the max and mean absolute log-mel difference (dB), the max absolute
    waveform difference and the length mismatch, as plain numbers."""
    a = _floating(a)
    b = _floating(b).to(a.device)
    n = min(a.numel(), b.numel())
    d = (log_mel_spectrogram(a[:n], sr, **kw) - log_mel_spectrogram(b[:n], sr, **kw)).abs()
    return {
        "mel_max_abs_db": float(d.max()) if d.numel() else 0.0,
        "mel_mean_abs_db": float(d.mean()) if d.numel() else 0.0,
        "wave_max_abs": float((a[:n] - b[:n]).abs().max()) if n else 0.0,
        "length_mismatch": int(abs(a.numel() - b.numel())),
    }
