"""WAV read and write with the standard library's ``wave`` (no libsndfile).

The port's own copy of ``parler_tts_tpu/utils/audio_io.py``: 16-bit PCM,
mono or multichannel, and the same truncating float -> int16 conversion, so
both packages write the same bytes for the same waveform.
"""

from __future__ import annotations

import io
import wave

import numpy as np


def write_wav(path_or_buf, audio: np.ndarray, sampling_rate: int) -> None:
    """audio: (T,) or (C, T) float in [-1, 1], or int16 PCM as it is ->
    16-bit WAV."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None]
    if audio.dtype == np.int16:
        pcm = audio.astype("<i2", copy=False)
    else:
        pcm = (np.clip(audio.astype(np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    interleaved = pcm.T.reshape(-1)
    f = wave.open(path_or_buf, "wb")
    try:
        f.setnchannels(audio.shape[0])
        f.setsampwidth(2)
        f.setframerate(sampling_rate)
        f.writeframes(interleaved.tobytes())
    finally:
        f.close()


def wav_bytes(audio: np.ndarray, sampling_rate: int) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, audio, sampling_rate)
    return buf.getvalue()


def read_wav(path_or_buf) -> tuple[np.ndarray, int]:
    """-> ((C, T) float32 in [-1, 1], sampling_rate)."""
    f = wave.open(path_or_buf, "rb")
    try:
        n = f.getnframes()
        sr = f.getframerate()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    finally:
        f.close()
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return x.reshape(-1, ch).T, sr


def resample_linear(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler along the last axis."""
    if sr_in == sr_out:
        return audio
    t = audio.shape[-1]
    t_out = int(round(t * sr_out / sr_in))
    x_out = np.linspace(0.0, t - 1.0, t_out)
    i0 = np.floor(x_out).astype(np.int64)
    i1 = np.minimum(i0 + 1, t - 1)
    w = (x_out - i0).astype(np.float32)
    return audio[..., i0] * (1.0 - w) + audio[..., i1] * w
