"""Streaming generation: codec frames decoded in chunks, each chunk vocoded
as soon as it is ready.

Port of ``parler_tts_tpu/generation/streaming.py``.  The decode loop is
``generate``'s own (``prefill`` then ``decode_step``), stopped every
``chunk_frames`` positions, so a stream and ``generate`` with the same
generator (or injected noise) give the same codes.  Each ready chunk is
vocoded with ``lookback`` frames of left context: the DAC decoder is
convolutional, so with a lookback at least its left receptive field the
emitted samples equal a one-shot vocode of every frame ready so far (an
EnCodec decoder's LSTM restarts at each window, so there they only
approach it).  The DAC's convolutions are centred, so a chunk's last frames
lack the right context that a one-shot vocode of the whole utterance gives
them; the JAX design holds back no frames for it, and neither does this
port.  Early windows
vocode exactly the frames there are (no left padding: code 0 is not
silence).
PyTorch runs eagerly, so there is no counterpart of the JAX module's
per-signature ``jax.jit`` factory.

A model split over a model group streams on every model rank at once, with
the same inputs and a generator seeded the same way: the collectives sit
inside ``prefill`` and ``decode_step``, so the ranks must run the same steps
in the same order.  They sample from the same gathered logits, so their
tokens and their stop agree; once per chunk the ranks compare their position,
their stop and a checksum of their tokens (``tensor_parallel.check_same``)
and all raise if one has left the others.  The codec is whole on every rank,
and every rank vocodes and yields the same chunks: no rank waits on another
for audio, and any rank can serve the stream.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from parler_tts_tpu_torch.core.config import GenerationConfig
from parler_tts_tpu_torch.generation.generate import (
    NoiseFn,
    audio_prompt_codes,
    check_vocodable,
    decode_step,
    model_device,
    prefill,
    to_device,
)
from parler_tts_tpu_torch.models import codec as codec_mod
from parler_tts_tpu_torch.models.delay_pattern import undelay_pattern
from parler_tts_tpu_torch.models.parler import ParlerTTSModel
from parler_tts_tpu_torch.parallel import tensor_parallel as tp

DEFAULT_LOOKBACK = 48  # frames of left context per vocoded window


class StreamChunk(NamedTuple):
    audio: np.ndarray  # (B, new_frames * hop) new samples, zero past each sample's end
    codes: np.ndarray  # (B, K, new_frames) undelayed raw codes of this chunk
    frame_offset: int  # frames emitted before this chunk
    finished: bool
    valid_lengths: np.ndarray | None = None  # (B,) valid frames so far per sample


@torch.no_grad()
def stream_generate(model: ParlerTTSModel, gen: GenerationConfig, *, input_ids, prompt_input_ids,
                    attention_mask=None, prompt_attention_mask=None, input_values=None,
                    decoder_input_codes=None, max_length: int | None = None, chunk_frames: int = 86,
                    lookback: int = DEFAULT_LOOKBACK, generator: torch.Generator | None = None,
                    noise: NoiseFn | None = None, vocode: bool = True,
                    device: str | torch.device = "cuda") -> Iterator[StreamChunk]:
    """Yield about ``chunk_frames / frame_rate`` seconds of audio at a time
    as it is generated.  Arguments as ``generate``'s; ``input_values`` or
    ``decoder_input_codes`` continue a voice.  Each chunk covers the frames
    that became ready (written in every codebook: ``t - 1 - (K - 1)`` after
    ``t`` positions); a sample stops contributing audio at its first frame
    holding a special id."""
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be at least 1, got {chunk_frames}")
    dev = model_device(model, device)
    if vocode:
        check_vocodable(model.cfg)
    codes = audio_prompt_codes(model, to_device(dev, input_values), to_device(dev, decoder_input_codes))
    max_length = max_length or gen.max_length
    s = prefill(model, gen, max_length=max_length, input_ids=to_device(dev, input_ids),
                attention_mask=to_device(dev, attention_mask), prompt_input_ids=to_device(dev, prompt_input_ids),
                prompt_attention_mask=to_device(dev, prompt_attention_mask), decoder_input_codes=codes)
    group = model.decoder.model_group
    b, num_codebooks = s.tokens.shape[:2]
    cb, hop = model.cfg.audio_encoder.codebook_size, model.cfg.audio_encoder.hop_length
    window = lookback + chunk_frames
    emitted = 0
    while True:
        end = min(s.t + chunk_frames, max_length)
        while s.t < end and not s.done:
            decode_step(model, gen, s, generator=generator, noise=noise)
        done = s.done
        if group is not None:
            flat = s.tokens.long().flatten()
            checksum = (flat * torch.arange(1, flat.numel() + 1, device=flat.device)).sum()
            tp.check_same(torch.stack([checksum.new_tensor(s.t), checksum.new_tensor(int(done)), checksum]), group,
                          "the stream's position, stop and tokens")
        ready = max(0, (s.t - 1) - (num_codebooks - 1))
        new_frames = ready - emitted
        if new_frames <= 0 and not done:
            continue
        if new_frames > 0:
            codes_full = undelay_pattern(s.tokens[:, :, 1:]).cpu().numpy()
            special = (codes_full[:, :, :ready] >= cb).any(axis=1)  # (B, ready)
            valid_lengths = np.where(special.any(axis=1), special.argmax(axis=1), ready).astype(np.int64)
            win_start = max(0, ready - window)
            codes_win = codes_full[:, :, win_start:ready]
            codes_win = np.where(codes_win >= cb, 0, codes_win)
            # codes past a sample's end are zeroed as postprocess_tokens does,
            # or the vocoder would see post-EOS codes as context
            frame_idx = win_start + np.arange(codes_win.shape[-1])
            codes_win = np.where(frame_idx[None, None, :] < valid_lengths[:, None, None], codes_win, 0)
            if vocode:
                audio_win = codec_mod.decode(model.audio_encoder, torch.from_numpy(codes_win).to(dev))
                new_audio = audio_win[:, -new_frames * hop:].float().cpu().numpy().copy()
            else:
                new_audio = np.zeros((b, new_frames * hop), np.float32)
            for i in range(b):
                cut = max(0, int(valid_lengths[i]) - emitted) * hop
                new_audio[i, cut:] = 0.0
            yield StreamChunk(audio=new_audio, codes=codes_full[:, :, emitted:ready], frame_offset=emitted,
                              finished=done, valid_lengths=valid_lengths)
            emitted = ready
        if done:
            return
