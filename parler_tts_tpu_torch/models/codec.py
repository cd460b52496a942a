"""Codec dispatch by config type (port of ``parler_tts_tpu/models/codec.py``):
the DAC or the EnCodec family, encode and decode.  Generation, streaming and
the training data go through this module, so a composite carries either."""

from __future__ import annotations

import torch

from parler_tts_tpu_torch.core import torch_import as ti
from parler_tts_tpu_torch.core.config import EncodecConfig
from parler_tts_tpu_torch.models.dac import DAC
from parler_tts_tpu_torch.models.encodec import Encodec
from parler_tts_tpu_torch.utils import profiling

Codec = DAC | Encodec


def is_encodec(cfg) -> bool:
    return isinstance(cfg, EncodecConfig) or getattr(cfg, "codec_type", "dac") == "encodec"


def build(cfg) -> Codec:
    """The codec module for ``cfg`` (parameters uninitialised)."""
    return Encodec(cfg) if is_encodec(cfg) else DAC(cfg)


def encode(codec: Codec, audio: torch.Tensor, *, n_quantizers: int | None = None) -> torch.Tensor:
    """(B, T) waveform -> (B, K, T_frames) codes.  An EnCodec gives K =
    ``cfg.num_codebooks``, the composite's stream count, and must be
    codes-only: a normalized or chunked EnCodec carries scales that the token
    decoder cannot model."""
    if isinstance(codec, Encodec):
        cfg = codec.cfg
        if cfg.normalize or cfg.chunk_length is not None:
            raise ValueError(
                "composite models require a codes-only codec (normalize=False, unchunked): the 48 kHz "
                "normalized EnCodec carries per-chunk scales the token LM cannot model; use models/encodec.py "
                "directly")
        return codec.encode(audio, n_quantizers=n_quantizers or cfg.num_codebooks)
    return codec.encode(audio, n_quantizers)


#: the most output samples one codec call decodes.  The value was sized
#: for the DAC's eager fp32 Snake temporaries at 96 and 192 channels (one
#: call over 64 rows of 5 s, 14 M samples, ran an 80 GB card out of memory;
#: a call of this many samples took about 10 GB).  The bf16 Snake kernel
#: (``ops/snake.py``) has removed those temporaries on the card; what larger
#: groups would cost or save there is not measured
VOCODE_SAMPLES = 2**21


def decode(codec: Codec, codes: torch.Tensor) -> torch.Tensor:
    """(B, K, T_frames) codes -> (B, T_frames * hop) waveform, decoded in
    groups of rows of at most ``VOCODE_SAMPLES`` output samples (at least
    one row per group), each in a ``codec.decode`` span whose units are the
    audio seconds it makes."""
    hop = codec.cfg.hop_length
    rows = max(1, VOCODE_SAMPLES // max(1, codes.shape[2] * hop))

    def run(group: torch.Tensor) -> torch.Tensor:
        with profiling.span("codec.decode", group.device, rows=group.shape[0],
                            units=group.shape[0] * group.shape[2] * hop / codec.cfg.sampling_rate):
            return codec.decode(group)

    if codes.shape[0] <= rows:
        return run(codes)
    return torch.cat([run(group) for group in codes.split(rows)])


def import_torch(sd, cfg) -> dict[str, torch.Tensor]:
    """An HF codec state_dict -> the codec module's state_dict (weight norm
    folded)."""
    if is_encodec(cfg):
        return ti.import_encodec(sd, cfg)
    return ti.import_dac(sd, num_down=len(cfg.downsampling_ratios), num_up=len(cfg.upsampling_ratios),
                         num_codebooks=cfg.num_codebooks)
