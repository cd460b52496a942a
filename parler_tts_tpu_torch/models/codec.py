"""Codec dispatch by config type (port of ``parler_tts_tpu/models/codec.py``).

Only the DAC family is ported; the EnCodec family raises until ROADMAP.md
queue 1 item "Codec encode side + EnCodec" lands.
"""

from __future__ import annotations

import torch

from parler_tts_tpu_torch.core.config import DACConfig
from parler_tts_tpu_torch.models.dac import DAC


def build(cfg) -> DAC:
    """The codec module for ``cfg`` (parameters uninitialised)."""
    if not isinstance(cfg, DACConfig) or cfg.codec_type != "dac":
        raise NotImplementedError(
            "only the DAC codec is ported to parler_tts_tpu_torch; EnCodec waits for "
            "ROADMAP.md queue 1, 'Codec encode side + EnCodec'"
        )
    return DAC(cfg)


def decode(codec: DAC, codes: torch.Tensor) -> torch.Tensor:
    """(B, K, T_frames) codes -> (B, T_frames * hop) waveform."""
    return codec.decode(codes)
