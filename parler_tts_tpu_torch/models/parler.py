"""Composite Parler-TTS model: T5 text encoder + prompt embedding + codec-token
decoder LM + DAC codec (port of ``parler_tts_tpu/models/parler.py``,
inference side)."""

from __future__ import annotations

import torch
from torch import nn

from parler_tts_tpu_torch.core.config import ParlerTTSConfig
from parler_tts_tpu_torch.core.device import resolve_device
from parler_tts_tpu_torch.models import codec as codec_mod
from parler_tts_tpu_torch.models.decoder import ParlerDecoder
from parler_tts_tpu_torch.models.t5_encoder import T5Encoder
from parler_tts_tpu_torch.ops.nn import Dense, Embedding


def has_proj(cfg: ParlerTTSConfig) -> bool:
    return cfg.text_encoder.d_model != cfg.decoder.hidden_size


class ParlerTTSModel(nn.Module):
    """Submodule and parameter names follow the JAX parameter tree
    (``text_encoder``, ``decoder``, ``embed_prompts``, ``enc_to_dec_proj``,
    ``audio_encoder``)."""

    def __init__(self, cfg: ParlerTTSConfig):
        super().__init__()
        self.cfg = cfg
        self.text_encoder = T5Encoder(cfg.text_encoder)
        self.decoder = ParlerDecoder(cfg.decoder)
        self.embed_prompts = Embedding(cfg.vocab_size, cfg.decoder.hidden_size)
        self.enc_to_dec_proj = (
            Dense(cfg.text_encoder.d_model, cfg.decoder.hidden_size, bias=True) if has_proj(cfg) else None
        )
        self.audio_encoder = codec_mod.build(cfg.audio_encoder)

    def encode_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None) -> torch.Tensor:
        """Description ids -> decoder-width encoder states, padding zeroed."""
        h = self.text_encoder(input_ids, attention_mask)
        if self.enc_to_dec_proj is not None:
            h = self.enc_to_dec_proj(h)
        if attention_mask is not None:
            h = h * attention_mask[..., None].to(h.dtype)
        return h

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.cfg.decoder.initializer_factor
        self.text_encoder.reset_parameters(generator)
        self.decoder.reset_parameters(generator)
        self.embed_prompts.embedding.normal_(0.0, std, generator=generator)
        if self.enc_to_dec_proj is not None:
            self.enc_to_dec_proj.kernel.normal_(0.0, std, generator=generator)
            self.enc_to_dec_proj.bias.zero_()
        self.audio_encoder.reset_parameters(generator)


def init(seed: int, cfg: ParlerTTSConfig, *, device: str | torch.device = "cuda",
         dtype: torch.dtype = torch.float32) -> ParlerTTSModel:
    """A model with random weights drawn from ``seed`` (the JAX ``init``'s
    distributions, not its values), built on ``device`` in ``dtype``, in
    eval mode.  Raises when CUDA is asked for and missing."""
    device = resolve_device(device)
    with torch.device(device):
        model = ParlerTTSModel(cfg)
    generator = torch.Generator(device=device).manual_seed(seed)
    model.reset_parameters(generator)
    return model.to(dtype).eval().requires_grad_(False)
