"""Composite Parler-TTS model: T5 text encoder + prompt embedding + codec-token
decoder LM + DAC codec (port of ``parler_tts_tpu/models/parler.py``).

``train_forward`` is the teacher-forced loss of training; the text encoder
(and the codec) stay frozen and run without autograd, so only the decoder,
``embed_prompts`` and ``enc_to_dec_proj`` get gradients."""

from __future__ import annotations

import torch
from torch import nn

from parler_tts_tpu_torch.core.config import ParlerTTSConfig
from parler_tts_tpu_torch.core.device import resolve_device
from parler_tts_tpu_torch.models import codec as codec_mod
from parler_tts_tpu_torch.models.decoder import ParlerDecoder, loss_fn
from parler_tts_tpu_torch.models.delay_pattern import labels_to_decoder_inputs
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

    def encode_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
        """Description ids -> decoder-width encoder states in the compute
        ``dtype``, padding zeroed.  The T5 encoder runs without autograd (it
        is frozen); ``enc_to_dec_proj`` is differentiable."""
        with torch.no_grad():
            h = self.text_encoder(input_ids, attention_mask, dtype)
        if self.enc_to_dec_proj is not None:
            h = self.enc_to_dec_proj(h)
        if attention_mask is not None:
            h = h * attention_mask[..., None].to(h.dtype)
        return h

    def train_forward(self, *, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                      prompt_input_ids: torch.Tensor, prompt_attention_mask: torch.Tensor,
                      labels: torch.Tensor, decoder_attention_mask: torch.Tensor | None = None,
                      generator: torch.Generator | None = None, remat: bool = False,
                      dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced loss over delay-pattern ``labels`` (B, K, T) with
        -100 holes.  ``generator`` turns on the decoder's dropout and
        layerdrop, ``remat`` its per-layer recomputation; ``dtype`` is the
        compute dtype.  Returns (loss, logits (B, K, T, V))."""
        dcfg = self.cfg.decoder
        enc_hidden = self.encode_text(input_ids, attention_mask, dtype)
        prompt_hidden = self.embed_prompts(prompt_input_ids, dtype)
        decoder_input_ids = labels_to_decoder_inputs(labels, bos_token_id=dcfg.bos_token_id,
                                                     pad_token_id=dcfg.pad_token_id)
        t = labels.shape[-1]
        if decoder_attention_mask is None:
            decoder_attention_mask = torch.ones((labels.shape[0], t), dtype=torch.int32, device=labels.device)
        fused_mask = torch.cat([prompt_attention_mask.to(torch.int32),
                                decoder_attention_mask.to(torch.int32)], dim=1)
        hidden = self.decoder(decoder_input_ids, encoder_hidden_states=enc_hidden,
                              encoder_attention_mask=attention_mask, prompt_hidden_states=prompt_hidden,
                              attention_mask=fused_mask, dtype=dtype, generator=generator, remat=remat)
        logits = self.decoder.logits(hidden, num_labels=t)
        return loss_fn(logits, labels, decoder_input_ids, dcfg), logits

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
    eval mode and frozen (``set_trainable`` unfreezes what training
    updates).  Raises when CUDA is asked for and missing."""
    device = resolve_device(device)
    with torch.device(device):
        model = ParlerTTSModel(cfg)
    generator = torch.Generator(device=device).manual_seed(seed)
    model.reset_parameters(generator)
    return model.to(dtype).eval().requires_grad_(False)


#: the parameter subtrees that training updates; the rest stays frozen
TRAINABLE_KEYS = ("decoder", "embed_prompts", "enc_to_dec_proj")


def set_trainable(model: ParlerTTSModel) -> None:
    """Let exactly the ``TRAINABLE_KEYS`` subtrees require grad."""
    model.requires_grad_(False)
    for key in TRAINABLE_KEYS:
        part = getattr(model, key)
        if part is not None:
            part.requires_grad_(True)
