"""Autoregressive generation: description + prompt ids -> codec tokens ->
waveform.

Port of ``parler_tts_tpu/generation/generate.py`` (composite path).  The
JAX ``lax.while_loop`` becomes a Python loop over decode positions with the
same semantics:

* classifier-free guidance runs ``[cond; uncond]`` rows: the uncond rows get
  zeroed encoder states and a zeroed encoder mask, the prompt rows are
  repeated;
* one fused mask covers the prompt (left-padded) followed by every decode
  position;
* the prefill covers the prompt plus the BOS frame, then one cached decoder
  step per position;
* a finished stream emits PAD, and a stream finishes on its raw sampled EOS,
  before delay forcing (``where(pattern == -1, sampled, forced)``);
* the loop ends early once every ``(batch, codebook)`` stream has finished.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from parler_tts_tpu_torch.core.config import GenerationConfig, ParlerTTSConfig
from parler_tts_tpu_torch.core.device import resolve_device
from parler_tts_tpu_torch.generation import sampling
from parler_tts_tpu_torch.models import codec as codec_mod
from parler_tts_tpu_torch.models.decoder import init_cache
from parler_tts_tpu_torch.models.delay_pattern import build_delay_pattern, undelay_pattern
from parler_tts_tpu_torch.models.parler import ParlerTTSModel

#: ``noise(t)`` -> (B, K, V) Gumbel noise for the token sampled at position t
NoiseFn = Callable[[int], torch.Tensor]


class GenerateOutput(NamedTuple):
    """tokens: raw delayed ids (B, K, max_length); codes: undelayed codec
    codes (B, K, T_codes); code_lengths: valid frames per sample; audio:
    (B, T_codes * hop) waveform; audio_lengths: valid samples per sample."""

    tokens: torch.Tensor
    codes: torch.Tensor
    code_lengths: torch.Tensor
    audio: torch.Tensor
    audio_lengths: torch.Tensor


def _rows(x: torch.Tensor, use_cfg: bool) -> torch.Tensor:
    return torch.cat([x, x], dim=0) if use_cfg else x


@torch.no_grad()
def generate_tokens(model: ParlerTTSModel, gen: GenerationConfig, *,
                    input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    prompt_input_ids: torch.Tensor, prompt_attention_mask: torch.Tensor,
                    max_length: int, generator: torch.Generator | None = None,
                    noise: NoiseFn | None = None) -> tuple[torch.Tensor, int]:
    """Prefill + decode loop on the model's device.  Returns (delayed tokens
    (B, K, max_length) int32, the position the loop stopped at)."""
    if gen.kv_cache_dtype is not None or gen.int8_weights:
        raise NotImplementedError(
            "kv_cache_dtype / int8_weights are not ported yet (ROADMAP.md queue 1, 'int8 KV cache "
            "and int8 weights'); use kv_cache_dtype=None, int8_weights=False"
        )
    decoder = model.decoder
    b = input_ids.shape[0]
    num_codebooks = decoder.cfg.num_codebooks
    use_cfg = gen.guidance_scale is not None and gen.guidance_scale > 1.0

    enc_hidden = model.encode_text(input_ids, attention_mask)
    enc_mask = attention_mask
    prompt_hidden = model.embed_prompts(prompt_input_ids)
    p_mask = prompt_attention_mask
    if use_cfg:
        enc_hidden = torch.cat([enc_hidden, torch.zeros_like(enc_hidden)], dim=0)
        enc_mask = torch.cat([enc_mask, torch.zeros_like(enc_mask)], dim=0)
        prompt_hidden = _rows(prompt_hidden, True)
        p_mask = _rows(p_mask, True)

    start_ids = torch.full((b, num_codebooks, 1), gen.decoder_start_token_id, dtype=torch.int32,
                           device=input_ids.device)
    _, pattern, t0 = build_delay_pattern(
        start_ids, bos_token_id=gen.bos_token_id, pad_token_id=gen.pad_token_id, max_length=max_length
    )
    tokens = torch.where(pattern == -1, gen.pad_token_id, pattern).to(torch.int32)

    rows = 2 * b if use_cfg else b
    p_len = prompt_hidden.shape[1]
    cache = init_cache(decoder.cfg, rows, p_len + max_length, enc_hidden.shape[1],
                       dtype=decoder.dtype, device=input_ids.device)
    fused_mask = torch.cat(
        [p_mask.to(torch.int32), torch.ones((rows, max_length), dtype=torch.int32, device=p_mask.device)],
        dim=1,
    )
    hidden = decoder(
        _rows(tokens[:, :, :t0], use_cfg),
        encoder_hidden_states=enc_hidden,
        encoder_attention_mask=enc_mask,
        prompt_hidden_states=prompt_hidden,
        attention_mask=fused_mask,
        cache=cache,
    )
    logits = decoder.logits(hidden, num_labels=1)[:, :, 0]  # (rows, K, V)

    finished = torch.zeros((b, num_codebooks), dtype=torch.bool, device=input_ids.device)
    t = t0
    while t < max_length and not bool(finished.all()):
        if use_cfg:
            logits = sampling.apply_cfg(logits[:b], logits[b:], gen.guidance_scale)
        logits = sampling.process_logits(logits, gen)
        sampled = sampling.select_tokens(
            logits, gen, generator=generator, noise=None if noise is None else noise(t)
        ).to(torch.int32)
        sampled = sampled.masked_fill(finished, gen.pad_token_id)
        finished = finished | (sampled == gen.eos_token_id)
        token_t = torch.where(pattern[:, :, t] == -1, sampled, tokens[:, :, t])
        tokens[:, :, t] = token_t
        hidden = decoder.decode_step(_rows(token_t[:, :, None], use_cfg), cache,
                                     encoder_attention_mask=enc_mask, attention_mask=fused_mask)
        logits = decoder.logits(hidden, num_labels=1)[:, :, 0]
        t += 1
    return tokens, t


def postprocess_tokens(tokens: torch.Tensor, cfg: ParlerTTSConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop the BOS column, undelay, and cut each sample at its first frame
    holding a special id (>= codebook_size) in any codebook.  Returns (codes
    (B, K, T') zeroed past the cut, code_lengths (B,) int32)."""
    codes = undelay_pattern(tokens[:, :, 1:])
    t = codes.shape[-1]
    special = (codes >= cfg.audio_encoder.codebook_size).any(dim=1)  # (B, T')
    if t == 0:
        first_special = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    else:
        first_special = torch.where(special.any(dim=1), special.int().argmax(dim=1), t)
    valid = torch.arange(t, device=codes.device)[None] < first_special[:, None]
    codes = torch.where(valid[:, None, :], codes, 0)
    return codes, first_special.to(torch.int32)


def _finalize(model: ParlerTTSModel, tokens: torch.Tensor, *, vocode: bool = True) -> GenerateOutput:
    """Undelay/trim, then one batched DAC vocode of the trimmed codes."""
    cfg = model.cfg
    codes, code_lengths = postprocess_tokens(tokens, cfg)
    if vocode:
        if cfg.decoder.num_codebooks != cfg.audio_encoder.num_codebooks:
            raise ValueError(
                f"decoder emits {cfg.decoder.num_codebooks} codebook streams but the codec "
                f"takes {cfg.audio_encoder.num_codebooks} (audio_channels="
                f"{cfg.decoder.audio_channels}); there is no stereo vocode, use vocode=False"
            )
        audio = codec_mod.decode(model.audio_encoder, codes)
    else:
        audio = torch.zeros((tokens.shape[0], 0), dtype=torch.float32, device=tokens.device)
    audio_lengths = code_lengths * cfg.audio_encoder.hop_length
    return GenerateOutput(tokens, codes, code_lengths, audio, audio_lengths)


def _on(device: torch.device, x) -> torch.Tensor | None:
    return None if x is None else torch.as_tensor(x, device=device)


@torch.no_grad()
def generate(model: ParlerTTSModel, gen: GenerationConfig, *, input_ids, prompt_input_ids,
             attention_mask=None, prompt_attention_mask=None, max_length: int | None = None,
             generator: torch.Generator | None = None, noise: NoiseFn | None = None,
             vocode: bool = True, device: str | torch.device = "cuda") -> GenerateOutput:
    """description ids (B, S) + prompt ids (B, P) -> waveform.

    Inputs may be numpy arrays or tensors; they are moved to ``device``, where
    the model must already live.  Sampling (``gen.do_sample``) draws its
    Gumbel noise from ``generator``, or takes it from ``noise(t)``."""
    device = resolve_device(device)
    param_device = next(model.parameters()).device
    if param_device.type != device.type or device.index not in (None, param_device.index):
        raise ValueError(f"model is on {param_device}, generate was asked to run on {device}")
    input_ids = _on(param_device, input_ids)
    prompt_input_ids = _on(param_device, prompt_input_ids)
    attention_mask = _on(param_device, attention_mask)
    prompt_attention_mask = _on(param_device, prompt_attention_mask)
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids, dtype=torch.int32)
    if prompt_attention_mask is None:
        prompt_attention_mask = torch.ones_like(prompt_input_ids, dtype=torch.int32)
    tokens, _ = generate_tokens(
        model, gen,
        input_ids=input_ids, attention_mask=attention_mask,
        prompt_input_ids=prompt_input_ids, prompt_attention_mask=prompt_attention_mask,
        max_length=max_length or gen.max_length, generator=generator, noise=noise,
    )
    return _finalize(model, tokens, vocode=vocode)
