"""Autoregressive generation: description + prompt ids -> codec tokens ->
waveform, decoder-only continuation, and the prefill and step that
streaming shares.

Port of ``parler_tts_tpu/generation/generate.py``.  The JAX
``lax.while_loop`` becomes a Python loop over ``decode_step`` with the same
semantics:

* classifier-free guidance runs ``[cond; uncond]`` rows.  With text
  conditioning the uncond rows get zeroed encoder states and a zeroed
  encoder mask and the prompt rows are repeated; without it (``input_ids``
  None: no T5 encode, no cross-attention) the uncond rows get zeroed prompt
  states and a zeroed prompt mask;
* one fused mask covers the prompt (left-padded) followed by every decode
  position;
* the prefill covers the prompt, the BOS frame and any audio-prompt codes
  (``decoder_input_codes``, placed after the BOS frame before the delay
  pattern), then one cached decoder step per position;
* the prefill runs the model's own weights; the steps run the decode view
  (``ParlerDecoder.decode_params``: fused q/k/v, int8 with
  ``gen.int8_weights``) over a cache stored as ``gen.kv_cache_dtype``;
* a finished stream emits PAD, and a stream finishes on its raw sampled EOS,
  before delay forcing (``where(pattern == -1, sampled, forced)``);
* the loop ends early once every ``(batch, codebook)`` stream has finished.

A model split over a model group (``parallel/mesh.shard_params``) generates
on every model rank at once, with the same inputs: each rank holds its
heads' cache, the logits are gathered over the vocabulary, and every rank
samples from them with the same generator, so all emit the same tokens.
With ``gen.int8_weights`` each rank quantizes its shards (the row-split
kernels' scales taken over the group, ``ops/quantization.py``), and an int8
cache holds its heads' rows and scales: every rank's int8 values are the
slices of the unsplit model's, so the tokens are the unsplit int8 run's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from parler_tts_tpu_torch.core.config import GenerationConfig, ParlerTTSConfig
from parler_tts_tpu_torch.core.device import resolve_device
from parler_tts_tpu_torch.generation import sampling
from parler_tts_tpu_torch.models import codec as codec_mod
from parler_tts_tpu_torch.models.decoder import DecodeParams, KVCache, init_cache
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


@dataclasses.dataclass
class DecodeState:
    """The decode loop between two steps.  ``t`` is the position sampled
    next and ``logits`` (rows, K, V) predict it; ``tokens`` (B, K,
    max_length) is the delayed buffer, ``pattern`` its forced ids (-1 where
    the model samples)."""

    t: int
    tokens: torch.Tensor
    pattern: torch.Tensor
    finished: torch.Tensor  # (B, K) bool: the stream emitted EOS
    cache: KVCache
    logits: torch.Tensor
    fused_mask: torch.Tensor  # (rows, P + max_length)
    enc_mask: torch.Tensor | None  # (rows, S), None without cross-attention
    params: DecodeParams
    use_cfg: bool

    @property
    def done(self) -> bool:
        """Every position written, or every stream finished (a host sync)."""
        return self.t >= self.tokens.shape[2] or bool(self.finished.all())


def _rows(x: torch.Tensor, use_cfg: bool) -> torch.Tensor:
    return torch.cat([x, x], dim=0) if use_cfg else x


def _null_rows(x: torch.Tensor, use_cfg: bool) -> torch.Tensor:
    return torch.cat([x, torch.zeros_like(x)], dim=0) if use_cfg else x


@torch.no_grad()
def prefill(model: ParlerTTSModel, gen: GenerationConfig, *, max_length: int,
            input_ids: torch.Tensor | None = None, attention_mask: torch.Tensor | None = None,
            prompt_input_ids: torch.Tensor | None = None, prompt_attention_mask: torch.Tensor | None = None,
            prompt_hidden_states: torch.Tensor | None = None,
            decoder_input_codes: torch.Tensor | None = None) -> DecodeState:
    """Text encode, prompt embed, CFG rows, delay pattern and the decoder
    prefill over ``[prompt | BOS frame | audio-prompt codes]``.  Inputs are
    tensors on the model's device; the batch size comes from the first of
    ``input_ids``, ``prompt_input_ids``, ``prompt_hidden_states`` and
    ``decoder_input_codes`` given."""
    decoder = model.decoder
    first = next((x for x in (input_ids, prompt_input_ids, prompt_hidden_states, decoder_input_codes)
                  if x is not None), None)
    if first is None:
        raise ValueError("need input_ids, prompt_input_ids, prompt_hidden_states or decoder_input_codes "
                         "for the batch size")
    b, device = first.shape[0], first.device
    use_cfg = gen.guidance_scale is not None and gen.guidance_scale > 1.0
    rows = 2 * b if use_cfg else b

    enc_hidden = enc_mask = None
    if input_ids is not None:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.int32)
        enc_hidden = _null_rows(model.encode_text(input_ids, attention_mask), use_cfg)
        enc_mask = _null_rows(attention_mask, use_cfg)

    if prompt_hidden_states is not None:
        prompt_hidden = prompt_hidden_states.to(decoder.dtype)
    elif prompt_input_ids is not None:
        prompt_hidden = model.embed_prompts(prompt_input_ids)
    else:
        prompt_hidden = None
    if prompt_hidden is None:
        p_mask = torch.zeros((rows, 0), dtype=torch.int32, device=device)
    else:
        p_mask = prompt_attention_mask
        if p_mask is None:
            p_mask = torch.ones(prompt_hidden.shape[:2], dtype=torch.int32, device=device)
        # guidance on the description repeats the prompt rows; without text
        # it is guidance on the prompt itself, against zeroed prompt rows
        repeat = _rows if input_ids is not None else _null_rows
        prompt_hidden, p_mask = repeat(prompt_hidden, use_cfg), repeat(p_mask, use_cfg)

    start_ids = torch.full((b, decoder.cfg.num_codebooks, 1), gen.decoder_start_token_id, dtype=torch.int32,
                           device=device)
    if decoder_input_codes is not None:
        start_ids = torch.cat([start_ids, decoder_input_codes.to(torch.int32)], dim=2)
    _, pattern, t0 = build_delay_pattern(
        start_ids, bos_token_id=gen.bos_token_id, pad_token_id=gen.pad_token_id, max_length=max_length
    )
    tokens = torch.where(pattern == -1, gen.pad_token_id, pattern).to(torch.int32)

    p_len = p_mask.shape[1]
    cache = init_cache(decoder.cfg, rows, p_len + max_length, 0 if enc_hidden is None else enc_hidden.shape[1],
                       dtype=decoder.dtype, device=device, kv_dtype=gen.kv_cache_dtype, heads=decoder.num_heads)
    fused_mask = torch.cat(
        [p_mask.to(torch.int32), torch.ones((rows, max_length), dtype=torch.int32, device=device)], dim=1
    )
    hidden = decoder(
        _rows(tokens[:, :, :t0], use_cfg),
        encoder_hidden_states=enc_hidden,
        encoder_attention_mask=enc_mask,
        prompt_hidden_states=prompt_hidden,
        attention_mask=fused_mask,
        cache=cache,
    )
    return DecodeState(
        t=t0, tokens=tokens, pattern=pattern,
        finished=torch.zeros((b, decoder.cfg.num_codebooks), dtype=torch.bool, device=device),
        cache=cache, logits=decoder.logits(hidden, num_labels=1)[:, :, 0],
        fused_mask=fused_mask, enc_mask=enc_mask,
        params=decoder.decode_params(gen.int8_weights), use_cfg=use_cfg,
    )


@torch.no_grad()
def decode_step(model: ParlerTTSModel, gen: GenerationConfig, s: DecodeState, *,
                generator: torch.Generator | None = None, noise: NoiseFn | None = None) -> None:
    """Sample position ``s.t`` from ``s.logits``, write it, run one cached
    decoder step on it and advance ``s`` in place.  ``generate`` and
    ``stream_generate`` both loop over this function."""
    b = s.tokens.shape[0]
    logits = s.logits
    if s.use_cfg:
        logits = sampling.apply_cfg(logits[:b], logits[b:], gen.guidance_scale)
    logits = sampling.process_logits(logits, gen)
    sampled = sampling.select_tokens(
        logits, gen, generator=generator, noise=None if noise is None else noise(s.t)
    ).to(torch.int32)
    sampled = sampled.masked_fill(s.finished, gen.pad_token_id)
    s.finished = s.finished | (sampled == gen.eos_token_id)
    token_t = torch.where(s.pattern[:, :, s.t] == -1, sampled, s.tokens[:, :, s.t])
    s.tokens[:, :, s.t] = token_t
    decoder = model.decoder
    hidden = decoder.decode_step(_rows(token_t[:, :, None], s.use_cfg), s.cache, attention_mask=s.fused_mask,
                                 encoder_attention_mask=s.enc_mask, params=s.params)
    s.logits = decoder.logits(hidden, num_labels=1, heads=s.params.lm_heads)[:, :, 0]
    s.t += 1


@torch.no_grad()
def generate_tokens(model: ParlerTTSModel, gen: GenerationConfig, *, max_length: int,
                    input_ids: torch.Tensor | None = None, attention_mask: torch.Tensor | None = None,
                    prompt_input_ids: torch.Tensor | None = None,
                    prompt_attention_mask: torch.Tensor | None = None,
                    prompt_hidden_states: torch.Tensor | None = None,
                    decoder_input_codes: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    noise: NoiseFn | None = None) -> tuple[torch.Tensor, int]:
    """Prefill + decode loop on the model's device.  ``input_ids`` None
    turns text conditioning off (no T5 encode, no cross-attention) and
    ``prompt_input_ids`` None drops the prompt prefix, unless
    ``prompt_hidden_states`` (B, P, H) supplies it embedded.  Returns
    (delayed tokens (B, K, max_length) int32, the position the loop stopped
    at)."""
    s = prefill(model, gen, max_length=max_length, input_ids=input_ids, attention_mask=attention_mask,
                prompt_input_ids=prompt_input_ids, prompt_attention_mask=prompt_attention_mask,
                prompt_hidden_states=prompt_hidden_states, decoder_input_codes=decoder_input_codes)
    while not s.done:
        decode_step(model, gen, s, generator=generator, noise=noise)
    return s.tokens, s.t


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


def check_vocodable(cfg: ParlerTTSConfig) -> None:
    """Raise unless the codec takes the decoder's codebook streams (a stereo
    decoder emits twice the codec's: there is no stereo vocode)."""
    if cfg.decoder.num_codebooks != cfg.audio_encoder.num_codebooks:
        raise ValueError(
            f"decoder emits {cfg.decoder.num_codebooks} codebook streams but the codec "
            f"takes {cfg.audio_encoder.num_codebooks} (audio_channels="
            f"{cfg.decoder.audio_channels}); there is no stereo vocode, use vocode=False"
        )


def _finalize(model: ParlerTTSModel, tokens: torch.Tensor, *, vocode: bool = True) -> GenerateOutput:
    """Undelay/trim, then one batched codec vocode of the trimmed codes."""
    cfg = model.cfg
    codes, code_lengths = postprocess_tokens(tokens, cfg)
    if vocode:
        check_vocodable(cfg)
        audio = codec_mod.decode(model.audio_encoder, codes)
    else:
        audio = torch.zeros((tokens.shape[0], 0), dtype=torch.float32, device=tokens.device)
    audio_lengths = code_lengths * cfg.audio_encoder.hop_length
    return GenerateOutput(tokens, codes, code_lengths, audio, audio_lengths)


def to_device(device: torch.device, x) -> torch.Tensor | None:
    """``x`` (numpy, tensor or None) as a tensor on ``device``."""
    return None if x is None else torch.as_tensor(x, device=device)


def model_device(model: ParlerTTSModel, device: str | torch.device) -> torch.device:
    """The model's device, which must be the ``device`` asked for."""
    device = resolve_device(device)
    param_device = next(model.parameters()).device
    if param_device.type != device.type or device.index not in (None, param_device.index):
        raise ValueError(f"model is on {param_device}, generation was asked to run on {device}")
    return param_device


def audio_prompt_codes(model: ParlerTTSModel, input_values: torch.Tensor | None,
                       decoder_input_codes: torch.Tensor | None, *,
                       stereo_repeat: bool = True) -> torch.Tensor | None:
    """The audio prompt as codes (B, K, frames): ``input_values`` (B, T)
    encoded by the model's codec, or ``decoder_input_codes`` as given.  With
    ``stereo_repeat``, mono codes into a stereo decoder are repeated per
    channel (JAX ``generate`` ``:423-429``)."""
    if input_values is not None:
        if decoder_input_codes is not None:
            raise ValueError("pass input_values or decoder_input_codes, not both")
        decoder_input_codes = codec_mod.encode(model.audio_encoder, input_values)
    dcfg = model.cfg.decoder
    if (stereo_repeat and decoder_input_codes is not None and dcfg.audio_channels == 2
            and decoder_input_codes.shape[1] == dcfg.num_codebooks // 2):
        decoder_input_codes = decoder_input_codes.repeat_interleave(2, dim=1)
    return decoder_input_codes


@torch.no_grad()
def generate(model: ParlerTTSModel, gen: GenerationConfig, *, input_ids, prompt_input_ids,
             attention_mask=None, prompt_attention_mask=None, input_values=None, decoder_input_codes=None,
             max_length: int | None = None, generator: torch.Generator | None = None,
             noise: NoiseFn | None = None, vocode: bool = True,
             device: str | torch.device = "cuda") -> GenerateOutput:
    """description ids (B, S) + prompt ids (B, P) -> waveform.

    ``input_values`` (B, T) raw audio continues a voice (encoded by the
    model's codec); ``decoder_input_codes`` (B, K, frames) passes its codes
    instead.  Inputs may be numpy arrays or tensors; they are moved to
    ``device``, where the model must already live.  Sampling
    (``gen.do_sample``) draws its Gumbel noise from ``generator``, or takes
    it from ``noise(t)``."""
    dev = model_device(model, device)
    codes = audio_prompt_codes(model, to_device(dev, input_values), to_device(dev, decoder_input_codes))
    input_ids = to_device(dev, input_ids)
    prompt_input_ids = to_device(dev, prompt_input_ids)
    tokens, _ = generate_tokens(
        model, gen, max_length=max_length or gen.max_length,
        input_ids=input_ids, attention_mask=to_device(dev, attention_mask),
        prompt_input_ids=prompt_input_ids, prompt_attention_mask=to_device(dev, prompt_attention_mask),
        decoder_input_codes=codes, generator=generator, noise=noise,
    )
    return _finalize(model, tokens, vocode=vocode)


@torch.no_grad()
def generate_decoder_only(model: ParlerTTSModel, gen: GenerationConfig, *, decoder_input_codes=None,
                          input_values=None, prompt_hidden_states=None, prompt_attention_mask=None,
                          batch_size: int | None = None, max_length: int | None = None,
                          generator: torch.Generator | None = None, noise: NoiseFn | None = None,
                          vocode: bool = True, device: str | torch.device = "cuda") -> GenerateOutput:
    """Audio continuation with no text conditioning: no T5 encode and no
    cross-attention in any layer (JAX ``generate_decoder_only``).

    Continue ``input_values`` (B, T) raw audio or ``decoder_input_codes``
    (B, K, frames); with neither, the model runs free from BOS for
    ``batch_size`` rows (or as many as ``prompt_hidden_states`` has).
    ``prompt_hidden_states`` (B, P, H) prepends embedded prompt states.
    With ``gen.guidance_scale > 1`` the null rows get zeroed prompt rows."""
    dev = model_device(model, device)
    codes = audio_prompt_codes(model, to_device(dev, input_values), to_device(dev, decoder_input_codes),
                               stereo_repeat=False)
    prompt_hidden_states = to_device(dev, prompt_hidden_states)
    if codes is None:
        if batch_size is None and prompt_hidden_states is not None:
            batch_size = prompt_hidden_states.shape[0]
        if batch_size is None:
            raise ValueError("pass decoder_input_codes, input_values or batch_size")
        codes = torch.zeros((batch_size, model.cfg.decoder.num_codebooks, 0), dtype=torch.int32, device=dev)
    tokens, _ = generate_tokens(
        model, gen, max_length=max_length or gen.max_length, decoder_input_codes=codes,
        prompt_hidden_states=prompt_hidden_states,
        prompt_attention_mask=to_device(dev, prompt_attention_mask),
        generator=generator, noise=noise,
    )
    return _finalize(model, tokens, vocode=vocode)
