"""A tiny composite whose codec is an EnCodec (``TINY_24K``), against the
JAX package at fp32 on CPU: the codec built and a scaled EnCodec refused by
the composite encode, greedy ``generate``, ``generate(input_values=...)``
through the EnCodec encode, and a stream that gives ``generate``'s codes."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu.models import codec as jcodec
from parler_tts_tpu.models import parler as jparler
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core.from_jax import load_jax_params
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.generation import streaming as pstreaming
from parler_tts_tpu_torch.models import codec as pcodec
from parler_tts_tpu_torch.models import encodec as penc
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.models.delay_pattern import undelay_pattern
from tests.test_torch_blocks import T, close, jax_init
from tests.test_torch_encodec import TINY_24K, TINY_48K, WAVE_TOL, _audio

torch.set_num_threads(1)  # tier-1 runs several pytest workers

SPECIALS = dict(decoder_start_token_id=33, pad_token_id=32, bos_token_id=33, eos_token_id=32)


def composite_config(mod):
    codec = mod.EncodecConfig(**TINY_24K)  # num_codebooks = num_quantizers = 4
    return mod.ParlerTTSConfig(
        vocab_size=100,
        text_encoder=mod.T5EncoderConfig(vocab_size=100, d_model=24, d_kv=8, d_ff=32, num_layers=2, num_heads=3),
        audio_encoder=codec,
        decoder=mod.DecoderConfig(vocab_size=33, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                                  ffn_dim=48, num_codebooks=codec.num_codebooks, max_position_embeddings=256,
                                  pad_token_id=32, eos_token_id=32, bos_token_id=33, dropout=0.0))


@pytest.fixture(scope="module")
def composite():
    params = jax_init(jparler.init, composite_config(jcfg), 5)
    model = pparler.init(0, composite_config(pcfg), device="cpu")
    load_jax_params(model, params)
    return params, model


def _requests():
    rng = np.random.default_rng(6)
    return dict(input_ids=rng.integers(0, 100, (2, 5)), prompt_input_ids=rng.integers(0, 100, (2, 4)))


def test_composite_builds_an_encodec_and_refuses_a_scaled_one(composite):
    _, model = composite
    assert isinstance(model.audio_encoder, penc.Encodec)
    assert model.audio_encoder.encoder.lstm.weight_ih_l0.shape == (4 * 16, 16)
    chunked = penc.Encodec(pcfg.EncodecConfig(**TINY_48K))
    assert jcodec.is_encodec(jcfg.EncodecConfig()) and pcodec.is_encodec(chunked.cfg)
    with pytest.raises(ValueError, match="codes-only"):
        pcodec.encode(chunked, torch.zeros(1, 2, 80))


def test_composite_greedy_generate_matches_jax(composite):
    params, model = composite
    gen = dict(max_length=16, do_sample=False, **SPECIALS)
    ref = jgenerate.generate(params, composite_config(jcfg), jcfg.GenerationConfig(**gen),
                             key=jax.random.PRNGKey(1), **_requests())
    out = pgenerate.generate(model, pcfg.GenerationConfig(**gen), device="cpu", **_requests())
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.code_lengths.numpy(), np.asarray(ref.code_lengths))
    assert out.audio.shape == (2, 12 * 8)  # causal EnCodec: exactly frames * hop
    close(ref.audio, out.audio, WAVE_TOL)


def test_composite_generate_from_input_values_encodes_like_jax(composite):
    """The audio prompt goes through EnCodec encode, pinned to the decoder's
    stream count, with JAX's codes; the continuation's tokens are JAX's."""
    params, model = composite
    audio = _audio((2, 50), 2)
    ref_codes = np.asarray(jcodec.encode(params["audio_encoder"], composite_config(jcfg).audio_encoder, audio))
    np.testing.assert_array_equal(pcodec.encode(model.audio_encoder, T(audio)).numpy(), ref_codes)
    gen = dict(max_length=20, do_sample=False, **SPECIALS)
    ref = jgenerate.generate(params, composite_config(jcfg), jcfg.GenerationConfig(**gen), input_values=audio,
                             key=jax.random.PRNGKey(2), **_requests())
    out = pgenerate.generate(model, pcfg.GenerationConfig(**gen), input_values=audio, device="cpu", **_requests())
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.codes.numpy()[..., : ref_codes.shape[-1]], ref_codes)
    close(ref.audio, out.audio, WAVE_TOL)


def test_composite_stream_gives_generate_codes(composite):
    """A stream over the EnCodec composite samples with one generator seed
    the codes ``generate`` gives, and vocodes each chunk through EnCodec."""
    _, model = composite
    gen = pcfg.GenerationConfig(max_length=22, do_sample=True, top_k=8, **SPECIALS)
    out = pgenerate.generate(model, gen, generator=torch.Generator().manual_seed(3), vocode=False, device="cpu",
                             **_requests())
    chunks = list(pstreaming.stream_generate(model, gen, chunk_frames=4, lookback=8, device="cpu",
                                             generator=torch.Generator().manual_seed(3), **_requests()))
    codes = np.concatenate([c.codes for c in chunks], axis=2)
    assert len(chunks) > 1 and all(c.audio.shape == (2, c.codes.shape[2] * 8) for c in chunks)
    np.testing.assert_array_equal(codes, undelay_pattern(out.tokens[:, :, 1:]).numpy()[:, :, : codes.shape[2]])
    np.testing.assert_array_equal(chunks[-1].valid_lengths, out.code_lengths.numpy())
