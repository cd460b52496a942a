"""Streaming generation on the tiny composite at fp32: the stream's codes
equal ``generate``'s token buffer (greedy, and with one generator seed),
each chunk's windowed vocode equals a one-shot vocode of the frames so far,
the first chunk comes after ``chunk_frames`` frames, audio-prompt
continuation, and the port's stream against the JAX package's with the same
Gumbel noise.  Mirrors ``tests/test_streaming.py``; the audio checks run on
a codec made audible (``loud``)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import streaming as jstreaming
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.generation import streaming as pstreaming
from parler_tts_tpu_torch.models import codec as pcodec
from parler_tts_tpu_torch.models.delay_pattern import undelay_pattern
from tests.test_torch_blocks import jax_params, port_model, tiny_config
from tests.test_torch_generate import SPECIALS, _batch
from tests.test_torch_quantization import gumbel_noise

torch.set_num_threads(1)  # tier-1 runs several pytest workers

K, CB, HOP = 4, 32, 8


@pytest.fixture(scope="module")
def models():
    params = jax_params(tiny_config(jcfg), seed=1)  # greedy output ends one sample early: trims are exercised
    return params, port_model(params)


def _scale_kernels(tree, factor):
    if isinstance(tree, dict):
        return {k: v * factor if k == "kernel" else _scale_kernels(v, factor) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_scale_kernels(v, factor) for v in tree)
    return tree


@pytest.fixture(scope="module")
def loud():
    """The tiny model made audible: its random codec's audio is about 1e-7,
    below any tolerance, so the codec's decode-side kernels are scaled by
    10 (audio about 0.1); the special ids' LM-head columns are zeroed so
    that samples run longer than a chunk."""
    params = jax_params(tiny_config(jcfg), seed=1)
    codec = params["audio_encoder"]
    params["audio_encoder"] = {**codec, "decoder": _scale_kernels(codec["decoder"], 10.0),
                               "quantizer": {**codec["quantizer"], "out_proj": _scale_kernels(
                                   codec["quantizer"]["out_proj"], 10.0)}}
    heads = np.array(params["decoder"]["lm_heads"]["kernel"])
    heads[..., CB:] = 0.0
    params["decoder"] = {**params["decoder"], "lm_heads": {"kernel": heads}}
    return params, port_model(params)


def _stream(model, gen, **kw):
    chunks = list(pstreaming.stream_generate(model, gen, device="cpu", **_batch(), **kw))
    assert chunks[-1].finished and not any(c.finished for c in chunks[:-1])
    offsets = np.cumsum([0] + [c.codes.shape[2] for c in chunks[:-1]])
    assert [c.frame_offset for c in chunks] == offsets.tolist()
    return chunks, np.concatenate([c.codes for c in chunks], axis=2), np.concatenate([c.audio for c in chunks], 1)


def _one_shot(model, codes, lengths):
    """A one-shot vocode of codes cleaned as ``postprocess_tokens`` cleans
    them, audio zeroed past each sample's end."""
    frames = np.arange(codes.shape[2])
    clean = np.where((frames[None, None] < lengths[:, None, None]) & (codes < CB), codes, 0)
    audio = pcodec.decode(model.audio_encoder, torch.from_numpy(clean)).numpy()
    return np.where(np.arange(audio.shape[1])[None] < lengths[:, None] * HOP, audio, 0.0)


def test_stream_matches_offline_greedy(models):
    """The stream's raw codes are ``generate``'s token buffer undelayed, its
    valid lengths ``generate``'s code lengths (a sample ends early), and its
    audio a one-shot vocode of the cleaned codes."""
    _, model = models
    gen = pcfg.GenerationConfig(max_length=24, do_sample=False, **SPECIALS)
    offline = pgenerate.generate(model, gen, device="cpu", **_batch())
    chunks, codes, audio = _stream(model, gen, chunk_frames=5, lookback=8)
    raw = undelay_pattern(offline.tokens[:, :, 1:]).numpy()
    np.testing.assert_array_equal(codes, raw[:, :, : codes.shape[2]])
    lengths = chunks[-1].valid_lengths
    np.testing.assert_array_equal(lengths, offline.code_lengths.numpy())
    assert lengths.min() < codes.shape[2]  # a sample ended early: its audio stops there
    np.testing.assert_allclose(audio, _one_shot(model, codes, lengths), atol=1e-4, rtol=0)
    n = codes.shape[2] * HOP
    valid = np.arange(n)[None] < offline.audio_lengths.numpy()[:, None]
    np.testing.assert_allclose(np.where(valid, offline.audio.numpy()[:, :n], 0.0), audio, atol=1e-4, rtol=0)


def test_windowed_vocode_equals_one_shot_of_the_frames_so_far(loud):
    """Each chunk's audio is the new part of a one-shot vocode of every
    frame ready so far, once the lookback covers the codec's left receptive
    field (16 frames here; the DAC decoder's convolutions are centred, so a
    chunk has no right context beyond its last ready frame)."""
    _, model = loud
    gen = pcfg.GenerationConfig(max_length=40, do_sample=True, top_k=10, **SPECIALS)
    chunks, codes, _ = _stream(model, gen, chunk_frames=5, lookback=16, generator=torch.Generator().manual_seed(0))
    assert chunks[-1].valid_lengths.min() > 5 and len(chunks) > 3
    peak = 0.0
    for c in chunks:
        ready = c.frame_offset + c.codes.shape[2]
        ref = _one_shot(model, codes[:, :, :ready], np.minimum(c.valid_lengths, ready))[:, c.frame_offset * HOP:]
        np.testing.assert_allclose(c.audio, ref, atol=1e-5, rtol=0)
        peak = max(peak, float(np.abs(ref).max()))
    assert peak > 1e-2


def test_first_chunk_and_generator_seed(models):
    """The first chunk holds at most ``chunk_frames`` frames from offset 0;
    with one generator seed the stream's codes are ``generate``'s."""
    _, model = models
    gen = pcfg.GenerationConfig(max_length=30, do_sample=True, top_k=10, **SPECIALS)
    it = pstreaming.stream_generate(model, gen, chunk_frames=6, lookback=8,
                                    generator=torch.Generator().manual_seed(1), device="cpu", **_batch())
    first = next(it)
    assert first.codes.shape[2] <= 6 and first.frame_offset == 0
    assert first.audio.shape[1] == first.codes.shape[2] * HOP
    rest = list(it)
    assert rest[-1].finished
    codes = np.concatenate([first.codes] + [c.codes for c in rest], axis=2)
    offline = pgenerate.generate(model, gen, generator=torch.Generator().manual_seed(1), vocode=False, device="cpu",
                                 **_batch())
    raw = undelay_pattern(offline.tokens[:, :, 1:]).numpy()
    np.testing.assert_array_equal(codes, raw[:, :, : codes.shape[2]])


def test_audio_prompt_continuation(models):
    """Codes of a voice sample continue it: the stream's first frames are
    the prompt codes, and the stream equals ``generate`` with them."""
    _, model = models
    prompt = np.random.default_rng(3).integers(0, CB, (2, K, 4)).astype(np.int32)
    gen = pcfg.GenerationConfig(max_length=20, do_sample=False, **SPECIALS)
    _, codes, _ = _stream(model, gen, chunk_frames=5, lookback=8, decoder_input_codes=prompt)
    np.testing.assert_array_equal(codes[:, :, :4], prompt)
    offline = pgenerate.generate(model, gen, decoder_input_codes=prompt, vocode=False, device="cpu", **_batch())
    np.testing.assert_array_equal(offline.codes.numpy()[:, :, :4], prompt)
    raw = undelay_pattern(offline.tokens[:, :, 1:]).numpy()
    np.testing.assert_array_equal(codes, raw[:, :, : codes.shape[2]])


def test_stream_matches_jax_stream(loud):
    """The same Gumbel noise under CFG: the same chunks as the JAX stream,
    codes exact and audio (about 0.1 at its peak) within 1e-4."""
    params, model = loud
    jgen = jcfg.GenerationConfig(max_length=26, do_sample=True, top_k=10, guidance_scale=3.0, **SPECIALS)
    pgen = pcfg.GenerationConfig.from_dict(jgen.to_dict())
    key = jax.random.PRNGKey(5)
    ref = list(jstreaming.stream_generate(params, tiny_config(jcfg), jgen, key=key, chunk_frames=5, lookback=8,
                                          dtype=np.float32, **_batch()))
    chunks, _, audio = _stream(model, pgen, chunk_frames=5, lookback=8, noise=gumbel_noise(key, (2, K, 40)))
    assert len(chunks) == len(ref) > 2 and np.abs(audio).max() > 1e-2
    for r, c in zip(ref, chunks):
        assert (r.frame_offset, r.finished) == (c.frame_offset, c.finished)
        np.testing.assert_array_equal(np.asarray(r.codes), c.codes)
        np.testing.assert_array_equal(np.asarray(r.valid_lengths), c.valid_lengths)
        np.testing.assert_allclose(np.asarray(r.audio), c.audio, atol=1e-4, rtol=0)


def test_stream_refuses_no_chunk(models):
    with pytest.raises(ValueError, match="chunk_frames"):
        next(pstreaming.stream_generate(models[1], pcfg.GenerationConfig(**SPECIALS), chunk_frames=0,
                                        device="cpu", **_batch()))
