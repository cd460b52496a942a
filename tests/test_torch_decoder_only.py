"""Decoder-only generation and audio-prompted continuation against the JAX
package on the tiny composite at fp32: ``generate_decoder_only`` (a free
run from BOS, codes of 0 and 3 frames, ``input_values``, embedded prompt
states), composite ``generate(input_values=...)`` and
``generate(decoder_input_codes=...)``, greedy and with the JAX sampler's
Gumbel noise under CFG; the stereo code repeat; the decoder without
cross-attention."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu.models import codec as jcodec
from parler_tts_tpu.models import decoder as jdecoder
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.models import decoder as pdecoder
from parler_tts_tpu_torch.models.dac import pad_audio
from parler_tts_tpu_torch.models.parler import init as pinit
from tests.test_torch_blocks import T, close, jax_params, port_model, tiny_config
from tests.test_torch_generate import SPECIALS, _batch
from tests.test_torch_quantization import gumbel_noise

torch.set_num_threads(1)  # tier-1 runs several pytest workers

K, V, H, HOP = 4, 40, 32, 8
SAMPLING = {"greedy": dict(do_sample=False), "cfg_noise": dict(do_sample=True, top_k=10, guidance_scale=3.0),
            "noise": dict(do_sample=True, top_k=10)}


@pytest.fixture(scope="module")
def models():
    params = jax_params(tiny_config(jcfg), seed=1)
    return params, port_model(params)


def _gens(sampling, max_length=24):
    jgen = jcfg.GenerationConfig(max_length=max_length, **SPECIALS, **SAMPLING[sampling])
    return jgen, pcfg.GenerationConfig.from_dict(jgen.to_dict())


def _wave():
    """Two seeded waveforms of 3 hops: 3 frames of codes each."""
    rng = np.random.default_rng(5)
    return (0.3 * np.sin(np.arange(3 * HOP) * rng.uniform(0.2, 0.9, (2, 1)))
            + 0.05 * rng.standard_normal((2, 3 * HOP))).astype(np.float32)


def _source(name):
    rng = np.random.default_rng(6)
    codes3 = rng.integers(0, 32, (2, K, 3)).astype(np.int32)
    prompt = rng.standard_normal((2, 5, H)).astype(np.float32)
    p_mask = np.ones((2, 5), np.int32)
    p_mask[0, :2] = 0  # left-padded
    return {
        "free": dict(batch_size=2),
        "codes0": dict(decoder_input_codes=np.zeros((2, K, 0), np.int32)),
        "codes3": dict(decoder_input_codes=codes3),
        "input_values": dict(input_values=_wave()),
        "prompt_hidden": dict(decoder_input_codes=codes3, prompt_hidden_states=prompt,
                              prompt_attention_mask=p_mask),
    }[name]


def _check(ref, out):
    np.testing.assert_array_equal(np.asarray(ref.tokens), out.tokens.numpy())
    np.testing.assert_array_equal(np.asarray(ref.code_lengths), out.code_lengths.numpy())
    close(ref.audio, out.audio, 1e-5)


@pytest.mark.parametrize("source,sampling", [
    ("free", "greedy"), ("free", "cfg_noise"), ("codes0", "greedy"), ("codes3", "cfg_noise"), ("codes3", "noise"),
    ("input_values", "greedy"), ("prompt_hidden", "greedy"), ("prompt_hidden", "cfg_noise")])
def test_generate_decoder_only_matches_jax(models, source, sampling):
    params, model = models
    jgen, pgen = _gens(sampling)
    key = jax.random.PRNGKey(3)
    kw = _source(source)
    ref = jgenerate.generate_decoder_only(params, tiny_config(jcfg), jgen, key=key, **kw)
    noise = gumbel_noise(key, (2, K, V)) if pgen.do_sample else None
    out = pgenerate.generate_decoder_only(model, pgen, noise=noise, device="cpu", **kw)
    _check(ref, out)
    if "decoder_input_codes" in kw:  # the audio prompt heads the output
        frames = kw["decoder_input_codes"].shape[2]
        np.testing.assert_array_equal(out.codes.numpy()[:, :, :frames], kw["decoder_input_codes"])


@pytest.mark.parametrize("source,sampling", [("input_values", "greedy"), ("decoder_input_codes", "cfg_noise")])
def test_composite_continuation_matches_jax(models, source, sampling):
    params, model = models
    jgen, pgen = _gens(sampling)
    key = jax.random.PRNGKey(4)
    kw = {"input_values": _wave()} if source == "input_values" else {"decoder_input_codes": _source(
        "codes3")["decoder_input_codes"]}
    ref = jgenerate.generate(params, tiny_config(jcfg), jgen, key=key, **_batch(), **kw)
    noise = gumbel_noise(key, (2, K, V)) if pgen.do_sample else None
    out = pgenerate.generate(model, pgen, noise=noise, device="cpu", **_batch(), **kw)
    _check(ref, out)


def test_input_values_codes_equal_jax_but_at_near_ties(models):
    """The DAC's codes of the audio prompt: any code that differs from
    JAX's must be a near-tie of the nearest-codebook walk (its score within
    1e-5 of the best); none is expected."""
    params, model = models
    wave = _wave()
    ref = np.asarray(jcodec.encode(params["audio_encoder"], tiny_config(jcfg).audio_encoder, jnp.asarray(wave)))
    codec = model.audio_encoder
    got = codec.encode(T(wave))
    with torch.no_grad():
        z = codec.encoder(pad_audio(T(wave), HOP)[:, None]).transpose(1, 2)
        gaps = codec.quantizer.code_gaps(z, torch.from_numpy(ref.copy()))
    differ = got.numpy() != ref
    assert float(gaps.max()) <= 1e-5
    assert int(differ.sum()) == 0, f"{int(differ.sum())} codes differ at near-ties"


def _stereo_config(mod):
    cfg = tiny_config(mod)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_codebooks=2 * K, audio_channels=2))


def test_stereo_repeats_mono_codes_and_refuses_to_vocode():
    """A stereo decoder (2K streams) takes mono codes repeated per channel
    (JAX ``generate`` ``:423-429``): the same tokens as the repeated codes
    given; there is no stereo vocode."""
    model = pinit(2, _stereo_config(pcfg), device="cpu")
    codes = _source("codes3")["decoder_input_codes"]
    _, pgen = _gens("greedy")
    out = pgenerate.generate(model, pgen, decoder_input_codes=codes, vocode=False, device="cpu", **_batch())
    both = pgenerate.generate(model, pgen, decoder_input_codes=np.repeat(codes, 2, axis=1), vocode=False,
                              device="cpu", **_batch())
    assert out.tokens.shape[1] == 2 * K
    assert torch.equal(out.tokens, both.tokens)
    for channel in (0, 1):
        np.testing.assert_array_equal(out.codes.numpy()[:, channel::2, :3], codes)
    with pytest.raises(ValueError, match="no stereo vocode"):
        pgenerate.generate(model, pgen, decoder_input_codes=codes, device="cpu", **_batch())


def test_decoder_without_cross_attention_matches_jax(models, monkeypatch):
    """No encoder states: the prefill and the cached steps skip the whole
    cross block (``ln_cross`` included), the cache holds no cross K/V, and
    hidden states on valid rows equal JAX's (its XLA path gives fully
    masked rows uniform attention where K1 gives 0)."""
    params, model = models
    decoder, jp, cfg = model.decoder, params["decoder"], tiny_config(jcfg).decoder
    rng = np.random.default_rng(8)
    prompt = rng.standard_normal((2, 4, H)).astype(np.float32)
    steps = rng.integers(0, V, (3, 2, K, 1)).astype(np.int32)
    start = np.full((2, K, 1), cfg.bos_token_id, np.int32)
    fused = np.concatenate([np.array([[0, 1, 1, 1], [1, 1, 1, 1]], np.int32), np.ones((2, 4), np.int32)], 1)
    calls = []
    for layer in decoder.layers:
        monkeypatch.setattr(layer.ln_cross, "forward", lambda x: calls.append(1) or x)

    cache = jdecoder.init_cache(cfg, 2, fused.shape[1], 0)
    ref, cache = jdecoder.forward(jp, cfg, start, prompt_hidden_states=prompt, attention_mask=fused, cache=cache,
                                  prefill=True)
    pcache = pdecoder.init_cache(decoder.cfg, 2, fused.shape[1], 0, dtype=torch.float32,
                                 device=torch.device("cpu"))
    hidden = decoder(T(start), prompt_hidden_states=T(prompt), attention_mask=T(fused), cache=pcache)
    assert pcache.cross_k is None and pcache.cross_v is None
    valid = fused[:, :5].astype(bool)
    close(np.asarray(ref)[valid], hidden.numpy()[valid], 1e-4)
    view = decoder.decode_params()
    for ids in steps:
        ref, cache = jdecoder.forward(jp, cfg, ids, cache=cache, attention_mask=jnp.asarray(fused))
        hidden = decoder.decode_step(T(ids), pcache, attention_mask=T(fused), params=view)
        assert torch.isfinite(hidden).all()
        close(ref, hidden, 1e-4)
    assert not calls
