"""The whole slice against the JAX package on the tiny composite at fp32:
``generate`` (greedy, and CFG + top-k sampling fed the JAX Gumbel noise),
``ParlerTTSPipeline.tts`` with one tokenizer object for both, and the
entry points refusing to fall back to the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu.pipeline import ParlerTTSPipeline as JaxPipeline
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.ops import flash_attention as pfa
from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer
from tests.test_torch_blocks import close, jax_params, port_model, tiny_config

torch.set_num_threads(1)  # tier-1 runs several pytest workers

SPECIALS = dict(decoder_start_token_id=33, pad_token_id=32, bos_token_id=33, eos_token_id=32)


@pytest.fixture(scope="module")
def models():
    params = jax_params(tiny_config(jcfg), seed=1)  # greedy output stops mid-way: trims are exercised
    return params, port_model(params)


def _batch():
    """Two requests of different lengths: right-padded descriptions,
    left-padded prompts."""
    rng = np.random.default_rng(12)
    ids = rng.integers(3, 160, (2, 9))
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    pids = rng.integers(3, 160, (2, 5))
    pmask = np.ones((2, 5), np.int32)
    pmask[0, :2] = 0
    return dict(input_ids=ids, attention_mask=mask, prompt_input_ids=pids, prompt_attention_mask=pmask)


def _both(models, gen_kw, noise_key=None):
    params, model = models
    jgen = jcfg.GenerationConfig(max_length=24, **SPECIALS, **gen_kw)
    pgen = pcfg.GenerationConfig(max_length=24, **SPECIALS, **gen_kw)
    key = jax.random.PRNGKey(7)
    ref = jgenerate.generate(params, tiny_config(jcfg), jgen, key=key, **_batch())
    noise = None
    if noise_key is not None:
        shape = (2, model.cfg.decoder.num_codebooks, model.cfg.decoder.vocab_size)

        def noise(t):  # the noise jax.random.categorical draws at step t
            return torch.from_numpy(np.array(jax.random.gumbel(jax.random.fold_in(key, t), shape, jnp.float32)))

    out = pgenerate.generate(model, pgen, noise=noise, device="cpu", **_batch())
    return ref, out


def test_greedy_generate_matches_jax(models):
    ref, out = _both(models, dict(do_sample=False))
    np.testing.assert_array_equal(np.asarray(ref.tokens), out.tokens.numpy())
    np.testing.assert_array_equal(np.asarray(ref.codes), out.codes.numpy())
    np.testing.assert_array_equal(np.asarray(ref.code_lengths), out.code_lengths.numpy())
    np.testing.assert_array_equal(np.asarray(ref.audio_lengths), out.audio_lengths.numpy())
    assert 0 < out.code_lengths.min() and out.code_lengths.max() < out.codes.shape[-1]
    close(ref.audio, out.audio, 1e-5)


def test_cfg_topk_sampling_with_injected_noise_matches_jax(models):
    ref, out = _both(models, dict(do_sample=True, top_k=10, temperature=0.9, guidance_scale=3.0), noise_key=True)
    np.testing.assert_array_equal(np.asarray(ref.tokens), out.tokens.numpy())
    np.testing.assert_array_equal(np.asarray(ref.code_lengths), out.code_lengths.numpy())
    close(ref.audio, out.audio, 1e-5)


def test_pipeline_tts_matches_jax(models):
    """Same tokenizer object, greedy decoding: the same waveforms, and the
    same int16 PCM."""
    params, model = models
    tok = ToyTokenizer(vocab_size=150)
    descs = ["a female speaker with a low pitched voice", "clear audio quality"]
    prompts = ["hey how are you", "doing today"]
    for pcm16, max_seconds in ((False, None), (True, 0.008)):
        jgen = jcfg.GenerationConfig(max_length=20, do_sample=False, **SPECIALS)
        pgen = pcfg.GenerationConfig.from_dict(jgen.to_dict())
        jpipe = JaxPipeline(params, tiny_config(jcfg), jgen, tok, tok, dtype=jnp.float32, pcm16=pcm16)
        ppipe = ParlerTTSPipeline(model, tiny_config(pcfg), pgen, tok, tok, dtype=torch.float32,
                                  pcm16=pcm16, device="cpu")
        sr, ref = jpipe.tts(descs, prompts, max_seconds=max_seconds)
        psr, wavs = ppipe.tts(descs, prompts, max_seconds=max_seconds)
        assert psr == sr == 16000 and len(wavs) == len(ref) == 2
        for r, w in zip(ref, wavs):
            assert w.dtype == (np.int16 if pcm16 else np.float32) and w.shape == r.shape
            if pcm16:
                np.testing.assert_array_equal(w, r)
            else:
                close(r, w, 1e-5)


def test_entry_points_refuse_cuda_without_it(models, monkeypatch):
    """Asking for CUDA on a machine without it raises; nothing moves to the
    CPU on its own."""
    _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(pcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pparler.init(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pgenerate.generate(model, pcfg.GenerationConfig(**SPECIALS), **_batch())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ParlerTTSPipeline(model, cfg, pcfg.GenerationConfig(**SPECIALS), ToyTokenizer(), ToyTokenizer())
    assert next(model.parameters()).device.type == "cpu"


def test_cpu_run_launches_no_kernel(models):
    _, model = models
    before = pfa.LAUNCHES
    pgenerate.generate(model, pcfg.GenerationConfig(max_length=24, do_sample=False, **SPECIALS),
                       device="cpu", **_batch())
    assert pfa.LAUNCHES == before
