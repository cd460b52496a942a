"""Parity of the PyTorch port's building blocks with the JAX package, on CPU
at fp32: nn ops, convolutions, delay pattern, T5 encoder, DAC decode,
sampler, configs and the weight carry-over.  Inputs come from seeded numpy
and go through both packages.  The shared tiny-model helpers here are used
by the other ``test_torch_*`` files."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.core import torch_import as jti
from parler_tts_tpu.generation import sampling as jsampling
from parler_tts_tpu.models import dac as jdac
from parler_tts_tpu.models import delay_pattern as jdp
from parler_tts_tpu.models import parler as jparler
from parler_tts_tpu.models import t5_encoder as jt5
from parler_tts_tpu.ops import conv as jconv
from parler_tts_tpu.ops import nn as jnn
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core.from_jax import load_jax_params
from parler_tts_tpu_torch.generation import sampling as psampling
from parler_tts_tpu_torch.models import dac as pdac
from parler_tts_tpu_torch.models import delay_pattern as pdp
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.models import t5_encoder as pt5
from parler_tts_tpu_torch.ops import conv as pconv
from parler_tts_tpu_torch.ops import nn as pnn

torch.set_num_threads(1)  # tier-1 runs several pytest workers


def tiny_config(mod):
    """The tiny composite of tests/test_pipeline.py, built from either
    package's config module."""
    return mod.ParlerTTSConfig(
        vocab_size=160,
        text_encoder=mod.T5EncoderConfig(vocab_size=160, d_model=24, d_kv=6, d_ff=48, num_layers=1,
                                         num_heads=4),
        audio_encoder=mod.DACConfig(
            num_codebooks=4, codebook_size=32, codebook_dim=4, latent_dim=16,
            encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=16,
            upsampling_ratios=(4, 2), sampling_rate=16000, frame_rate=2000,
        ),
        decoder=mod.DecoderConfig(
            vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            ffn_dim=64, num_codebooks=4, max_position_embeddings=256,
            pad_token_id=32, eos_token_id=32, bos_token_id=33, dropout=0.0,
        ),
    )


def jax_init(init_fn, cfg, seed: int = 0):
    """``init_fn(key, cfg)`` under jit (eager init compiles op by op and is
    several times slower), with numpy leaves."""
    return jax.tree.map(np.asarray, jax.jit(init_fn, static_argnums=1)(jax.random.PRNGKey(seed), cfg))


def jax_params(cfg, seed: int = 0):
    return jax_init(jparler.init, cfg, seed)


def port_model(params):
    model = pparler.init(0, tiny_config(pcfg), device="cpu")
    load_jax_params(model, params)
    return model


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy() if torch.is_tensor(b) else b, atol=atol, rtol=0)


# --- nn ops ---------------------------------------------------------------


def test_nn_ops_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    kern = rng.standard_normal((12, 7)).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    scale = rng.standard_normal(12).astype(np.float32)
    shift = rng.standard_normal(12).astype(np.float32)
    close(jnn.dense({"kernel": kern, "bias": bias}, x), pnn.dense(T(x), T(kern), T(bias)), 1e-5)
    close(jnn.layer_norm({"scale": scale, "bias": shift}, x), pnn.layer_norm(T(x), T(scale), T(shift)), 1e-5)
    close(jnn.rms_norm({"scale": scale}, x), pnn.rms_norm(T(x), T(scale)), 1e-5)
    close(jnn.gelu(x), pnn.gelu(T(x)), 1e-6)
    close(jnn.gelu_new(x), pnn.gelu_new(T(x)), 1e-6)
    heads = pnn.split_heads(T(x), 3)
    close(jnn.split_heads(x, 3), heads, 0)
    close(jnn.merge_heads(jnn.split_heads(x, 3)), pnn.merge_heads(heads), 0)


def test_attention_scores_masks_with_finite_neg_inf():
    """A fully masked row comes out uniform over the keys, as in JAX."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 3, 6, 8)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((1, 3, 6, 6)).astype(np.float32)
    mask = np.ones((2, 1, 1, 6), bool)
    mask[1, ..., :] = False  # batch row 1: every key masked
    mask[0, ..., :2] = False
    ref = jnn.attention_scores(q, k, v, bias=bias, mask=mask)
    out = pnn.attention_scores(T(q), T(k), T(v), bias=T(bias), mask=T(mask))
    close(ref, out, 1e-5)
    close(np.broadcast_to(v[1].mean(axis=1, keepdims=True), (3, 6, 8)), out[1], 1e-5)


# --- convolutions -----------------------------------------------------------


@pytest.mark.parametrize("stride,dilation,padding", [(1, 1, 3), (1, 3, 9), (2, 1, 1), (4, 1, 2)])
def test_conv1d_matches_jax(stride, dilation, padding):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 23, 5)).astype(np.float32)
    kern = rng.standard_normal((7, 5, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    ref = jconv.conv1d({"kernel": kern, "bias": bias}, x, stride=stride, dilation=dilation, padding=padding)
    out = pconv.conv1d(T(x), T(kern), T(bias), stride=stride, dilation=dilation, padding=padding)
    close(ref, out, 1e-5)


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_conv_transpose1d_transplanted_conv_up(stride):
    """A torch ConvTranspose1d weight imported as the JAX package stores it
    (time-flipped, in/out-swapped WIO) converts back exactly, and the port's
    NWC function equals both JAX's and torch's own transposed conv."""
    rng = np.random.default_rng(3)
    cin, cout, width, pad = 6, 3, 2 * stride, -(-stride // 2)
    w_torch = rng.standard_normal((cin, cout, width)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    kern = jti._conv_t({"up.weight": w_torch, "up.bias": bias}, "up")["kernel"]
    np.testing.assert_array_equal(pconv.torch_conv_transpose1d_weight(T(kern)).numpy(), w_torch)

    x = rng.standard_normal((2, 9, cin)).astype(np.float32)
    ref = jconv.conv_transpose1d({"kernel": kern, "bias": bias}, x, stride=stride, padding=pad)
    out = pconv.conv_transpose1d(T(x), T(kern), T(bias), stride=stride, padding=pad)
    close(ref, out, 1e-5)
    native = torch.nn.functional.conv_transpose1d(T(x).transpose(1, 2), T(w_torch), T(bias),
                                                  stride=stride, padding=pad)
    close(ref, native.transpose(1, 2), 1e-5)


# --- delay pattern ----------------------------------------------------------


@pytest.mark.parametrize("k,seq_len,max_length", [(4, 1, 8), (9, 1, 40), (4, 3, 12), (4, 1, 6), (9, 2, 16)])
def test_delay_pattern_exact(k, seq_len, max_length):
    """Includes the short-sequence escape (max_length < 2K - 1)."""
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 30, (2, k, seq_len)).astype(np.int32)
    jp, jpat, jt0 = jdp.build_delay_pattern(ids, bos_token_id=33, pad_token_id=32, max_length=max_length)
    pp, ppat, pt0 = pdp.build_delay_pattern(T(ids), bos_token_id=33, pad_token_id=32, max_length=max_length)
    assert jt0 == pt0
    np.testing.assert_array_equal(np.asarray(jp), pp.numpy())
    np.testing.assert_array_equal(np.asarray(jpat), ppat.numpy())
    out = rng.integers(0, 30, (2, k, max_length)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jdp.apply_delay_pattern(out, jpat)),
                                  pdp.apply_delay_pattern(T(out), ppat).numpy())
    np.testing.assert_array_equal(np.asarray(jdp.undelay_pattern(out)), pdp.undelay_pattern(T(out)).numpy())


# --- T5 -------------------------------------------------------------------


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 40)])
def test_relative_position_bucket_exact(num_buckets, max_distance):
    rel = np.arange(-700, 700, dtype=np.int32)
    ref = jt5.relative_position_bucket(jnp.asarray(rel), num_buckets=num_buckets, max_distance=max_distance)
    out = pt5.relative_position_bucket(T(rel), num_buckets=num_buckets, max_distance=max_distance)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_t5_encode_matches_jax():
    jc, pc = jcfg.dummy_config().text_encoder, pcfg.dummy_config().text_encoder
    params = jax_init(jt5.init, jc, 5)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, jc.vocab_size, (3, 19))
    mask = np.ones((3, 19), np.int32)
    mask[1, 11:] = 0
    mask[2, 4:] = 0
    enc = pt5.T5Encoder(pc)
    load_jax_params(enc, params)
    close(jt5.encode(params, jc, ids, mask), enc(T(ids), T(mask)), 1e-5)


# --- DAC ------------------------------------------------------------------


def test_dac_decode_matches_jax():
    jc, pc = tiny_config(jcfg).audio_encoder, tiny_config(pcfg).audio_encoder
    params = jax_init(jdac.init, jc, 6)
    codec = pdac.DAC(pc)
    load_jax_params(codec, params)
    codes = np.random.default_rng(6).integers(0, jc.codebook_size, (2, jc.num_codebooks, 13))
    close(jdac.decode(params, jc, codes), codec.decode(T(codes)), 1e-5)


def test_snake_variants_match_jax():
    rng = np.random.default_rng(7)
    x = (4 * rng.standard_normal((2, 6, 50))).astype(np.float32)  # NCW here, NWC in JAX
    alpha = rng.uniform(0.2, 2.0, 6).astype(np.float32)
    x_nwc = x.transpose(0, 2, 1)
    close(jdac.snake(x_nwc, alpha).transpose(0, 2, 1), pdac.snake(T(x), T(alpha)), 1e-5)
    close(jdac.snake_fast(x_nwc, alpha).transpose(0, 2, 1), pdac.snake_fast(T(x), T(alpha)), 1e-5)


# --- sampler ----------------------------------------------------------------


def test_sampler_processors_match_jax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 4, 40)).astype(np.float32)
    logits[0, 0, :5] = logits[0, 0].max() + 1.0  # ties at the k-th value are kept
    close(jsampling.apply_top_k(logits, 5), psampling.apply_top_k(T(logits), 5), 0)
    close(jsampling.apply_top_k(logits, 7), psampling.apply_top_k(T(logits), 7), 0)
    close(jsampling.apply_top_p(logits, 0.8), psampling.apply_top_p(T(logits), 0.8), 0)
    uncond = rng.standard_normal((2, 4, 40)).astype(np.float32)
    close(jsampling.apply_cfg(logits, uncond, 3.0), psampling.apply_cfg(T(logits), T(uncond), 3.0), 1e-5)


def test_select_tokens_is_gumbel_argmax_of_injected_noise():
    key = jax.random.PRNGKey(9)
    logits = np.random.default_rng(9).standard_normal((3, 4, 40)).astype(np.float32)
    gen = pcfg.GenerationConfig(do_sample=True)
    noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    ref = jax.random.categorical(key, jnp.asarray(logits), axis=-1)
    np.testing.assert_array_equal(np.asarray(ref), psampling.select_tokens(T(logits), gen, noise=T(noise)).numpy())


# --- config and weights -------------------------------------------------------


def test_config_reads_the_json_the_jax_package_writes(tmp_path):
    jc = jcfg.mini_600m_config()
    jc.save(str(tmp_path / "config.json"))
    assert pcfg.ParlerTTSConfig.load(str(tmp_path / "config.json")) == pcfg.mini_600m_config()
    jg = jcfg.GenerationConfig(max_length=300, top_k=50, guidance_scale=2.0)
    jg.save(str(tmp_path / "generation_config.json"))
    assert pcfg.GenerationConfig.load(str(tmp_path / "generation_config.json")) == pcfg.GenerationConfig(
        max_length=300, top_k=50, guidance_scale=2.0
    )
    d = json.loads((tmp_path / "config.json").read_text())
    d["audio_encoder"] = jcfg.EncodecConfig().to_dict()
    assert pcfg.ParlerTTSConfig.from_dict(d).audio_encoder == pcfg.EncodecConfig()


def test_load_jax_params_copies_every_leaf_and_rejects_mismatch():
    params = jax_params(tiny_config(jcfg))
    model = port_model(params)
    np.testing.assert_array_equal(
        model.decoder.layers[1].fc1.kernel.numpy(), params["decoder"]["layers"]["fc1"]["kernel"][1]
    )
    extra = {**params, "unexpected": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="unexpected"):
        load_jax_params(model, extra)
    missing = {k: v for k, v in params.items() if k != "embed_prompts"}
    with pytest.raises(ValueError, match="embed_prompts"):
        load_jax_params(model, missing)
