"""The port's int8 storage against the JAX package's at fp32 on CPU:
``ops/quantization.py`` (values and scales bit for bit), int8 ``dense`` and
LM heads, the decode parameter view (``prepare_decode_params``), the int8
KV cache, and ``generate`` with ``kv_cache_dtype="int8"``, ``int8_weights``
or both, token for token, greedy and with the JAX sampler's Gumbel noise
under CFG.  Mirrors ``tests/test_quantization.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu.models import decoder as jdec
from parler_tts_tpu.ops import nn as jnn
from parler_tts_tpu.ops import quantization as jq
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.models import decoder as pdec
from parler_tts_tpu_torch.ops import nn as pnn
from parler_tts_tpu_torch.ops import quantization as pq
from tests.test_torch_blocks import T, close, jax_params, port_model, tiny_config
from tests.test_torch_generate import SPECIALS, _batch

torch.set_num_threads(1)  # tier-1 runs several pytest workers


def gumbel_noise(key, shape):
    """``noise(t)``: the Gumbel noise ``jax.random.categorical`` draws at
    step t from ``fold_in(key, t)``, as the port's sampler takes it."""
    def noise(t):
        return torch.from_numpy(np.array(jax.random.gumbel(jax.random.fold_in(key, t), shape, jnp.float32)))
    return noise


@pytest.fixture(scope="module")
def models():
    params = jax_params(tiny_config(jcfg), seed=1)
    return params, port_model(params)


def _equal(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_quantize_kv_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 17, 64)) * 4.0).astype(np.float32)
    x[0, 0, 3] = 0.0  # an all-zero row takes the 1e-8 floor
    x[1, 2, 4, :8] = 0.5  # ties of round-half-even
    ref_q, ref_s = jq.quantize_kv(jnp.asarray(x))
    q, s = pq.quantize_kv(T(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (3, 5, 17)
    _equal(ref_q, q)
    _equal(ref_s, s)
    _equal(jq.dequantize_kv(ref_q, ref_s), pq.dequantize_kv(q, s))
    # symmetric int8: the error is at most half a step, amax / 254 per row
    amax = np.abs(x).max(axis=-1, keepdims=True)
    assert (np.abs(pq.dequantize_kv(q, s).numpy() - x) / np.maximum(amax, 1e-8)).max() <= 0.5 / 127 + 1e-6


def test_quantize_dense_and_lm_heads_match_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    for shape in ((32, 48), (2, 32, 96), (4, 32, 40)):
        w = rng.standard_normal(shape).astype(np.float32)
        ref = jq.quantize_dense(jnp.asarray(w))
        q, s = pq.quantize_dense(T(w))
        assert q.dtype == torch.int8 and s.shape == shape[:-2] + shape[-1:]
        _equal(ref["kernel_q"], q)
        _equal(ref["scale"], s)
    ref = jq.quantize_lm_heads(jnp.asarray(w))
    q, s = pq.quantize_lm_heads(T(w))
    _equal(ref["kernel_q"], q)
    _equal(ref["scale"], s)


def test_int8_dense_matches_jax():
    """(x @ w_int8) * scale, the scale cast to the compute dtype first:
    within 1e-6 of JAX's, equal to the dequantized product up to fp32
    rounding and within int8's error of the fp32 product."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    ref = jnn.dense(jq.quantize_dense(jnp.asarray(w)), jnp.asarray(x))
    weight = pnn.DenseWeight.of(T(w), int8=True)
    got = weight(T(x))
    close(ref, got, 1e-6)
    close(T(x) @ (weight.kernel.float() * weight.scale[None, :]), got, 1e-5)
    exact = x @ w
    assert np.abs(got.numpy() - exact).max() / np.abs(exact).max() < 2e-2
    close(x @ w, pnn.DenseWeight.of(T(w))(T(x)), 1e-5)  # unquantized: the kernel as it is


def test_decode_view_matches_prepare_decode_params(models):
    """Fused q/k/v and, with int8, every decode matmul's int8 kernel and
    scales equal to JAX ``prepare_decode_params``'s; the int8 LM heads give
    JAX's logits within 1e-6."""
    params, model = models
    decoder = model.decoder
    for int8 in (False, True):
        ref = jdec.prepare_decode_params(params["decoder"], int8=int8)
        view = decoder.decode_params(int8=int8)
        rl, ra, rc = ref["layers"], ref["layers"]["self_attn"], ref["layers"]["cross_attn"]
        pairs = {"qkv": ra["qkv"], "o": ra["o"], "cross_q": rc["q"], "cross_o": rc["o"], "fc1": rl["fc1"],
                 "fc2": rl["fc2"]}
        for name, leaf in pairs.items():
            got = [getattr(layer, name) for layer in view.layers]
            if int8:
                _equal(leaf["kernel_q"], torch.stack([g.kernel for g in got]))
                _equal(leaf["scale"], torch.stack([g.scale for g in got]))
            else:
                _equal(leaf["kernel"], torch.stack([g.kernel for g in got]))
                assert all(g.scale is None for g in got)
        hidden = np.random.default_rng(3).standard_normal((2, 3, decoder.cfg.hidden_size)).astype(np.float32)
        close(jdec.logits(ref, jnp.asarray(hidden)), decoder.logits(T(hidden), heads=view.lm_heads), 1e-6)
    assert view.lm_heads.kernel.dtype == torch.int8 and view.lm_heads.scale.shape == (4, 40)


def _decode_run(decoder, kv_dtype, steps=8):
    """Prefill one BOS frame, then ``steps`` cached steps; hidden states."""
    cfg = decoder.cfg
    rng = np.random.default_rng(4)
    b, s_len = 2, 7
    ids = T(rng.integers(0, cfg.vocab_size, (b, cfg.num_codebooks, steps + 1)).astype(np.int32))
    enc = T(rng.standard_normal((b, s_len, cfg.hidden_size)).astype(np.float32))
    enc_mask = torch.ones((b, s_len), dtype=torch.int32)
    mask = torch.ones((b, steps + 1), dtype=torch.int32)
    cache = pdec.init_cache(cfg, b, steps + 1, s_len, dtype=torch.float32, device=torch.device("cpu"),
                            kv_dtype=kv_dtype)
    outs = [decoder(ids[:, :, :1], encoder_hidden_states=enc, encoder_attention_mask=enc_mask,
                    attention_mask=mask, cache=cache)]
    view = decoder.decode_params()
    for t in range(1, steps + 1):
        outs.append(decoder.decode_step(ids[:, :, t:t + 1], cache, attention_mask=mask,
                                        encoder_attention_mask=enc_mask, params=view))
    return torch.cat(outs, dim=1), cache


def test_int8_kv_cache_decode_stays_close_to_fp32(models):
    """The int8 cache: int8 rows with bf16 scales, self and cross; the
    decode stays within int8's error of the fp32 cache."""
    decoder = models[1].decoder
    fp, _ = _decode_run(decoder, None)
    q8, cache = _decode_run(decoder, "int8")
    assert cache.self_k.dtype == cache.cross_v.dtype == torch.int8
    assert cache.self_k_scale.dtype == cache.cross_v_scale.dtype == torch.bfloat16
    assert cache.self_k_scale.shape == (2, 2, 4, 9) and cache.cross_k_scale.shape == (2, 2, 4, 7)
    # K and V of (L, B, H) = (2, 2, 4) over 9 + 7 positions: int8 rows of D = 8 and a bf16 scale each
    assert cache.nbytes == 2 * (2 * 2 * 4) * (9 + 7) * (8 + 2)
    rel = ((q8 - fp).abs().max() / fp.abs().max()).item()
    assert 0 < rel < 5e-2, rel


@pytest.mark.parametrize("kv_cache_dtype,int8_weights", [("int8", False), (None, True), ("int8", True)],
                         ids=["kv", "weights", "both"])
@pytest.mark.parametrize("sampling", ["greedy", "cfg_noise"])
def test_generate_int8_matches_jax(models, kv_cache_dtype, int8_weights, sampling):
    params, model = models
    kw = dict(do_sample=False) if sampling == "greedy" else dict(do_sample=True, top_k=10, guidance_scale=3.0)
    jgen = jcfg.GenerationConfig(max_length=24, kv_cache_dtype=kv_cache_dtype, int8_weights=int8_weights,
                                 **SPECIALS, **kw)
    pgen = pcfg.GenerationConfig.from_dict(jgen.to_dict())
    key = jax.random.PRNGKey(7)
    ref = jgenerate.generate(params, tiny_config(jcfg), jgen, key=key, **_batch())
    noise = gumbel_noise(key, (2, 4, 40)) if sampling != "greedy" else None
    out = pgenerate.generate(model, pgen, noise=noise, device="cpu", **_batch())
    _equal(ref.tokens, out.tokens)
    _equal(ref.code_lengths, out.code_lengths)
    close(ref.audio, out.audio, 1e-5)


def test_int8_prefill_runs_the_unquantized_weights(models, monkeypatch):
    """The prefill and its first logits use the model's own weights; only
    the decode steps see the int8 view (JAX ``generate.py:187-216``)."""
    _, model = models
    decoder = model.decoder
    seen = []
    real = decoder.logits
    monkeypatch.setattr(decoder, "logits", lambda hidden, num_labels=None, heads=None: seen.append(
        heads) or real(hidden, num_labels, heads))
    gen = pcfg.GenerationConfig(max_length=12, do_sample=False, int8_weights=True, **SPECIALS)
    pgenerate.generate(model, gen, vocode=False, device="cpu", **_batch())
    assert seen[0] is None and len(seen) > 1
    assert all(h is not None and h.kernel.dtype == torch.int8 for h in seen[1:])
