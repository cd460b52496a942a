"""K5, the decode step's single-query attention: the port's plain version
(what the wrapper runs on CPU tensors) against the JAX package's decode
arithmetic (``_self_attention_decode`` / ``_cross_attention_decode``) and
against the int8 ``_attend`` at unit scales, the split choice, the wrapper's
refusals, and the decoder's dispatch (CPU and int8 caches keep their plain
paths).  The CUDA
kernel itself is checked on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.models import decoder as jdecoder
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.models import decoder as pdecoder
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.ops import decode_attention as pda
from tests.test_torch_blocks import tiny_config

torch.set_num_threads(1)  # tier-1 runs several pytest workers

B, H, D = 3, 2, 64  # D = 64: the scale 1/8 is exact, so JAX's q is ours bit for bit


def _holed_mask(r: int, full_row: int | None = None) -> np.ndarray:
    """(B, r) decode masks with holes: row 0 left bucket padding, a short
    prompt's right padding, then decoded positions; row 1 a hole in the
    middle and the last keys masked (not yet decoded); row 2 all valid, or
    all masked when ``full_row`` is 2."""
    m = np.ones((B, r), np.int32)
    m[0, :5] = 0
    m[0, 9:13] = 0
    m[1, r // 2 : r // 2 + 7] = 0
    m[1, -3:] = 0
    if full_row is not None:
        m[full_row] = 0
    return m


def _qkv(r: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32) * 0.125
    k, v = (rng.standard_normal((B, H, r, D)).astype(np.float32) for _ in range(2))
    return q, k, v


def _cfg():
    return types.SimpleNamespace(head_dim=D, num_attention_heads=H, hidden_size=H * D)


def _eye():
    return {"kernel": jnp.eye(H * D, dtype=jnp.float32)}


def _merge(x: np.ndarray) -> np.ndarray:
    """(B, H, 1, D) -> (B, 1, H * D)"""
    return x.transpose(0, 2, 1, 3).reshape(B, 1, H * D)


def _split(x) -> np.ndarray:
    """(B, 1, H * D) -> (B, H, 1, D)"""
    return np.asarray(x).reshape(B, 1, H, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("r", [1, 70, 128, 203])
def test_plain_version_matches_jax_cross_attention_decode(r):
    """Cross attention over (B, H, R, D) cached K/V with holes in the key
    mask and one row whose keys are all masked (uniform attention in
    both)."""
    q, k, v = _qkv(r)
    mask = _holed_mask(r, full_row=2) if r > 20 else np.ones((B, r), np.int32)
    p = {"q": _eye(), "o": _eye()}  # x @ I and the 1/8 scale are exact: JAX's q is ours
    ref = jdecoder._cross_attention_decode(p, _cfg(), jnp.asarray(_merge(q) * 8.0), jnp.asarray(k),
                                           jnp.asarray(v), None, None,
                                           jnp.asarray(mask.astype(bool))[:, None, None, :])
    out = pda.decode_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    np.testing.assert_allclose(out.numpy(), _split(ref), atol=1e-5, rtol=0)
    if r > 20:  # the masked row is the mean of its values
        np.testing.assert_allclose(out[2].numpy(), v[2].mean(axis=1, keepdims=True), atol=1e-5, rtol=0)


@pytest.mark.parametrize("r", [9, 100, 129])
def test_plain_version_matches_jax_self_attention_decode(r):
    """JAX's self-attention step over a flushed cache of r positions (its
    pad mask with holes), an empty stage and the current token: the plain
    version over the r cached keys and the current one after them."""
    q, past_k, past_v = _qkv(r, seed=1)
    rng = np.random.default_rng(2)
    wk, wv = (rng.standard_normal((H * D, H * D)).astype(np.float32) / 16 for _ in range(2))
    p = {"q": _eye(), "k": {"kernel": jnp.asarray(wk)}, "v": {"kernel": jnp.asarray(wv)}, "o": _eye()}
    pad = _holed_mask(r)
    stage = jnp.zeros((jdecoder.STAGE, B, H, D), jnp.float32)
    ref, (k_new, v_new) = jdecoder._self_attention_decode(
        p, _cfg(), jnp.asarray(_merge(q) * 8.0), jnp.asarray(past_k.transpose(0, 1, 3, 2)),
        jnp.asarray(past_v.transpose(0, 1, 3, 2)), stage, stage, None, None, jnp.asarray(r), jnp.asarray(r),
        jnp.asarray(pad))
    k = np.concatenate([past_k, np.asarray(k_new)], axis=2)
    v = np.concatenate([past_v, np.asarray(v_new)], axis=2)
    mask = np.concatenate([pad, np.ones((B, 1), np.int32)], axis=1)
    out = pda.decode_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    np.testing.assert_allclose(out.numpy(), _split(ref), atol=1e-5, rtol=0)


def _unit_scales(k: torch.Tensor) -> dict:
    """Scales of 1 (exact in both products) for a (B, H, R, D) cache."""
    ones = torch.ones(k.shape[:3])
    return dict(k_scale=ones, v_scale=ones)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,full_row", [(70, None), (203, 2), (64, 0)])
def test_plain_version_is_attend_bit_for_bit(dtype, r, full_row):
    """The plain version is the int8 cache's ``_attend`` at unit scales, bit
    for bit, on a strided cache slice (a layer of a longer buffer read over r
    keys) and a mask of bools or int64."""
    q, k, v = _qkv(r, seed=3)
    buf = torch.from_numpy(np.random.default_rng(4).standard_normal((2, B, H, r + 37, D)).astype(np.float32))
    buf[1, :, :, :r] = torch.from_numpy(k)
    k_slice = buf[1, :, :, :r].to(dtype)
    mask = torch.from_numpy(_holed_mask(r, full_row))
    qt, vt = torch.from_numpy(q).to(dtype), torch.from_numpy(v).to(dtype)
    want = pdecoder._attend(qt, k_slice, vt, mask, **_unit_scales(k_slice))
    for m in (mask.bool(), mask.long()):
        got = pda.decode_attention(qt, k_slice, vt, m)
        assert got.dtype == dtype and torch.equal(got, want)


def test_split_choice():
    """One split once B * H rows give every SM its blocks (the cells' 96 x
    16 rows); more for a stream's or a small batch's rows, each of at least
    64 keys; at most 4096 keys a split; no empty split."""
    assert pda.decode_split(96 * 16, 558, 132) == (1, 558)
    assert pda.decode_split(96 * 16, 934, 132) == (1, 934)
    assert pda.decode_split(96 * 16, 64, 132) == (1, 64)  # cross attention
    for bh in (1 * 16, 4 * 16):
        for r in (934, 4096):
            splits, chunk = pda.decode_split(bh, r, 132)
            assert splits > 1 and chunk >= 63
    assert pda.decode_split(16, 934, 132)[0] == 15
    assert pda.decode_split(64, 4096, 132)[0] == 9
    assert pda.decode_split(16, 40, 132) == (1, 40)  # too few keys to split
    assert pda.decode_split(96 * 16, 10_000, 132) == (3, 3334)  # the shared-memory cap
    for bh in (1, 2, 16, 64, 256, 1536, 5000):
        for r in (1, 63, 64, 65, 500, 934, 4096, 4097, 9000):
            splits, chunk = pda.decode_split(bh, r, 132)
            assert 1 <= chunk <= pda.MAX_CHUNK and (splits - 1) * chunk < r <= splits * chunk


def _refused(exc, q, k, v, mask, match):
    with pytest.raises(exc, match=match):
        pda._check(q, k, v, mask)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks the CUDA route makes before a launch (device-free, so
    they run here too)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(70))
    mask = torch.ones((B, 70), dtype=torch.bool)
    pda._check(q, k, v, mask)
    pda._check(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask.int())
    _refused(TypeError, q.half(), k.half(), v.half(), mask, "fp32 or bf16")
    _refused(TypeError, q, k.bfloat16(), v, mask, "one dtype")
    _refused(ValueError, q[..., :48], k[..., :48], v[..., :48], mask, "head dim")
    _refused(ValueError, q, k, v, mask[:, :69], "kv_mask must be")
    _refused(ValueError, q, k, v, mask[:2], "kv_mask must be")
    _refused(TypeError, q, k, v, mask.float(), "bool or integer")
    _refused(ValueError, q.expand(B, H, 2, D), k, v, mask, "one query")
    _refused(ValueError, q, k[:, :1], v, mask, "matching q")
    _refused(ValueError, q, k.transpose(-1, -2).contiguous().transpose(-1, -2), v, mask, "unit stride")
    wide = torch.zeros((B, H, 70, D + 1))
    _refused(ValueError, q, k, wide[..., 1:], mask, "16-byte")  # rows 65 elements apart
    _refused(ValueError, q, k, v, mask.t().contiguous().t(), "unit stride over R")


@pytest.mark.parametrize("group", [1, 2, 4])
def test_grouped_query_plain_version_is_mha_over_repeated_kv(group):
    """Query head h reads K/V head h // group: the plain version over
    grouped K/V equals it over K/V repeated to the query heads
    (``repeat_interleave``), at fp32, at any group; the kernel's checks
    take H / H_kv in ``GROUPS`` and refuse a group it has no instance of."""
    g = torch.Generator().manual_seed(group)
    kv_heads, r = 8 // group, 37
    q = torch.randn((3, 8, 1, D), generator=g) * D**-0.5
    k, v = torch.randn((3, kv_heads, r, D), generator=g), torch.randn((3, kv_heads, r, D), generator=g)
    mask = torch.rand((3, r), generator=g) > 0.3
    got = pda.decode_attention_plain(q, k, v, mask)
    want = pda.decode_attention_plain(q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1), mask)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    if group in pda.GROUPS:
        pda._check(q, k, v, mask)
        assert pda.decode_split(3 * kv_heads, 8192, 132, group)[1] <= pda.MAX_CHUNK // group
    else:  # the kernel has no instance of this group
        _refused(ValueError, q, k, v, mask, "H / H_kv")
    _refused(ValueError, q, k[:, :1], v[:, :1], mask, "H / H_kv")  # a group of 8
    _refused(ValueError, q[:, :6], k[:, :4].repeat(1, 2, 1, 1)[:, :4], v[:, :4].repeat(1, 2, 1, 1)[:, :4], mask,
             "H / H_kv")  # 6 query heads over 4 K/V heads


def _decoder_and_cache(kv_dtype=None):
    cfg = tiny_config(pcfg)
    decoder = pparler.init(0, cfg, device="cpu").decoder
    dcfg = cfg.decoder
    rng = np.random.default_rng(5)
    b, p_len, s_len = 2, 5, 7
    enc = torch.from_numpy(rng.standard_normal((b, s_len, dcfg.hidden_size)).astype(np.float32))
    enc_mask = torch.ones((b, s_len), dtype=torch.int64)
    enc_mask[1, 4:] = 0
    prompt = torch.from_numpy(rng.standard_normal((b, p_len, dcfg.hidden_size)).astype(np.float32))
    fused = torch.ones((b, p_len + 4), dtype=torch.int32)
    fused[0, :2] = 0
    start = torch.full((b, dcfg.num_codebooks, 1), dcfg.bos_token_id, dtype=torch.int32)
    cache = pdecoder.init_cache(dcfg, b, fused.shape[1], s_len, dtype=torch.float32, device=torch.device("cpu"),
                                kv_dtype=kv_dtype)
    decoder(start, prompt_hidden_states=prompt, encoder_hidden_states=enc, encoder_attention_mask=enc_mask,
            attention_mask=fused, cache=cache)
    ids = torch.from_numpy(rng.integers(0, dcfg.vocab_size, (b, dcfg.num_codebooks, 1)).astype(np.int32))
    return decoder, cache, dict(params=decoder.decode_params(), attention_mask=fused,
                                encoder_attention_mask=enc_mask), ids


def test_cpu_decode_step_takes_the_plain_version(monkeypatch):
    """On CPU tensors every layer's self and cross attention runs the plain
    version (the CUDA route is never reached), and the step's hidden
    states are those of ``_attend`` at unit scales in its place, bit for
    bit."""
    decoder, cache, kw, ids = _decoder_and_cache()
    saved = (cache.index, cache.self_k.clone(), cache.self_v.clone())
    calls = []
    real = pda.decode_attention_plain
    monkeypatch.setattr(pda, "decode_attention_plain", lambda **kw: calls.append(kw["k"].shape[2]) or real(**kw))
    monkeypatch.setattr(pda, "_decode_cuda", lambda **kw: pytest.fail("the CUDA route on CPU tensors"))
    got = decoder.decode_step(ids, cache, **kw)
    layers = decoder.cfg.num_hidden_layers
    assert calls == [cache.index, 7] * layers  # self over [0, index], cross over the 7 encoder positions
    cache.index, cache.self_k, cache.self_v = saved[0], saved[1], saved[2]
    monkeypatch.setattr(pdecoder, "decode_attention", lambda q, k, v, m: pdecoder._attend(q, k, v, m, **_unit_scales(k)))
    assert torch.equal(decoder.decode_step(ids, cache, **kw), got)


def test_int8_decode_step_keeps_attend(monkeypatch):
    """An int8 cache's step folds its scales in ``_attend`` and never
    reaches the decode attention kernel's wrapper."""
    decoder, cache, kw, ids = _decoder_and_cache("int8")
    calls = []
    real = pdecoder._attend
    monkeypatch.setattr(pdecoder, "_attend", lambda *a, **k: calls.append(k["k_scale"] is not None) or real(*a, **k))
    monkeypatch.setattr(pdecoder, "decode_attention", lambda *a: pytest.fail("an int8 cache took K5"))
    out = decoder.decode_step(ids, cache, **kw)
    assert calls == [True, True] * decoder.cfg.num_hidden_layers and torch.isfinite(out).all()
