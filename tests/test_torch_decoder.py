"""The port's decoder against the JAX decoder at fp32 on CPU: the prefill
over left-padded prompts (the JAX side takes its flash-attention kernel in
interpret mode, as tests/test_pallas_kernels.py does), then five cached
decode steps."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parler_tts_tpu.ops.pallas.flash_attention as jfa
from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.models import decoder as jdecoder
from parler_tts_tpu.ops import runtime_flags
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.models import decoder as pdecoder
from tests.test_torch_blocks import T, close, jax_params, port_model, tiny_config

torch.set_num_threads(1)  # tier-1 runs several pytest workers

B, P_LEN, S_LEN, STEPS = 2, 6, 7, 5


@pytest.fixture
def jax_flash_interpret(monkeypatch):
    orig = jfa.flash_attention_bhtd
    monkeypatch.setattr(jfa, "flash_attention_bhtd", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    runtime_flags.set_pallas(True)
    yield
    runtime_flags.set_pallas(None)


def _inputs(cfg):
    dcfg = cfg.decoder
    rng = np.random.default_rng(11)
    prompt = rng.standard_normal((B, P_LEN, dcfg.hidden_size)).astype(np.float32)
    p_mask = np.ones((B, P_LEN), np.int32)
    p_mask[0, :3] = 0  # left-padded prompt
    enc = rng.standard_normal((B, S_LEN, dcfg.hidden_size)).astype(np.float32)
    enc_mask = np.ones((B, S_LEN), np.int32)
    enc_mask[1, 5:] = 0  # right-padded description
    start = np.full((B, dcfg.num_codebooks, 1), dcfg.bos_token_id, np.int32)
    steps = rng.integers(0, dcfg.vocab_size, (STEPS, B, dcfg.num_codebooks, 1)).astype(np.int32)
    fused_mask = np.concatenate([p_mask, np.ones((B, 1 + STEPS), np.int32)], axis=1)
    return prompt, enc, enc_mask, start, steps, fused_mask


def test_prefill_and_cached_decode_match_jax(jax_flash_interpret):
    jc, pc = tiny_config(jcfg), tiny_config(pcfg)
    params = jax_params(jc)
    jp, decoder = params["decoder"], port_model(params).decoder
    prompt, enc, enc_mask, start, steps, fused_mask = _inputs(jc)
    kw = dict(prompt_hidden_states=prompt, encoder_hidden_states=enc, encoder_attention_mask=enc_mask,
              attention_mask=fused_mask)
    pkw = {k: T(v) for k, v in kw.items()}

    # full forward: hidden states on the valid rows
    ref_hidden, _ = jdecoder.forward(jp, jc.decoder, start, **kw)
    hidden = decoder(T(start), **pkw)
    valid = fused_mask[:, : P_LEN + 1].astype(bool)
    close(np.asarray(ref_hidden)[valid], hidden.numpy()[valid], 1e-4)

    # prefill into the cache, last-position logits
    cache = jdecoder.init_cache(jc.decoder, B, fused_mask.shape[1], S_LEN)
    ref_hidden, cache = jdecoder.forward(jp, jc.decoder, start, cache=cache, prefill=True, **kw)
    pcache = pdecoder.init_cache(pc.decoder, B, fused_mask.shape[1], S_LEN, dtype=torch.float32,
                                 device=torch.device("cpu"))
    hidden = decoder(T(start), cache=pcache, **pkw)
    assert pcache.index == P_LEN + 1
    close(jdecoder.logits(jp, ref_hidden, num_labels=1), decoder.logits(hidden, num_labels=1), 1e-4)

    view = decoder.decode_params()
    for ids in steps:
        ref_hidden, cache = jdecoder.forward(jp, jc.decoder, ids, cache=cache, encoder_attention_mask=enc_mask,
                                             attention_mask=jnp.asarray(fused_mask))
        hidden = decoder.decode_step(T(ids), pcache, params=view, encoder_attention_mask=T(enc_mask),
                                     attention_mask=T(fused_mask))
        close(jdecoder.logits(jp, ref_hidden), decoder.logits(hidden), 1e-4)
    assert pcache.index == fused_mask.shape[1]


def test_prefill_routes_self_attention_through_flash(monkeypatch):
    """Every layer's prefill self-attention (T > 1) goes to
    ``flash_attention_bhtd``; a one-position sequence does not."""
    params = jax_params(tiny_config(jcfg))
    decoder = port_model(params).decoder
    calls = []
    real = pdecoder.flash_attention_bhtd
    monkeypatch.setattr(pdecoder, "flash_attention_bhtd", lambda *a, **k: calls.append(1) or real(*a, **k))
    prompt, enc, enc_mask, start, _, fused_mask = _inputs(tiny_config(jcfg))
    decoder(T(start), prompt_hidden_states=T(prompt), encoder_hidden_states=T(enc),
            encoder_attention_mask=T(enc_mask), attention_mask=T(fused_mask))
    assert len(calls) == decoder.cfg.num_hidden_layers
    decoder(T(start), encoder_hidden_states=T(enc), encoder_attention_mask=T(enc_mask))
    assert len(calls) == decoder.cfg.num_hidden_layers


def test_sinusoidal_positions_match_jax():
    close(jdecoder.sinusoidal_positions(300, 32), pdecoder.sinusoidal_positions(300, 32), 1e-5)
    ref = jax.vmap(lambda i: jdecoder.sinusoidal_position_at(i, 33))(jnp.arange(40))
    close(ref, pdecoder.sinusoidal_positions(40, 33), 1e-5)
