"""The decode loop's KV-read buckets and STAGE-step segments against JAX's
compiled loop nest (``parler_tts_tpu/generation/generate.py``) on the tiny
composite at fp32, on the CPU, where the port runs the same masked steps
that a CUDA model replays from its graphs: the bucket ladder, greedy and
sampled runs over two and three buckets (the plain and the int8 cache),
every stream finishing in the middle of a segment, the per-step loop that
streaming and split models run, weights changed between two calls, and the
position check."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core.from_jax import load_jax_params
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.models import parler as pparler
from tests.test_torch_blocks import jax_params, tiny_config

torch.set_num_threads(1)  # tier-1 runs several pytest workers

SPECIALS = dict(decoder_start_token_id=33, pad_token_id=32, bos_token_id=33, eos_token_id=32)
MAX_LENGTH = 300  # + the 5 prompt positions: over 256, so the ladder has two or three buckets
EOS = 32


def long_config(mod):
    """The tiny composite with room for 512 fused positions."""
    cfg = tiny_config(mod)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, max_position_embeddings=512))


def port_of(params) -> pparler.ParlerTTSModel:
    model = pparler.init(0, long_config(pcfg), device="cpu")
    load_jax_params(model, params)
    return model


def with_eos_scaled(params, factor: float):
    """``params`` with every codebook's EOS column of the LM heads scaled:
    the streams then sample EOS after a few dozen greedy steps."""
    kernel = np.array(params["decoder"]["lm_heads"]["kernel"])
    kernel[..., EOS] *= factor
    return {**params, "decoder": {**params["decoder"], "lm_heads": {"kernel": kernel}}}


def batch(b: int) -> dict[str, np.ndarray]:
    """Right-padded descriptions, left-padded prompts of 5 positions."""
    rng = np.random.default_rng(12)
    ids = rng.integers(3, 160, (b, 9))
    mask = np.ones((b, 9), np.int32)
    mask[1, 6:] = 0
    pids = rng.integers(3, 160, (b, 5))
    pmask = np.ones((b, 5), np.int32)
    pmask[0, :2] = 0
    return dict(input_ids=ids, attention_mask=mask, prompt_input_ids=pids, prompt_attention_mask=pmask)


def both(params, model, gen_kw: dict, b: int, sampled: bool = False):
    """JAX's ``generate_tokens`` and the port's on the same inputs: (JAX
    tokens, JAX stop, port tokens, port stop)."""
    jgen = jcfg.GenerationConfig(max_length=MAX_LENGTH, **SPECIALS, **gen_kw)
    key = jax.random.PRNGKey(7)
    inputs = batch(b)
    ref, ref_t = jgenerate.generate_tokens(params, long_config(jcfg), jgen, key=key, max_length=MAX_LENGTH,
                                           **{k: jnp.asarray(v) for k, v in inputs.items()})
    noise = None
    if sampled:
        shape = (b, 4, 40)

        def noise(t):  # the noise jax.random.categorical draws at step t
            return torch.from_numpy(np.array(jax.random.gumbel(jax.random.fold_in(key, t), shape, jnp.float32)))

    out, t = pgenerate.generate_tokens(model, pcfg.GenerationConfig.from_dict(jgen.to_dict()),
                                       max_length=MAX_LENGTH, noise=noise,
                                       **{k: torch.from_numpy(v) for k, v in inputs.items()})
    return np.asarray(ref), int(ref_t), out.numpy(), t


@pytest.fixture(scope="module")
def runs_long():
    params = jax_params(tiny_config(jcfg), seed=0)  # greedy runs to max_length
    return params, port_of(params)


LIMIT_ROWS = [  # (min_limit, t_fused_max, max_buckets, batch_rows)
    (30, 920, 8, None), (10, 200, 8, 2), (10, 920, 1, 8), (6, 305, 8, 2), (6, 305, 8, 6), (25, 893, 8, 1),
    (25, 893, 8, 4), (25, 893, 8, 5), (25, 893, 8, 128), (25, 893, 8, None), (257, 2837, 8, 64),
    (2600, 2837, 8, 8), (17, 257, 8, 1), (129, 385, 3, 16), (65, 2645, 12, 8), (300, 512, 0, 8),
]


@pytest.mark.parametrize("row", LIMIT_ROWS, ids=[str(r) for r in LIMIT_ROWS])
def test_kv_read_limits_equal_jax(row, monkeypatch):
    monkeypatch.delenv("PARLER_KV_MIN_STEP", raising=False)  # JAX's trace-time knob, at its default
    assert pgenerate._kv_read_limits(*row) == jgenerate._kv_read_limits(*row)


def test_greedy_over_two_buckets_equals_jax(runs_long):
    """Rows 2: the ladder [256, 305]; the run crosses the transition and
    ends at max_length.  The per-step loop (streaming's and split models')
    gives the same tokens."""
    params, model = runs_long
    assert pgenerate._kv_read_limits(6, 305, 8, batch_rows=2) == [256, 305]
    ref, ref_t, out, t = both(params, model, dict(do_sample=False), 2)
    np.testing.assert_array_equal(ref, out)
    assert t == ref_t == MAX_LENGTH
    s = pgenerate.prefill(model, pcfg.GenerationConfig(max_length=MAX_LENGTH, do_sample=False, **SPECIALS),
                          max_length=MAX_LENGTH, **{k: torch.from_numpy(v) for k, v in batch(2).items()})
    assert s.limits == [256, 305] and s.p_len == 5
    while not s.done:
        pgenerate.decode_step(model, pcfg.GenerationConfig(do_sample=False, **SPECIALS), s)
    np.testing.assert_array_equal(s.tokens.numpy(), out)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "cfg_topk_noise"])
def test_int8_cache_over_three_buckets_equals_jax(runs_long, sampled):
    """Batch 3 with CFG: 6 rows, the ladder [128, 256, 305], over an int8
    cache; greedy, and top-k sampling fed JAX's Gumbel noise."""
    params, model = runs_long
    assert pgenerate._kv_read_limits(6, 305, 8, batch_rows=6) == [128, 256, 305]
    kw = dict(do_sample=sampled, guidance_scale=3.0, kv_cache_dtype="int8")
    if sampled:
        kw.update(top_k=10, temperature=0.9)
    ref, ref_t, out, t = both(params, model, kw, 3, sampled=sampled)
    np.testing.assert_array_equal(ref, out)
    assert t == ref_t


def test_every_stream_finishing_mid_segment_stops_where_jax_does():
    """EOS raised: every stream has finished at a position in the middle of
    the second segment; the loop stops there, with JAX's tokens, and every
    stream finished (JAX's loop stops before max_length only then)."""
    params = with_eos_scaled(jax_params(tiny_config(jcfg), seed=5), 3.0)
    model = port_of(params)
    ref, ref_t, out, t = both(params, model, dict(do_sample=False), 2)
    np.testing.assert_array_equal(ref, out)
    assert t == ref_t
    t0 = 1
    assert t0 + pgenerate.STAGE < t < t0 + 2 * pgenerate.STAGE and t < MAX_LENGTH, t
    gen = pcfg.GenerationConfig(max_length=MAX_LENGTH, do_sample=False, **SPECIALS)
    s = pgenerate.prefill(model, gen, max_length=MAX_LENGTH, **{k: torch.from_numpy(v) for k, v in batch(2).items()})
    stop = pgenerate._decode(s, MAX_LENGTH, pgenerate._eager_segment(model, gen, s, None, None))
    assert stop == t == s.t == int(s.position)
    assert bool(s.finished.all())
    np.testing.assert_array_equal(s.tokens.numpy(), out)


def test_weights_changed_between_two_calls_give_new_tokens():
    """An in-place change of a decode weight between two calls reaches the
    second call's steps (the decode view is rebuilt per call): new tokens,
    JAX's for the changed weights."""
    params = jax_params(tiny_config(jcfg), seed=1)
    model = port_of(params)
    gen = dict(do_sample=False)
    first = both(params, model, gen, 2)[2]
    changed = {**params, "decoder": {**params["decoder"], "lm_heads": {
        "kernel": np.array(params["decoder"]["lm_heads"]["kernel"])[..., ::-1].copy()}}}
    with torch.no_grad():
        model.decoder.lm_heads.kernel.copy_(model.decoder.lm_heads.kernel.flip(-1))
    ref, ref_t, out, t = both(changed, model, gen, 2)
    assert not np.array_equal(first, out)
    np.testing.assert_array_equal(ref, out)
    assert t == ref_t


def test_positions_are_checked_once_before_the_prefill():
    """The tiny composite embeds 256 positions: 5 prompt positions and
    max_length 300 raise before anything runs."""
    model = pparler.init(0, tiny_config(pcfg), device="cpu")
    gen = pcfg.GenerationConfig(max_length=MAX_LENGTH, do_sample=False, **SPECIALS)
    with pytest.raises(ValueError, match="max_position_embeddings=256"):
        pgenerate.generate_tokens(model, gen, max_length=MAX_LENGTH,
                                  **{k: torch.from_numpy(v) for k, v in batch(2).items()})


def test_kv_read_buckets_is_carried_through_artifacts(tmp_path):
    """A JAX generation config's ``kv_read_buckets`` reaches the port's, and
    the port writes the JAX package's file byte for byte."""
    jg = jcfg.GenerationConfig(max_length=300, kv_read_buckets=3)
    jg.save(str(tmp_path / "jax.json"))
    pg = pcfg.GenerationConfig.load(str(tmp_path / "jax.json"))
    assert pg.kv_read_buckets == 3 and pg == pcfg.GenerationConfig(max_length=300, kv_read_buckets=3)
    pg.save(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
