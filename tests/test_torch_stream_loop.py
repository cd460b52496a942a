"""The stream's chunked segment loop against JAX's ``stream_generate`` on
the tiny composite at fp32, on the CPU: each chunk runs the decode loop's
segments up to the chunk's end (JAX ``run_chunk``), eagerly here, and again
through the captured route with its CUDA calls factored out (a "graph" is
its function, run again at each replay), so that the static state, the
captured prefill and the leases a CUDA model uses are exercised here too.
Codes, valid lengths and chunk boundaries must be JAX's and the audio
(about 0.1 at its peak) within 1e-4 of it.  Also: the leases (a leased
state is never dropped nor handed out twice, a closed or dropped stream
releases its lease, ``generate`` between two chunks on the same thread),
and one decode view built per call."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import streaming as jstreaming
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core import graphs as pgraphs
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.generation import streaming as pstreaming
from parler_tts_tpu_torch.utils import profiling
from tests.test_torch_blocks import jax_params, tiny_config
from tests.test_torch_decode_loop import SPECIALS, batch, long_config, port_of, with_eos_scaled
from tests.test_torch_quantization import gumbel_noise
from tests.test_torch_streaming import CB, K, _scale_kernels

torch.set_num_threads(1)  # tier-1 runs several pytest workers

AUDIO_TOL = 1e-4


def audible(params, *, long_samples: bool):
    """The codec's decode side scaled by 10 (audio about 0.1); with
    ``long_samples`` the special ids' LM-head columns zeroed, so that every
    sample runs to ``max_length``."""
    codec = params["audio_encoder"]
    params = {**params, "audio_encoder": {**codec, "decoder": _scale_kernels(codec["decoder"], 10.0),
                                          "quantizer": {**codec["quantizer"], "out_proj": _scale_kernels(
                                              codec["quantizer"]["out_proj"], 10.0)}}}
    if long_samples:
        heads = np.array(params["decoder"]["lm_heads"]["kernel"])
        heads[..., CB:] = 0.0
        params["decoder"] = {**params["decoder"], "lm_heads": {"kernel": heads}}
    return params


@pytest.fixture(scope="module")
def long_run():
    params = audible(jax_params(tiny_config(jcfg), seed=0), long_samples=True)
    return params, port_of(params)


@pytest.fixture(scope="module")
def eos_run():
    """Every stream finishes in the middle of the decode loop's second
    segment (``test_torch_decode_loop``)."""
    params = audible(with_eos_scaled(jax_params(tiny_config(jcfg), seed=5), 3.0), long_samples=False)
    return params, port_of(params)


class _Graph:
    def __init__(self, fn):
        self.replay = fn


@pytest.fixture
def captured_route(monkeypatch):
    """The captured route on the CPU: recording runs the function once, as
    the warm-up before a capture does (the capture itself runs nothing), and
    a replay runs it again.  Yields a one-element list holding the budget
    in bytes."""
    budget = [float("inf")]

    def record(fn, pool, generators=()):
        fn()
        return _Graph(fn), 0

    monkeypatch.setattr(pgraphs, "record", record)
    monkeypatch.setattr(pgraphs, "new_pool", lambda: None)
    monkeypatch.setattr(pgraphs, "budget", lambda device: budget[0])
    monkeypatch.setattr(pgraphs, "capturable", lambda device, groups=(): all(g is None for g in groups))
    return budget


# (name, fixture, batch, max_length, chunk_frames, audio-prompt frames, generation config)
CASES = [
    ("chunk_8_below_stage_over_two_buckets", "long_run", 2, 300, 8, 0, dict(do_sample=False)),
    ("chunk_86_above_stage_crossing_a_bucket", "long_run", 2, 300, 86, 0, dict(do_sample=False)),
    ("every_stream_finishing_mid_segment", "eos_run", 2, 300, 40, 0, dict(do_sample=False)),
    ("audio_prompted", "long_run", 2, 60, 20, 4, dict(do_sample=False)),
    ("cfg3_topk_noise_over_three_buckets", "long_run", 3, 300, 50, 0,
     dict(do_sample=True, top_k=10, temperature=0.9, guidance_scale=3.0)),
]
_JAX_CHUNKS: dict[str, list] = {}


def _inputs(b: int, frames: int) -> dict[str, np.ndarray]:
    inputs = batch(b)
    if frames:
        inputs["decoder_input_codes"] = np.random.default_rng(3).integers(0, CB, (b, K, frames)).astype(np.int32)
    return inputs


def _jax_chunks(name, params, b, max_length, chunk, frames, kw):
    """JAX's stream of the case, once per module."""
    if name not in _JAX_CHUNKS:
        jgen = jcfg.GenerationConfig(max_length=max_length, **SPECIALS, **kw)
        _JAX_CHUNKS[name] = list(jstreaming.stream_generate(
            params, long_config(jcfg), jgen, key=jax.random.PRNGKey(7), chunk_frames=chunk, lookback=16,
            dtype=np.float32, **_inputs(b, frames)))
    return _JAX_CHUNKS[name]


def _port_stream(model, b, max_length, chunk, frames, kw):
    gen = pcfg.GenerationConfig(max_length=max_length, **SPECIALS, **kw)
    noise = gumbel_noise(jax.random.PRNGKey(7), (b, K, 40)) if gen.do_sample else None
    return pstreaming.stream_generate(model, gen, chunk_frames=chunk, lookback=16, noise=noise, device="cpu",
                                      **_inputs(b, frames))


@pytest.mark.parametrize("route", ["eager", "captured"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stream_loop_matches_jax_stream(request, case, route):
    """Chunk by chunk: the same offsets, stops, codes and valid lengths as
    JAX's stream, the audio within ``AUDIO_TOL``.  The decode loop reads the
    cache over ``generate``'s buckets ([256, 305] at 2 rows, [128, 256, 305]
    at 6), JAX's stream over its own; a chunk of 8 or 86 positions crosses
    the bucket end at position 251."""
    name, fixture, b, max_length, chunk, frames, kw = case
    if route == "captured":
        request.getfixturevalue("captured_route")
    params, model = request.getfixturevalue(fixture)
    ref = _jax_chunks(name, params, b, max_length, chunk, frames, kw)
    chunks = list(_port_stream(model, b, max_length, chunk, frames, kw))
    assert len(chunks) == len(ref) > 2
    assert chunks[-1].finished and not any(c.finished for c in chunks[:-1])
    for r, c in zip(ref, chunks):
        assert (r.frame_offset, r.finished) == (c.frame_offset, c.finished)
        np.testing.assert_array_equal(np.asarray(r.codes), c.codes)
        np.testing.assert_array_equal(np.asarray(r.valid_lengths), c.valid_lengths)
        np.testing.assert_allclose(np.asarray(r.audio), c.audio, atol=AUDIO_TOL, rtol=0)
    frames_out = sum(c.codes.shape[2] for c in chunks)
    if name == "every_stream_finishing_mid_segment":  # its samples end early: no audio to speak of
        stop = frames_out + K  # the stop position: the frames plus the BOS column and the delay tail
        assert pgenerate.STAGE < stop < 2 * pgenerate.STAGE and (stop - 1) % chunk, stop
    else:
        assert frames_out == max_length - K
        assert np.abs(np.concatenate([c.audio for c in chunks], axis=1)).max() > 1e-2
    if frames:
        np.testing.assert_array_equal(np.concatenate([c.codes for c in chunks], axis=2)[:, :, :frames],
                                      _inputs(b, frames)["decoder_input_codes"])


def _leased(model) -> list[tuple]:
    return sorted(pgenerate._programs_of(model).leased)


def test_a_leased_state_is_neither_dropped_nor_handed_out_twice(long_run, captured_route):
    """An open stream leases its signature's state: ``generate`` with the
    same signature between two chunks, on the same thread, runs on a second
    instance (no deadlock: the lock is not held across a ``yield``), and a
    budget of 0 drops every other state but not the leased one.  The
    stream's codes stay the eager stream's; its end releases the lease."""
    _, model = long_run
    kw = dict(do_sample=False)
    ref = np.concatenate([c.codes for c in pstreaming.stream_generate(
        model, pcfg.GenerationConfig(max_length=120, **SPECIALS, **kw), chunk_frames=30, vocode=False,
        device="cpu", **batch(2))], axis=2)
    model.__dict__.pop("_decode_programs", None)
    gen = pcfg.GenerationConfig(max_length=120, **SPECIALS, **kw)
    it = pstreaming.stream_generate(model, gen, chunk_frames=30, vocode=False, device="cpu", **batch(2))
    codes = [next(it).codes]
    programs = pgenerate._programs_of(model)
    (lease,) = _leased(model)
    assert lease[1] == 0
    inputs = {k: torch.from_numpy(v) for k, v in batch(2).items()}
    tokens, _ = pgenerate.generate_tokens(model, gen, max_length=120, **inputs)  # same signature: a second instance
    assert (lease[0], 1) in programs and _leased(model) == [lease]
    codes.append(next(it).codes)
    captured_route[0] = 0  # every state that no stream leases goes
    pgenerate.generate_tokens(model, dataclasses.replace(gen, max_length=100), max_length=100, **inputs)
    assert lease in programs and (lease[0], 1) not in programs and len(programs) == 2
    codes += [c.codes for c in it]
    np.testing.assert_array_equal(np.concatenate(codes, axis=2), ref)
    np.testing.assert_array_equal(pgenerate.undelay_pattern(tokens[:, :, 1:]).numpy()[:, :, :ref.shape[2]], ref)
    assert not _leased(model)


def test_a_closed_or_dropped_stream_releases_its_lease(long_run, captured_route):
    _, model = long_run
    gen = pcfg.GenerationConfig(max_length=120, do_sample=False, **SPECIALS)
    it = pstreaming.stream_generate(model, gen, chunk_frames=30, vocode=False, device="cpu", **batch(2))
    next(it)
    assert _leased(model)
    it.close()
    assert not _leased(model)
    it = pstreaming.stream_generate(model, gen, chunk_frames=30, vocode=False, device="cpu", **batch(2))
    next(it)
    assert _leased(model)
    del it
    assert not _leased(model)


@pytest.mark.parametrize("route", ["eager", "captured"])
def test_one_decode_view_per_call(long_run, request, monkeypatch, route):
    """``decoder.decode_params`` copies every decode weight: it is built
    once per ``generate`` call and once per stream."""
    if route == "captured":
        request.getfixturevalue("captured_route")
    _, model = long_run
    builds, real = [], model.decoder.decode_params
    monkeypatch.setattr(model.decoder, "decode_params", lambda int8=False: builds.append(int8) or real(int8))
    gen = pcfg.GenerationConfig(max_length=40, do_sample=False, int8_weights=True, **SPECIALS)
    for _ in range(2):
        pgenerate.generate(model, gen, vocode=False, device="cpu", **batch(2))
    assert builds == [True, True]
    list(pstreaming.stream_generate(model, gen, chunk_frames=10, vocode=False, device="cpu", **batch(2)))
    assert builds == [True] * 3


def test_a_replayed_prefill_reads_the_new_inputs(long_run, captured_route):
    """Two calls of one signature and input shapes with other values: the
    second replays the prefill on its own inputs (copied into the static
    buffers): the static state after each is the eager prefill's."""
    _, model = long_run
    gen = pcfg.GenerationConfig(max_length=60, do_sample=False, **SPECIALS)
    first = dict({k: torch.from_numpy(v) for k, v in batch(2).items()}, prompt_hidden_states=None,
                 decoder_input_codes=None)
    second = dict(first, input_ids=first["input_ids"].flip(1).contiguous(),
                  prompt_input_ids=(first["prompt_input_ids"] + 7) % 160)
    programs = pgenerate._programs_of(model)
    replays = profiling.counters().get("prefill.replays", 0)
    for inputs in (first, second, first):
        _, captured, _ = pgenerate._captured_generation(model, gen, programs, max_length=60, generator=None,
                                                        noise=None, **inputs)
        s, ref = captured.state, pgenerate.prefill(model, gen, max_length=60, **inputs)
        assert torch.equal(s.logits, ref.logits) and torch.equal(s.tokens, ref.tokens)
        assert torch.equal(s.cache.self_k[:, :, :, :ref.cache.index], ref.cache.self_k[:, :, :, :ref.cache.index])
        assert torch.equal(s.cache.cross_v, ref.cache.cross_v) and s.cache.index == ref.cache.index
    assert profiling.counters()["prefill.replays"] - replays >= 2
    assert not torch.equal(pgenerate.prefill(model, gen, max_length=60, **first).logits,
                           pgenerate.prefill(model, gen, max_length=60, **second).logits)
