"""The port's spans and counters (``utils/profiling.py``) on the CPU, on
the tiny composite: the span tree of one ``tts`` call and what its units
add up to, the off path (nothing recorded, nothing entered, the same
waveform), the stream's spans, the counters of the eager and the captured
route, the batching engine's queue and batch spans and waits, the Chrome
trace, and the tracer itself (threads, a profiler turning it on, sums,
the bounded buffer, counters)."""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core import graphs as pgraphs
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.generation import streaming as pstreaming
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.serving import BatchingEngine
from parler_tts_tpu_torch.utils import profiling
from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer
from tests.test_torch_blocks import tiny_config
from tests.test_torch_serving import _FakePipeline

torch.set_num_threads(1)  # tier-1 runs several pytest workers

SPECIALS = dict(decoder_start_token_id=33, pad_token_id=32, bos_token_id=33, eos_token_id=32)
MAX_LENGTH = 300  # 299 decoded positions: five segments over two KV-read buckets
TTS_CHILDREN = {"tts.tokenize", "generate.prefill", "generate.segment", "generate.finalize", "codec.decode",
                "tts.to_host"}


@pytest.fixture(scope="module")
def pipe():
    """The tiny composite with its special ids' LM-head columns zeroed, so
    that every sample decodes to ``max_length``, and positions enough for
    two KV-read buckets."""
    cfg = tiny_config(pcfg)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, max_position_embeddings=512))
    model = pparler.init(3, cfg, device="cpu")
    with torch.no_grad():
        model.decoder.lm_heads.kernel[..., 32:] = 0.0
    gen = pcfg.GenerationConfig(max_length=MAX_LENGTH, do_sample=True, top_k=10, **SPECIALS)
    tok = ToyTokenizer(vocab_size=150)
    return ParlerTTSPipeline(model, cfg, gen, tok, tok, dtype=torch.float32, device="cpu")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.stop()
    profiling.reset()


def call(pipe, rows: int = 2):
    return pipe.tts([f"a clear voice {i}" for i in range(rows)], [f"hello there {i}" for i in range(rows)], seed=4)


def test_a_tts_call_is_one_span_tree(pipe):
    """One root, the layers' spans under it, one call id; the segments'
    units are the positions decoded, the codec's the audio seconds it
    returned."""
    with profiling.tracing():
        sr, waves = call(pipe, rows=3)
    spans = profiling.records()
    root, = [s for s in spans if s["parent"] is None]
    assert root["name"] == "tts" and root["attrs"] == {"rows": 3, "max_seconds": None}
    assert {s["call"] for s in spans} == {root["id"]}
    assert {s["name"] for s in spans if s["parent"] == root["id"]} == TTS_CHILDREN
    assert [s["name"] for s in spans if s["parent"] == root["id"]][0] == "tts.tokenize"
    segments = [s for s in spans if s["name"] == "generate.segment"]
    assert len(segments) == 5 and sum(s["attrs"]["units"] for s in segments) == MAX_LENGTH - 1
    assert all(s["attrs"]["steps"] == s["attrs"]["units"] for s in segments)
    assert len({s["attrs"]["bucket"] for s in segments}) == 2
    audio_s = sum(s["attrs"]["units"] for s in spans if s["name"] == "codec.decode")
    frames = MAX_LENGTH - pipe.cfg.decoder.num_codebooks  # the BOS column and the delay pattern's tail go
    assert audio_s == pytest.approx(3 * frames * pipe.cfg.audio_encoder.hop_length / sr)  # before the trim
    assert 0 < sum(w.shape[0] for w in waves) / sr <= audio_s
    prefill, = [s for s in spans if s["name"] == "generate.prefill"]
    assert prefill["attrs"] == {"route": "eager", "kv_bytes": prefill["attrs"]["kv_bytes"], "conv_bytes": 0,
                                "ssm_bytes": 0}
    assert prefill["attrs"]["kv_bytes"] > 0
    for s in spans:  # children end inside their parents; no device events on the CPU
        parent = next((p for p in spans if p["id"] == s["parent"]), None)
        assert parent is None or parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
        assert s["device_s"] is None
    summary = profiling.summary()
    assert summary["generate.segment"]["count"] == 5 and summary["generate.segment"]["units"] == MAX_LENGTH - 1
    assert summary["tts"]["host_s"] > 0 and summary["tts"]["device_s"] == 0.0


def test_tracing_off_records_nothing_and_the_waveform_stays(pipe, monkeypatch):
    """Off, a call makes no span record, enters no ``record_function`` and
    makes no CUDA event; on, its waveform is the same bit for bit."""
    with profiling.tracing():
        _, traced = call(pipe)
    profiling.reset()

    def refuse(*args, **kwargs):
        raise AssertionError("tracing off touched the tracer")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(profiling.Span, "__init__", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    _, plain = call(pipe)
    assert profiling.records() == [] and profiling.summary() == {}
    for a, b in zip(traced, plain, strict=True):
        np.testing.assert_array_equal(a, b)


def test_the_stream_gets_the_same_spans(pipe):
    """``stream_generate`` runs ``generate``'s prefill and segment loop and
    the codec's decode: the same spans, with no code of its own."""
    ids = pipe.tokenize(["a clear voice"], ["hello there"])
    with profiling.tracing():
        chunks = list(pstreaming.stream_generate(pipe.model, pipe.gen, chunk_frames=40, device="cpu", **ids,
                                                 generator=torch.Generator().manual_seed(1)))
    names = collections.Counter(s["name"] for s in profiling.records())
    assert names["generate.prefill"] == 1 and names["codec.decode"] == len(chunks) > 1
    assert names["generate.segment"] >= len(chunks)
    assert profiling.summary()["generate.segment"]["units"] == MAX_LENGTH - 1


def counter(name: str) -> float:
    return profiling.counters().get(name, 0)


def test_the_eager_route_counts_its_positions(pipe):
    """``decode.positions`` counts the positions the eager loop advances;
    nothing is replayed or captured, traced or not."""
    before = {name: counter(name) for name in ("decode.positions", "decode.replays", "decode.captures")}
    ids = {k: torch.as_tensor(v) for k, v in pipe.tokenize(["a voice", "another"], ["hi", "hello you"]).items()}
    _, t = pgenerate.generate_tokens(pipe.model, pipe.gen, max_length=60, generator=torch.Generator().manual_seed(2),
                                     **ids)
    assert counter("decode.positions") - before["decode.positions"] == t - 1 == 59
    assert counter("decode.replays") == before["decode.replays"]
    assert counter("decode.captures") == before["decode.captures"]


class _Graph:
    def __init__(self, fn):
        self.replay = fn


def _fake_captures(monkeypatch, *, budget: float) -> None:
    """The captured route on the CPU: a capture runs its function once (the
    warm-up), a replay runs it again; ``budget`` bytes per owner."""
    monkeypatch.setattr(pgraphs, "record", lambda fn, pool, generators=(): (fn(), (_Graph(fn), 0))[1])
    monkeypatch.setattr(pgraphs, "new_pool", lambda: None)
    monkeypatch.setattr(pgraphs, "budget", lambda device: budget)
    monkeypatch.setattr(pgraphs, "capturable", lambda device, groups=(): True)


def test_the_captured_route_counts_replays_positions_captures_and_drops(pipe, monkeypatch):
    """The captured route with its CUDA calls factored out (a graph is its
    function, run again at each replay): a step graph per bucket captured
    in a ``generate.capture`` span with its signature, steps replayed past
    the last position every stream kept are counted, and a budget too small
    for two signatures drops the older's state."""
    _fake_captures(monkeypatch, budget=1.0)
    ids = {k: torch.as_tensor(v) for k, v in pipe.tokenize(["a voice", "another"], ["hi", "hello you"]).items()}
    names = ("decode.positions", "decode.replays", "decode.captures", "decode.states_dropped", "prefill.captures",
             "prefill.replays")
    before = {name: counter(name) for name in names}
    with profiling.tracing():
        for max_length in (60, 60, 70):
            pgenerate.generate_tokens(pipe.model, pipe.gen, max_length=max_length,
                                      generator=torch.Generator().manual_seed(2), **ids)
    moved = {name: counter(name) - before[name] for name in names}
    captures = [s for s in profiling.records() if s["name"] == "generate.capture"]
    steps = [s for s in captures if s["attrs"]["kind"] == "step"]
    assert moved["decode.captures"] == len(steps) >= 2 and moved["prefill.captures"] == 2
    assert moved["prefill.replays"] == 1 and moved["decode.states_dropped"] == 1
    assert moved["decode.positions"] == 59 + 59 + 69 <= moved["decode.replays"]
    assert steps[0]["attrs"]["rows"] == 2 and steps[0]["attrs"]["max_length"] == 60
    assert all({"seconds", "nbytes", "bucket"} <= set(s["attrs"]) for s in steps)
    routes = [s["attrs"]["route"] for s in profiling.records() if s["name"] == "generate.prefill"]
    assert routes == ["captured", "replayed", "captured"]


def test_batches_trace_each_request_s_queue_wait():
    """Each request gets a ``serve.queue`` span with its id under its batch's
    ``serve.batch``, the parent of the pipeline's call; ``stats()`` sums
    the waits, and a lone request waits at least the batching window."""
    pipe = _FakePipeline()
    real_tts = pipe.tts

    def tts(*args, **kwargs):
        with profiling.span("tts"):
            return real_tts(*args, **kwargs)

    pipe.tts = tts
    eng = BatchingEngine(pipe, max_batch=4, max_wait_ms=60.0, batch_buckets=(1, 4), length_bucket_seconds=(0.5,),
                         fill_wait_ms=0)
    try:
        with profiling.tracing():
            eng.tts("alone", "p", timeout=30)
            lone = eng.stats()
            futs = [eng.submit(f"d{i}", "p") for i in range(3)]
            for f in futs:
                f.result(timeout=30)
        s = eng.stats()
    finally:
        eng.shutdown()
    assert lone["queue_wait_s"] == lone["queue_wait_max_s"] >= 0.06
    assert s["queue_wait_s"] >= s["queue_wait_max_s"] >= lone["queue_wait_max_s"] and s["queue_wait_s"] >= 0
    spans = profiling.records()
    batches = [b for b in spans if b["name"] == "serve.batch"]
    assert [len(b["attrs"]["requests"]) for b in batches] == [1, 3]
    assert [b["attrs"]["padded_rows"] for b in batches] == [0, 1] and batches[1]["attrs"]["bucket_rows"] == 4
    for b in batches:
        queued = [q for q in spans if q["name"] == "serve.queue" and q["parent"] == b["id"]]
        assert sorted(q["attrs"]["request"] for q in queued) == sorted(b["attrs"]["requests"])
        assert all(q["call"] == b["call"] == b["id"] and q["end_ns"] >= q["start_ns"] for q in queued)
        assert [t["name"] for t in spans if t["parent"] == b["id"] and t["name"] != "serve.queue"] == ["tts"]
        assert b["thread"] == "tts-batcher"
    assert counter("serve.queue_wait_max_s") >= 0.06 and counter("serve.queue_wait_s") >= s["queue_wait_s"]


def test_trace_writes_the_program_s_spans(pipe, tmp_path):
    """``trace(logdir)`` turns the spans on while it records: its Chrome
    trace holds their names beside the torch operations."""
    with profiling.trace(str(tmp_path / "logs")):
        call(pipe)
    events = json.loads((tmp_path / "logs" / profiling.TRACE_FILE).read_text())["traceEvents"]
    names = {e["name"] for e in events if "name" in e}
    assert {"tts"} | TTS_CHILDREN <= names and "aten::mm" in names
    assert {s["name"] for s in profiling.records()} == {"tts"} | TTS_CHILDREN


def test_each_thread_has_its_own_tree():
    """Spans nest by thread: a span opened on another thread meanwhile is
    a root of its own call."""
    opened, release = threading.Event(), threading.Event()

    def other():
        with profiling.span("other"):
            opened.set()
            release.wait(timeout=30)
            with profiling.span("other.child"):
                pass

    with profiling.tracing():
        with profiling.span("main") as main:
            t = threading.Thread(target=other)
            t.start()
            assert opened.wait(timeout=30)
            with profiling.span("main.child", units=2.5):
                release.set()
                t.join(timeout=30)
        assert not t.is_alive()
        profiling.add_span("late", 5, 7, why="no span open")
    by = {s["name"]: s for s in profiling.records()}
    assert by["main.child"]["parent"] == main.id and by["other.child"]["parent"] == by["other"]["id"]
    assert by["other"]["parent"] is None and by["other"]["call"] != by["main"]["call"]
    assert by["late"]["parent"] is None and by["late"]["end_ns"] - by["late"]["start_ns"] == 2
    assert profiling.summary()["main.child"]["units"] == 2.5


def test_a_profiler_turns_spans_on_and_off_stops_them():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("profiled"):
            pass
    profiling.start()
    with profiling.span("started"):
        pass
    profiling.stop()
    with profiling.span("stopped"):
        pass
    assert [s["name"] for s in profiling.records()] == ["profiled", "started"]


def test_the_buffer_keeps_the_newest_and_the_sums_keep_everything(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=3))
    with profiling.tracing():
        for i in range(5):
            with profiling.span("s", units=i):
                pass
    assert [s["attrs"]["units"] for s in profiling.records()] == [2, 3, 4]
    assert profiling.summary()["s"]["count"] == 5 and profiling.summary()["s"]["units"] == 10
    profiling.reset()
    assert profiling.records() == [] and profiling.summary() == {}


def test_counters_add_raise_and_snapshot():
    before = counter("test.count")
    profiling.count("test.count")
    profiling.count("test.count", 2.5)
    profiling.count_max("test.max", 3.0)
    profiling.count_max("test.max", 1.0)
    snap = profiling.counters()
    profiling.count("test.count")
    assert snap["test.count"] - before == 3.5 and snap["test.max"] >= 3.0
    assert counter("test.count") - before == 4.5


# --- the LFM2 decoder's state and experts ------------------------------------------------------


@pytest.fixture(scope="module")
def lfm2_model():
    from tests.test_torch_lfm2 import build, tiny

    cfg = tiny()
    return cfg, build(cfg)[0]


def _lfm2_ids(cfg):
    from tests.test_torch_lfm2 import inputs

    di, dm, pi, pm = inputs(cfg)
    return dict(input_ids=di, attention_mask=dm, prompt_input_ids=pi, prompt_attention_mask=pm)


@pytest.mark.parametrize("captured", [False, True])
def test_state_bytes_by_kind_in_spans_and_counters(lfm2_model, captured, monkeypatch):
    """``generate.prefill`` and ``generate.capture`` carry the cache's K/V
    and conv bytes; ``decode.kv_bytes`` and ``decode.conv_state_bytes``
    count what the kept steps read of each (``KVCache.step_bytes`` over
    their bucket), on the eager and the captured route."""
    cfg, model = lfm2_model
    if captured:
        _fake_captures(monkeypatch, budget=1e18)
    gen = pcfg.GenerationConfig(do_sample=False)
    before = {name: counter(name) for name in ("decode.kv_bytes", "decode.conv_state_bytes", "decode.positions")}
    ids = _lfm2_ids(cfg)
    with profiling.tracing():
        _, t = pgenerate.generate_tokens(model, gen, max_length=300, **ids)
    cache = pgenerate.init_cache(cfg.decoder, 3, 16 + 300, ids["input_ids"].shape[1], dtype=torch.float32,
                                 device=torch.device("cpu"))
    kinds = cache.nbytes_by_kind()
    assert kinds["conv"] == 2 * 3 * 2 * 64 * 4 and kinds["kv"] == cache.nbytes - kinds["conv"]
    spans = [s for s in profiling.records() if s["name"] in ("generate.prefill", "generate.capture")]
    assert spans and all((s["attrs"]["kv_bytes"], s["attrs"]["conv_bytes"]) == (kinds["kv"], kinds["conv"])
                         for s in spans)
    assert any(s["name"] == "generate.capture" for s in spans) == captured
    limits = pgenerate._kv_read_limits(16 + 1, 16 + 300, gen.kv_read_buckets, batch_rows=3)
    assert len(limits) > 1
    want = {"kv": 0, "conv": 0}
    for position in range(1, t):  # the step at position p reads the bucket that holds p
        read = cache.step_bytes(next(size for size in limits if size > 16 + position))
        want = {kind: want[kind] + read[kind] for kind in want}
    assert counter("decode.positions") - before["decode.positions"] == t - 1 == 299
    assert counter("decode.kv_bytes") - before["decode.kv_bytes"] == want["kv"]
    assert counter("decode.conv_state_bytes") - before["decode.conv_state_bytes"] == want["conv"] == 299 * kinds["conv"]


def test_moe_counters_count_on_the_device_through_replays(lfm2_model, monkeypatch):
    """``moe.assignments`` counts every routed (token, expert) pair of a
    call, its prefill's and each replayed step's, accumulated on the device
    and read once after the call; ``moe.experts_touched`` the experts given
    a token, summed over MoE calls; ``moe.dropped`` stays 0, and a dropped
    pair raises."""
    cfg, model = lfm2_model
    _fake_captures(monkeypatch, budget=1e18)
    names = ("moe.assignments", "moe.experts_touched", "moe.dropped", "decode.replays")
    before = {name: counter(name) for name in names}
    reads = []
    real = torch.Tensor.tolist

    def tolist(x):
        if x is model.decoder.moe_stats:
            reads.append(1)
        return real(x)

    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    pgenerate.generate_tokens(model, pcfg.GenerationConfig(do_sample=False), max_length=40, **_lfm2_ids(cfg))
    moved = {name: counter(name) - before[name] for name in names}
    moe_layers, k, rows, fused = 3, 2, 3, 16 + 1
    assert reads == [1]
    assert moved["moe.assignments"] == moe_layers * k * rows * (fused + moved["decode.replays"])
    assert moe_layers * (1 + moved["decode.replays"]) <= moved["moe.experts_touched"]
    assert moved["moe.experts_touched"] <= moe_layers * 8 * (1 + moved["decode.replays"])
    assert moved["moe.dropped"] == 0

    class Dropping:
        moe_stats = torch.tensor([8, 2, 1])

    with pytest.raises(RuntimeError, match="dropped 1"):
        pgenerate._count_experts(Dropping())
