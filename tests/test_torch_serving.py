"""The port's batching engine: the deterministic policy tests of
``tests/test_serving.py`` over a fake pipeline (deferred fill, the solo
exemption), its static batch-assembly functions against the JAX engine's,
and the engine over the port's real CPU pipeline (tiny model, toy
tokenizer): coalescing, length buckets, warmup, shutdown, errors, pad
accounting, and each result equal to a direct ``tts`` call on the padded
rows with the folded seed (bit for bit, on one device)."""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.serving import batcher as jbatcher
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.serving import BatchingEngine
from parler_tts_tpu_torch.serving import batcher as pbatcher
from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer
from tests.test_torch_blocks import jax_params, port_model, tiny_config
from tests.test_torch_generate import SPECIALS

torch.set_num_threads(1)  # tier-1 runs several pytest workers


class _FakePipeline:
    """Returns a 4-sample wave per row and records the rows of each call;
    ``fail`` makes a call whose descriptions hold it raise."""

    class _Cfg:
        frame_rate = 100

    class _Gen:
        max_length = 100

    cfg, gen = _Cfg(), _Gen()

    def __init__(self, fail: str | None = None):
        self.batches, self.fail = [], fail

    def tts(self, descs, prompts, *, seed=0, max_seconds=None):
        self.batches.append(len(descs))
        if self.fail in descs:
            raise RuntimeError(f"cannot say {self.fail}")
        return 16000, [np.full(4, i, np.float32) for i in range(len(descs))]


def test_deferred_fill_waits_for_stragglers():
    """A group that would fill its bucket poorly waits once more (fill_wait_ms)
    and takes the requests that arrive meanwhile."""
    pipe = _FakePipeline()
    eng = BatchingEngine(pipe, max_batch=16, max_wait_ms=100.0, batch_buckets=(1, 2, 16),
                         length_bucket_seconds=(0.5,), fill_wait_ms=2000.0, fill_threshold=0.6)
    try:
        futs = [eng.submit("d", "p"), eng.submit("d", "p"), eng.submit("d", "p")]

        def late():
            time.sleep(0.4)  # > max_wait_ms, << fill_wait_ms
            futs.extend([eng.submit("d", "p"), eng.submit("d", "p")])

        t = threading.Thread(target=late)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        for f in list(futs):
            f.result(timeout=30)
        s = eng.stats()
        assert s["batches"] == 1 and s["batched_requests"] == 5, (s, pipe.batches)
        assert s["bucket_rows"] == 16 and s["padded_rows"] == 11 and pipe.batches == [16]
    finally:
        eng.shutdown()


def test_deferred_fill_skips_solo_requests():
    pipe = _FakePipeline()
    eng = BatchingEngine(pipe, max_batch=8, max_wait_ms=30.0, batch_buckets=(4, 8), length_bucket_seconds=(0.5,),
                         fill_wait_ms=5000.0, fill_threshold=0.6)
    try:
        t0 = time.monotonic()
        eng.tts("d", "p", timeout=30)
        assert time.monotonic() - t0 < 2.0, "a solo request waited the fill window"
        assert pipe.batches == [4] and eng.stats()["batched_requests"] == 1
    finally:
        eng.shutdown()


def test_an_error_reaches_every_future_of_its_batch():
    pipe = _FakePipeline(fail="bad")
    eng = BatchingEngine(pipe, max_batch=8, max_wait_ms=200.0, batch_buckets=(1, 2, 4, 8),
                         length_bucket_seconds=(0.5,), fill_wait_ms=0)
    try:
        futs = [eng.submit(d, "p") for d in ("ok", "bad", "ok too")]
        for f in futs:
            with pytest.raises(RuntimeError, match="cannot say bad"):
                f.result(timeout=30)
        sr, wav = eng.tts("fine", "p", timeout=30)  # the worker goes on serving
        assert sr == 16000 and wav.shape == (4,)
    finally:
        eng.shutdown()


def test_batch_assembly_functions_equal_jax():
    buckets = (1, 2, 4, 8, 16)
    for n in range(1, 20):
        assert pbatcher._batch_bucket(n, buckets) == jbatcher._batch_bucket(n, buckets)
    for n, bucket in ((1, 1), (1, 4), (3, 4), (5, 8)):
        rows = [f"r{i}" for i in range(n)]
        assert BatchingEngine.pad_rows(rows, bucket) == jbatcher.BatchingEngine.pad_rows(rows, bucket)
    for seeds in ([], [0], [7], [1, 2, 3], [2**31 - 1, 5, 123456789], list(range(40))):
        assert BatchingEngine.fold_seeds(seeds) == jbatcher.BatchingEngine.fold_seeds(seeds)
    pipe = _FakePipeline()
    engines = [cls(pipe, length_bucket_seconds=(0.3, 0.5, 2.0)) for cls in (BatchingEngine,
                                                                             jbatcher.BatchingEngine)]
    try:
        for max_seconds in (None, 0.01, 0.3, 0.31, 0.5, 0.9, 1.0, 2.0, 5.0):
            want = [e._length_bucket(pbatcher._Request("d", "p", max_seconds, 0, Future())) for e in engines]
            assert want[0] == want[1], (max_seconds, want)
    finally:
        for e in engines:
            e.shutdown()


@pytest.fixture(scope="module")
def pipeline():
    params = jax_params(tiny_config(jcfg), seed=1)
    heads = np.array(params["decoder"]["lm_heads"]["kernel"])
    heads[..., 32:] = 0.0  # special ids' columns zeroed: samples run past their first frames
    params["decoder"] = {**params["decoder"], "lm_heads": {"kernel": heads}}
    gen = pcfg.GenerationConfig(max_length=20, do_sample=True, top_k=10, **SPECIALS)
    tok = ToyTokenizer(vocab_size=150)
    return ParlerTTSPipeline(port_model(params), tiny_config(pcfg), gen, tok, tok, dtype=torch.float32,
                             device="cpu")


class _Spy:
    """Records each ``tts`` call the engine makes: (descriptions, prompts,
    seed, max_seconds, output)."""

    def __init__(self, pipe):
        self.pipe, self.cfg, self.gen, self.calls = pipe, pipe.cfg, pipe.gen, []

    def tts(self, descs, prompts, *, seed=0, max_seconds=None):
        out = self.pipe.tts(descs, prompts, seed=seed, max_seconds=max_seconds)
        self.calls.append((list(descs), list(prompts), seed, max_seconds, out))
        return out


def _engine(spy, **kw):
    return BatchingEngine(spy, **{**dict(max_batch=8, max_wait_ms=150.0, batch_buckets=(1, 2, 4, 8),
                                         length_bucket_seconds=(0.005, 0.01)), **kw})


def test_requests_coalesce_and_equal_a_direct_call(pipeline):
    """A burst of 3 rides one call padded to 4; each result equals a direct
    ``tts`` on the padded rows with ``fold_seeds`` of the requests' seeds,
    and the pad row is counted."""
    spy = _Spy(pipeline)
    eng = _engine(spy)
    try:
        descs = [f"a female speaker voice {i}" for i in range(3)]
        futs = [eng.submit(d, "hey how are you", seed=10 + i) for i, d in enumerate(descs)]
        results = [f.result(timeout=300) for f in futs]
        s = eng.stats()
        counts = {k: v for k, v in s.items() if not k.startswith("queue_wait")}
        assert counts == {"requests": 3, "batches": 1, "batched_requests": 3, "bucket_rows": 4, "padded_rows": 1}
        assert 0 <= s["queue_wait_max_s"] <= s["queue_wait_s"] <= 3 * s["queue_wait_max_s"]
        assert set(s) - set(counts) == {"queue_wait_s", "queue_wait_max_s"}
        (call_descs, call_prompts, seed, max_seconds, _), = spy.calls
        assert call_descs == BatchingEngine.pad_rows(descs, 4) and max_seconds == 0.01
        assert seed == BatchingEngine.fold_seeds([10, 11, 12])
        sr, direct = pipeline.tts(call_descs, call_prompts, seed=seed, max_seconds=max_seconds)
        for (rsr, wav), ref in zip(results, direct):
            assert rsr == sr == 16000 and wav.ndim == 1 and wav.size > 0
            np.testing.assert_array_equal(wav, ref)  # one device, the same rows and seed: bit for bit
    finally:
        eng.shutdown()


def test_length_buckets_do_not_mix(pipeline):
    spy = _Spy(pipeline)
    eng = _engine(spy)
    try:
        short = eng.submit("clear audio", "hey", max_seconds=0.004)
        long = eng.submit("clear audio", "hey", max_seconds=0.01)
        short.result(300), long.result(300)
        assert sorted(c[3] for c in spy.calls) == [0.005, 0.01]
        assert eng.stats()["batches"] == 2
    finally:
        eng.shutdown()


def test_warmup_covers_every_bucket(pipeline):
    spy = _Spy(pipeline)
    eng = _engine(spy)
    try:
        timings = eng.warmup(description="clear audio", prompt="hey how are you", timeout=600)
        assert set(timings) == {f"{b}x{s:g}" for b in (1, 2, 4, 8) for s in (0.005, 0.01)}
        assert sorted((len(c[0]), c[3]) for c in spy.calls) == sorted(
            (b, s) for b in (1, 2, 4, 8) for s in (0.005, 0.01))
        with pytest.raises(ValueError, match="not servable"):
            eng.warmup(batch_buckets=(3,))
    finally:
        eng.shutdown()


def test_shutdown_serves_the_queue_then_refuses(pipeline):
    """Requests queued before ``shutdown`` are served; ``submit`` and
    ``warmup`` raise after it."""
    eng = _engine(_Spy(pipeline), max_wait_ms=5.0)
    futs = [eng.submit("clear audio", "hey", seed=i) for i in range(3)]
    eng.shutdown()
    assert not eng._worker.is_alive()
    for f in futs:
        sr, wav = f.result(timeout=1)
        assert sr == 16000 and wav.ndim == 1
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit("x", "y")
    with pytest.raises(RuntimeError, match="shut down"):
        eng.warmup()


def test_a_request_behind_the_stop_fails_instead_of_hanging():
    """A request that passed ``submit``'s check while ``shutdown`` ran lands
    behind the stop in the queue: the worker fails it on its way out."""
    entered, release = threading.Event(), threading.Event()

    class Blocking(_FakePipeline):
        def tts(self, descs, prompts, *, seed=0, max_seconds=None):
            entered.set()
            release.wait(timeout=30)
            return super().tts(descs, prompts, seed=seed, max_seconds=max_seconds)

    eng = BatchingEngine(Blocking(), max_wait_ms=5.0, length_bucket_seconds=(0.5,))
    first = eng.submit("d", "p")
    assert entered.wait(timeout=30)  # the worker is inside the first batch
    raced: Future = Future()
    eng._shutdown = True
    eng._queue.put(None)
    eng._queue.put(pbatcher._Request("late", "p", None, 0, raced))
    release.set()
    eng._worker.join(timeout=30)
    assert not eng._worker.is_alive()
    assert first.result(timeout=1)[1].shape == (4,)
    with pytest.raises(RuntimeError, match="shut down"):
        raced.result(timeout=1)
