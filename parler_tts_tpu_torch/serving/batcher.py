"""Dynamic micro-batching of TTS requests.

Port of ``parler_tts_tpu/serving/batcher.py``.  ``BatchingEngine`` wraps a
``ParlerTTSPipeline`` with a request queue and one worker thread, which owns
the card: every device call of the engine runs on it.

* ``submit()`` returns a ``concurrent.futures.Future`` at once; ``tts()``
  waits for it.
* The worker takes the oldest request, then drains compatible requests for
  up to ``max_wait_ms`` (the batching window) or until ``max_batch``.
* Compatible means the same generation-length bucket: a 3 s request never
  pays for a 30 s decode.  Within a bucket, each sample's own EOS trims it.
* A group that would fill less than ``fill_threshold`` of its batch bucket
  waits once more, up to ``fill_wait_ms``, for stragglers (not a group of
  one, which would pay the wait with nothing to gain).
* The batch is padded up to a batch-size bucket by repeating the first
  request (``pad_rows``); the pad rows' outputs are dropped and counted in
  ``stats()`` (``bucket_rows``, ``padded_rows``).  One seed per batch,
  ``fold_seeds`` of the requests', seeds the pipeline's ``torch.Generator``.
* An exception in a batch is set on every future of that batch.

A pipeline whose model is split over a model group (``parallel/mesh.
shard_params``) runs every batch on every model rank at once, since the
collectives sit inside ``tts``.  Batches form by timing, so only one rank
can form them: rank 0 of the group owns the queue and, before it runs a
batch, broadcasts it (``broadcast_object_list``: the descriptions and
prompts padded to the batch bucket, ``max_seconds`` and the folded seed).  Every other rank
builds its engine too and calls ``follow()``, which runs the same batches in
the same order and returns at the sentinel that ``shutdown`` broadcasts.
``warmup`` goes through the queue and so through the broadcast.  A failure
propagates: on rank 0 to the batch's futures, on a follower out of
``follow()``; a rank left waiting in a collective fails at the group's
timeout.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch
import torch.distributed as tdist


@dataclasses.dataclass
class _Request:
    description: str
    prompt: str
    max_seconds: float | None
    seed: int
    future: Future
    # warmup only: pad the batch up to at least this bucket, so that the
    # request runs a chosen (batch, length) shape
    force_bucket: int | None = None


def _batch_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class BatchingEngine:
    """Coalesces concurrent TTS requests into batched ``pipeline.tts`` calls.

    Args:
      pipeline: a ``ParlerTTSPipeline`` (or an object with its ``tts``,
        ``cfg.frame_rate`` and ``gen.max_length``).
      max_batch: most requests per device call.
      max_wait_ms: batching window after the first request is taken.
      batch_buckets: the batch sizes a call may have.
      length_bucket_seconds: requested durations round up to one of these,
        and only requests of one bucket share a call.
      fill_wait_ms, fill_threshold: the deferred fill (module docstring);
        ``fill_wait_ms=0`` turns it off.

    Over a model group (module docstring) rank 0 takes requests and every
    other rank calls ``follow()``.
    """

    def __init__(self, pipeline, *, max_batch: int = 64, max_wait_ms: float = 30.0,
                 batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
                 length_bucket_seconds: tuple[float, ...] = (5.0, 10.0, 30.0),
                 fill_wait_ms: float = 150.0, fill_threshold: float = 0.6):
        model = getattr(pipeline, "model", None)
        self.group = getattr(getattr(model, "decoder", None), "model_group", None)
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.length_bucket_seconds = tuple(sorted(length_bucket_seconds))
        self.fill_wait_ms = fill_wait_ms
        self.fill_threshold = fill_threshold
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._pending: list[_Request] = []  # drained, but of another length bucket
        self._stats = {"requests": 0, "batches": 0, "batched_requests": 0, "bucket_rows": 0, "padded_rows": 0}
        self._lock = threading.Lock()
        self._shutdown = False
        self._worker = None
        if self.following:
            return
        # the worker thread drives the card this thread drives (the CUDA device is per thread)
        cuda = torch.cuda.current_device() if torch.cuda.is_available() and torch.cuda.is_initialized() else None
        self._worker = threading.Thread(target=self._run, args=(cuda,), name="tts-batcher", daemon=True)
        self._worker.start()

    @property
    def following(self) -> bool:
        """This rank runs the batches rank 0 of its model group forms."""
        return self.group is not None and self.group.index != 0

    # -- public API ---------------------------------------------------------

    def submit(self, description: str, prompt: str, *, max_seconds: float | None = None,
               seed: int = 0) -> Future:
        """Enqueue one request; resolves to (sampling_rate, waveform)."""
        self._refuse_on_follower()
        if self._shutdown:
            raise RuntimeError("engine is shut down")
        fut: Future = Future()
        self._queue.put(_Request(description, prompt, max_seconds, seed, fut))
        with self._lock:
            self._stats["requests"] += 1
        return fut

    def tts(self, description: str, prompt: str, *, max_seconds: float | None = None,
            seed: int = 0, timeout: float | None = None):
        return self.submit(description, prompt, max_seconds=max_seconds, seed=seed).result(timeout)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def warmup(self, *, description: str = "A calm, clear female voice with no background noise.",
               prompt: str = "Warming up the server.", batch_buckets: tuple[int, ...] | None = None,
               length_bucket_seconds: tuple[float, ...] | None = None,
               timeout: float | None = None) -> dict:
        """Run one batch of every (batch, length) bucket before traffic, so
        that the first request of a shape does not pay for the kernels'
        build, cuDNN's choice of algorithms or the allocator's first blocks.

        Goes through the worker like any request, each synthetic request
        padded to exactly its target bucket (``force_bucket``).  The
        pipeline also buckets the tokenized text lengths; warmup runs the
        buckets of the ``description`` and ``prompt`` given.  Returns
        ``{"BxS": wall_seconds}`` per bucket."""
        self._refuse_on_follower()
        if self._shutdown:  # a request behind the shutdown sentinel would never resolve
            raise RuntimeError("engine is shut down")
        warm_buckets = batch_buckets or self.batch_buckets
        for b in warm_buckets:
            if b not in self.batch_buckets or b > self.max_batch:
                raise ValueError(f"warmup bucket {b} not servable: batch_buckets={self.batch_buckets} "
                                 f"max_batch={self.max_batch}")
        timings: dict[str, float] = {}
        for sec in length_bucket_seconds or self.length_bucket_seconds:
            for b in warm_buckets:
                fut: Future = Future()
                t0 = time.monotonic()
                self._queue.put(_Request(description, prompt, sec, 0, fut, force_bucket=b))
                fut.result(timeout)
                timings[f"{b}x{sec:g}"] = round(time.monotonic() - t0, 3)
        return timings

    def shutdown(self, wait: bool = True) -> None:
        """Stop taking requests: those already queued are still served,
        ``submit`` raises from now on, and a request that raced in behind
        the stop fails with RuntimeError instead of waiting forever."""
        self._shutdown = True
        if self._worker is None:
            return
        self._queue.put(None)
        if wait:
            self._worker.join(timeout=30)

    def follow(self) -> dict:
        """On a model rank other than 0: run each batch rank 0 broadcasts,
        until its ``shutdown``; returns ``stats()``.  Blocks; an error in a
        batch raises out of it."""
        if not self.following:
            raise RuntimeError("follow() is for the model ranks other than 0; rank 0 takes the requests")
        while (batch := self._broadcast(None)) is not None:
            self._run_batch(batch)
        return self.stats()

    def _refuse_on_follower(self) -> None:
        if self.following:
            raise RuntimeError(f"model rank {self.group.index} follows rank 0, which takes the requests: "
                               "call follow() here")

    def _broadcast(self, batch: dict | None) -> dict | None:
        """Rank 0's ``batch`` on every rank of the model group (None: the
        shutdown sentinel); ``batch`` as it is without a group."""
        if self.group is None:
            return batch
        box = [batch]
        tdist.broadcast_object_list(box, src=tdist.get_global_rank(self.group.group, 0), group=self.group.group)
        return box[0]

    # -- worker -------------------------------------------------------------

    def _length_bucket(self, r: _Request) -> float:
        gen_max_s = self.pipeline.gen.max_length / self.pipeline.cfg.frame_rate
        want = r.max_seconds if r.max_seconds is not None else gen_max_s
        for s in self.length_bucket_seconds:
            if want <= s:
                return min(s, gen_max_s)
        return gen_max_s

    def _take_batch(self) -> list[_Request] | None:
        """The oldest request and compatible followers within the window."""
        while True:
            if self._pending:
                first = self._pending.pop(0)
            else:
                item = self._queue.get()
                if item is None:
                    return None
                first = item
            bucket = self._length_bucket(first)
            group = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            fill_extended = False
            leftovers: list[_Request] = []
            while len(group) < self.max_batch:
                taken = [r for r in self._pending if self._length_bucket(r) == bucket]
                for r in taken[: self.max_batch - len(group)]:
                    self._pending.remove(r)
                    group.append(r)
                if len(group) >= self.max_batch:
                    break
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    if not fill_extended and self.fill_wait_ms > 0:
                        bsz = _batch_bucket(len(group), self.batch_buckets)
                        if self.batch_buckets[0] < len(group) < self.fill_threshold * bsz:
                            fill_extended = True
                            deadline = time.monotonic() + self.fill_wait_ms / 1e3
                            continue
                    break
                try:
                    item = self._queue.get(timeout=timeout)
                except queue.Empty:
                    continue  # the deadline passed: the branch above decides
                if item is None:
                    self._queue.put(None)  # signal the shutdown again for the outer loop
                    break
                if self._length_bucket(item) == bucket:
                    group.append(item)
                else:
                    leftovers.append(item)
            self._pending.extend(leftovers)
            return group

    def _run(self, cuda: int | None) -> None:
        if cuda is not None:
            torch.cuda.set_device(cuda)
        while True:
            group = self._take_batch()
            if group is None:
                # fail what was accepted and never taken, the requests that
                # raced in behind the shutdown sentinel included
                left = self._pending
                while True:
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if item is not None:
                        left.append(item)
                for r in left:
                    r.future.set_exception(RuntimeError("engine shut down"))
                self._broadcast(None)  # the followers return
                return
            try:
                self._execute(group)
            except Exception as e:  # the worker keeps serving; every caller of the batch gets the error
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)

    # -- batch assembly: public, so that a check can replay an engine batch
    # through the pipeline with the same padding and seed -------------------

    @staticmethod
    def pad_rows(rows: list, bucket: int) -> list:
        """``rows`` padded up to ``bucket`` by repeating the first."""
        return rows + [rows[0]] * (bucket - len(rows))

    @staticmethod
    def fold_seeds(seeds) -> int:
        """One seed per batch, folding every request's in, so that distinct
        seeds still give distinct batches."""
        out = 0
        for s in seeds:
            out = (out * 1000003 + s) & 0x7FFFFFFF
        return out

    def _execute(self, group: list[_Request]) -> None:
        n = len(group)
        forced = max((r.force_bucket or 0 for r in group), default=0)
        bucket = max(_batch_bucket(n, self.batch_buckets), forced)
        padded = self.pad_rows(group, bucket)
        batch = {"descriptions": [r.description for r in padded], "prompts": [r.prompt for r in padded],
                 "seed": self.fold_seeds(r.seed for r in group), "max_seconds": self._length_bucket(group[0]),
                 "requests": n, "warmup": forced > 0}
        sr, waves = self._run_batch(self._broadcast(batch))
        for r, wav in zip(group, waves):
            r.future.set_result((sr, np.asarray(wav)))

    def _run_batch(self, batch: dict):
        """One padded batch through the pipeline; counted in ``stats()``."""
        out = self.pipeline.tts(batch["descriptions"], batch["prompts"], seed=batch["seed"],
                                max_seconds=batch["max_seconds"])
        bucket, n = len(batch["descriptions"]), batch["requests"]
        with self._lock:
            if self.following and not batch["warmup"]:  # rank 0 counts them in submit()
                self._stats["requests"] += n
            self._stats["batches"] += 1
            self._stats["batched_requests"] += n
            self._stats["bucket_rows"] += bucket
            self._stats["padded_rows"] += bucket - n
        return out
