"""One process of the port's multi-process CPU tests (``tests/test_torch_parallel.py``).

Each worker joins a gloo group through a ``file://`` store (no TCP port, so
parallel test runs cannot collide), then runs the jobs of a JSON spec in
order, in that one group::

    python tests/torch_multiprocess_worker.py <rank> <world> <store file> <spec.json>

Jobs (``spec["jobs"]``, each a dict with ``kind`` and ``name``):

* ``prepare``: ``prepare_hf`` over a local corpus with a codes cache, this
  process's strided share; which rows it encoded, a second pass (from the
  cache), and ``gather_prepared``;
* ``train``: ``run_training.main(job["argv"], device="cpu")``; each step's
  loss and gradient norm as the step returned them, and this rank's
  trainable parameters and optimizer state at the start of its first and
  of its last step;
* ``split``: the artifact ``job["artifact"]`` split over a model group of
  every process: the T5 encoder's output, one training loss with its
  gradients gathered to full tensors, the gradient norm, and greedy
  ``generate`` tokens, on the inputs in ``job["inputs"]``; then the rest of
  the inference surface over the split model: greedy int8 ``generate``
  (int8 weights and KV cache) with the shapes of its cache, the int8 decode
  view (and, for the row-split kernels, what local scales would give), a
  greedy ``stream_generate``, and a ``BatchingEngine`` whose rank 0 takes a
  warmup and a burst of requests while the other ranks ``follow()``, each
  of its batches replayed as a direct ``tts`` on every rank;
* ``early_stop``: a stream over the split model in which the last rank
  stops early (it marks every stream finished after ``job["stop_after"]``
  decode steps): each rank's error and the seconds until it; the group is
  left broken, so no job may follow.

Writes ``<workdir>/{name}_r{rank}.pt`` per job.  ``spec["timeout"]``, when
given, bounds every collective's wait (seconds).  Imports only the port.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import datetime
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)


def _prepare(job: dict) -> dict:
    from parler_tts_tpu_torch.core import checkpoint as ck
    from parler_tts_tpu_torch.parallel import distributed as dist
    from parler_tts_tpu_torch.training import args as targs
    from parler_tts_tpu_torch.training import data as D
    from parler_tts_tpu_torch.training import run_training

    model, cfg, _ = ck.load_model(job["artifact"], device="cpu")
    encoded: list[int] = []
    real = D.tokenize_audio_batches

    def spy(codec, codec_cfg, arrays, **kw):
        encoded.extend(len(a) for a in arrays)
        return real(codec, codec_cfg, arrays, **kw)

    D.tokenize_audio_batches = spy
    data_args = targs.DataTrainingArguments(**job["data_args"])
    model_args = targs.ModelArguments(model_name_or_path=job["tok"], description_tokenizer_name=job["tok"],
                                      prompt_tokenizer_name=job["tok"])
    pi, pc = dist.process_index(), dist.process_count()

    def prepare():
        return run_training.prepare_hf(data_args, model_args, cfg, model.audio_encoder, split="train",
                                       process_index=pi, process_count=pc)

    samples = prepare()
    first = len(encoded)
    encoded.clear()
    prepare()
    return {"encoded": first, "encoded_rerun": len(encoded), "idx": [int(s["_idx"]) for s in samples],
            "labels_md5": {int(s["_idx"]): hashlib.md5(np.ascontiguousarray(s["labels"]).tobytes()).hexdigest()
                           for s in samples},
            "gathered_idx": [int(s["_idx"]) for s in dist.gather_prepared(samples)]}


def _train(job: dict) -> dict:
    from parler_tts_tpu_torch.core import checkpoint as ck
    from parler_tts_tpu_torch.training import run_training
    from parler_tts_tpu_torch.training import step as tstep

    steps, starts = [], []
    make_step = tstep.make_train_step

    def make_spy(*args, **kwargs):
        inner = make_step(*args, **kwargs)

        def step(state, batch, timings=None):
            starts[1:] = [{"params": {k: v.clone() for k, v in ck.trainable_state_dict(state.model).items()},
                           "opt_state": copy.deepcopy(state.optimizer.state_dict())}]
            metrics = inner(state, batch, timings)
            steps.append({"step": int(metrics["step"]), "loss": float(metrics["loss"]),
                          "grad_norm": float(metrics["grad_norm"]), "rows": int(batch["labels"].shape[0])})
            return metrics
        return step

    tstep.make_train_step = make_spy
    try:
        out = run_training.main(job["argv"], device="cpu")
    finally:
        tstep.make_train_step = make_step
    return {"steps": steps, "done": out["steps"], "first": starts[0], "last": starts[-1]}


def _split(job: dict) -> dict:
    from parler_tts_tpu_torch.core import checkpoint as ck
    from parler_tts_tpu_torch.core.config import GenerationConfig
    from parler_tts_tpu_torch.generation.generate import generate
    from parler_tts_tpu_torch.parallel import distributed as dist
    from parler_tts_tpu_torch.parallel import mesh as pmesh
    from parler_tts_tpu_torch.training import step as tstep

    mesh = pmesh.make_mesh(data=1, model=dist.process_count())
    model, cfg, _ = ck.load_model(job["artifact"], device="cpu", mesh=mesh)
    inputs = {k: torch.from_numpy(v) for k, v in np.load(job["inputs"]).items()}
    with torch.no_grad():
        t5 = model.text_encoder(inputs["input_ids"], inputs["attention_mask"])
    state = tstep.create_state(model, mesh, learning_rate=1e-3, warmup_steps=0)
    batch = {k: inputs[k] for k in tstep.BATCH_KEYS if k in inputs}
    loss, _ = model.train_forward(**batch, dtype=torch.float32)
    grads = torch.autograd.grad(loss, state.optimizer.params)
    names, dims = tstep.trainable_names(model), tstep.trainable_dims(model)
    full = {n: pmesh.gather_tensor(g, d, mesh) for n, g, d in zip(names, grads, dims)}
    gen = GenerationConfig(**job["generation"])
    prompt = {k: inputs[k] for k in ("input_ids", "attention_mask", "prompt_input_ids", "prompt_attention_mask")}
    tokens = generate(model, gen, vocode=False, device="cpu", **prompt).tokens
    return {"t5": t5, "loss": loss.detach(), "grads": full, "grad_norm": state.optimizer.norm(list(grads)),
            "tokens": tokens, "local_heads": model.decoder.num_heads,
            "local_t5_heads": model.text_encoder.layers[0].attn.num_heads,
            **_int8(model, gen, prompt), "stream": _stream(model, gen, prompt, job["chunk_frames"]),
            "engine": _engine(model, cfg, job)}


def _int8(model, gen, prompt: dict) -> dict:
    """Greedy int8 generation (int8 weights and KV cache) over the split
    model and the shapes of its cache; the int8 decode view, and the
    row-split kernels quantized with local scales only."""
    from parler_tts_tpu_torch.generation import generate as G
    from parler_tts_tpu_torch.ops.nn import DenseWeight

    caches, real = [], G.init_cache

    def spy(*args, **kw):
        cache = real(*args, **kw)
        caches.append({name: tuple(t.shape) for name, t in vars(cache).items() if torch.is_tensor(t)})
        caches[-1]["dtypes"] = {name: str(t.dtype) for name, t in vars(cache).items() if torch.is_tensor(t)}
        return cache

    G.init_cache = spy
    try:
        out = G.generate(model, dataclasses.replace(gen, int8_weights=True, kv_cache_dtype="int8"), vocode=False,
                         device="cpu", **prompt)
    finally:
        G.init_cache = real
    view = model.decoder.decode_params(int8=True)
    layers = [{name: (w.kernel, w.scale) for name, w in layer._asdict().items()} for layer in view.layers]
    local = [{name: DenseWeight.of(kernel, True) for name, kernel in (
        ("o", layer.self_attn.o.kernel), ("cross_o", layer.cross_attn.o.kernel), ("fc2", layer.fc2.kernel))}
        for layer in model.decoder.layers]
    return {"int8_tokens": out.tokens, "int8_cache": caches, "int8_view": layers,
            "int8_lm_heads": (view.lm_heads.kernel, view.lm_heads.scale),
            "int8_local_only": [{name: (w.kernel, w.scale) for name, w in layer.items()} for layer in local]}


def _stream(model, gen, prompt: dict, chunk_frames: int) -> list[dict]:
    from parler_tts_tpu_torch.generation.streaming import stream_generate

    return [c._asdict() for c in stream_generate(model, gen, chunk_frames=chunk_frames, lookback=8, device="cpu",
                                                 **prompt)]


def _engine(model, cfg, job: dict) -> dict:
    """The batching engine over the split model: rank 0 takes a warmup and
    ``job["requests"]`` at once, the other ranks follow; every rank records
    the batches it ran and then replays each as a direct ``tts``."""
    from parler_tts_tpu_torch.core.config import GenerationConfig
    from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.serving import BatchingEngine
    from parler_tts_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer.from_pretrained(job["tok"])
    pipe = ParlerTTSPipeline(model, cfg, GenerationConfig(**job["engine_generation"]), tok, tok,
                             dtype=torch.float32, device="cpu")
    calls, direct = [], pipe.tts

    def recorded(descs, prompts, *, seed=0, max_seconds=None):
        out = direct(descs, prompts, seed=seed, max_seconds=max_seconds)
        calls.append({"descs": list(descs), "prompts": list(prompts), "seed": seed, "max_seconds": max_seconds,
                      "waves": out[1]})
        return out

    pipe.tts = recorded
    engine = BatchingEngine(pipe, **job["engine"])
    results = None
    if engine.following:
        stats = engine.follow()
    else:
        try:
            engine.warmup(batch_buckets=(2,), timeout=60)
            futures = [engine.submit(d, p, seed=i, max_seconds=job["engine_seconds"])
                       for i, (d, p) in enumerate(job["requests"])]
            results = [f.result(timeout=60)[1] for f in futures]
        finally:
            engine.shutdown()
        stats = engine.stats()
    replays = [direct(c["descs"], c["prompts"], seed=c["seed"], max_seconds=c["max_seconds"])[1] for c in calls]
    return {"calls": calls, "replays": replays, "results": results, "stats": stats, "following": engine.following}


def _early_stop(job: dict) -> dict:
    from parler_tts_tpu_torch.core import checkpoint as ck
    from parler_tts_tpu_torch.core.config import GenerationConfig
    from parler_tts_tpu_torch.generation import streaming
    from parler_tts_tpu_torch.parallel import distributed as dist
    from parler_tts_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(data=1, model=dist.process_count())
    model, _, _ = ck.load_model(job["artifact"], device="cpu", mesh=mesh)
    inputs = {k: torch.from_numpy(v) for k, v in np.load(job["inputs"]).items()}
    prompt = {k: inputs[k] for k in ("input_ids", "attention_mask", "prompt_input_ids", "prompt_attention_mask")}
    steps, real = [0], streaming.decode_step

    def stop_early(model, gen, s, **kw):
        real(model, gen, s, **kw)
        steps[0] += 1
        if steps[0] >= job["stop_after"]:
            s.finished.fill_(True)

    if mesh.model_index == mesh.model - 1:
        streaming.decode_step = stop_early
    t0 = time.perf_counter()
    try:
        chunks = len(list(streaming.stream_generate(model, GenerationConfig(**job["generation"]),
                                                    chunk_frames=job["chunk_frames"], vocode=False, device="cpu",
                                                    **prompt)))
        return {"error": None, "chunks": chunks, "seconds": time.perf_counter() - t0}
    except Exception as e:  # the result the test reads
        return {"error": f"{type(e).__name__}: {e}", "seconds": time.perf_counter() - t0}


JOBS = {"prepare": _prepare, "train": _train, "split": _split, "early_stop": _early_stop}


def main() -> None:
    rank, world, store, spec_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    from parler_tts_tpu_torch.parallel import distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    timeout = datetime.timedelta(seconds=spec["timeout"]) if "timeout" in spec else None
    dist.initialize("gloo", device="cpu", init_method=f"file://{store}", rank=rank, world_size=world, timeout=timeout)
    for job in spec["jobs"]:
        result = JOBS[job["kind"]](job)
        torch.save(result, os.path.join(spec["workdir"], f"{job['name']}_r{rank}.pt"))
        if job["kind"] == "early_stop":  # its group failed on purpose: nothing more runs over it
            return
        dist.barrier(job["name"])
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
