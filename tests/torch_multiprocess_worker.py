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
  ``generate`` tokens, on the inputs in ``job["inputs"]``; and whether the
  int8 decode, streaming and the batching engine refuse the split model.

Writes ``<workdir>/{name}_r{rank}.pt`` per job.  Imports only the port.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import sys
import types

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
    from parler_tts_tpu_torch.generation.streaming import stream_generate
    from parler_tts_tpu_torch.parallel import distributed as dist
    from parler_tts_tpu_torch.parallel import mesh as pmesh
    from parler_tts_tpu_torch.serving import BatchingEngine
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
    tokens = generate(model, gen, input_ids=inputs["input_ids"], attention_mask=inputs["attention_mask"],
                      prompt_input_ids=inputs["prompt_input_ids"],
                      prompt_attention_mask=inputs["prompt_attention_mask"], vocode=False, device="cpu").tokens
    prompt = {k: inputs[k] for k in ("input_ids", "attention_mask", "prompt_input_ids", "prompt_attention_mask")}
    refused = {}
    for what, call in (
            ("int8", lambda: generate(model, dataclasses.replace(gen, int8_weights=True), vocode=False, device="cpu",
                                      **prompt)),
            ("stream", lambda: next(stream_generate(model, gen, vocode=False, device="cpu", **prompt))),
            ("engine", lambda: BatchingEngine(types.SimpleNamespace(model=model)))):
        try:
            call()
            refused[what] = False
        except NotImplementedError:
            refused[what] = True
    return {"t5": t5, "loss": loss.detach(), "grads": full, "grad_norm": state.optimizer.norm(list(grads)),
            "tokens": tokens, "local_heads": model.decoder.num_heads, "refused": refused,
            "local_t5_heads": model.text_encoder.layers[0].attn.num_heads}


JOBS = {"prepare": _prepare, "train": _train, "split": _split}


def main() -> None:
    rank, world, store, spec_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    from parler_tts_tpu_torch.parallel import distributed as dist

    dist.initialize("gloo", device="cpu", init_method=f"file://{store}", rank=rank, world_size=world)
    with open(spec_path) as f:
        spec = json.load(f)
    for job in spec["jobs"]:
        result = JOBS[job["kind"]](job)
        torch.save(result, os.path.join(spec["workdir"], f"{job['name']}_r{rank}.pt"))
        dist.barrier(job["name"])
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
