"""The training CLI, on one card or on several processes.

Port of ``parler_tts_tpu/training/run_training.py``::

    python -m parler_tts_tpu_torch.training.run_training recipe.json
    python -m parler_tts_tpu_torch.training.run_training --train_dataset_name synthetic://256 ...
    python -m torch.distributed.run --nproc_per_node=N -m parler_tts_tpu_torch.training.run_training recipe.json

``main(argv, device="cuda")`` runs the JAX ``main``'s stages: arguments (one
JSON recipe or flags, ``training/args.py``); the model (a port artifact
directory, else ``dummy_config()`` for ``"dummy"``, else
``mini_600m_config()``, random weights from ``seed``); data (HF datasets
through ``prepare_hf``, or ``synthetic://N`` samples, with the
``save_to_disk`` cache keyed by a fingerprint of the arguments that change
them); the optimizer with its
``total_steps``; resume from the newest checkpoint (parameters, optimizer
state, the step that seeds dropout, the batch cursor inside the epoch); the
memory plan (``training/autotune.py``); the epoch and step loop, where
saving, evaluating, logging and ``max_steps`` count optimizer steps under
gradient accumulation; the eval loss pass and the eval generation pass
(``generate`` with ``vocode=True``, then WER/CLAP and the logged
predictions); the final artifact under ``output_dir/final``, with the
prompt tokenizer's files.

Several processes (``torch.distributed.run``, one card each) form a
``(data, model)`` mesh with ``model = model_parallel_size``
(``parallel/mesh.py``), as the JAX ``main`` does:

* map-style data: each process prepares its strided share of the raw rows,
  and the shares are gathered, so every process holds the whole set; each
  global batch of ``per_device_train_batch_size x data`` rows comes from one
  shared permutation, and each data rank collates its rows of it;
* streaming data: each process keeps its share (the model ranks of a data
  rank merge theirs), the collator's maxima agree over all processes, and
  the batches per epoch are the least any process has (lockstep);
* the model ranks of a data rank split the weights by the mesh's specs;
  the loss and the update are the global batch's (``training/step.py``);
* eval: each data rank takes its rows of every global eval batch for the
  loss, and its strided share of the split for generation; the metrics are
  weighted means over the processes;
* rank 0 alone logs, writes checkpoints (gathered full tensors) and the
  artifact; the others wait at barriers.  Resume reads the full tensors and
  slices them, whatever the layout that saved them.

``device`` is a keyword for callers (the tests pass ``"cpu"``), not a flag,
so that the argument dataclasses stay the JAX package's; a CUDA process
takes ``cuda:{LOCAL_RANK % device_count}``.  What raises:
``model_parallel_size`` that does not divide the processes, ``push_to_hub``
(the card's machine has no network).  The card's machine has no
``datasets``: there the CLI trains from a ``save_to_disk`` cache prepared
elsewhere (or by ``prepare_rows``) or on ``synthetic://N``.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import json
import math
import os
import sys
import time
from typing import Iterable

import numpy as np
import torch

from parler_tts_tpu_torch.core import checkpoint as ck
from parler_tts_tpu_torch.core.config import GenerationConfig, dummy_config, mini_600m_config
from parler_tts_tpu_torch.generation.generate import generate
from parler_tts_tpu_torch.models import parler
from parler_tts_tpu_torch.parallel import distributed as dist
from parler_tts_tpu_torch.parallel import mesh as pmesh
from parler_tts_tpu_torch.training import data as D
from parler_tts_tpu_torch.training import step as tstep
from parler_tts_tpu_torch.training.args import parse_args
from parler_tts_tpu_torch.training.autotune import resolve_train_plan
from parler_tts_tpu_torch.training.data import Collator, batches, build_labels
from parler_tts_tpu_torch.training.eval_metrics import ClapMetric, WerMetric
from parler_tts_tpu_torch.training.logging_utils import MetricLogger
from parler_tts_tpu_torch.training.optim import map_param_state
from parler_tts_tpu_torch.utils.tokenizer import Tokenizer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def prepare_synthetic(n: int, cfg, *, seed: int = 0, desc_len: int = 24, prompt_len: int = 16,
                      codes_len: int = 64) -> list[dict]:
    """``n`` random samples (description ids, prompt ids, delay-pattern
    labels of ``codes_len // 2`` to ``codes_len`` frames, padded to
    ``codes_len + K + 2``), drawn from ``seed`` in the JAX function's order,
    so both give the same samples."""
    rng = np.random.default_rng(seed)
    dcfg = cfg.decoder
    samples = []
    for i in range(n):
        t = int(rng.integers(codes_len // 2, codes_len + 1))
        codes = rng.integers(0, cfg.audio_encoder.codebook_size, (dcfg.num_codebooks, t)).astype(np.int16)
        labels, _ = build_labels([codes], bos_token_id=dcfg.bos_token_id, eos_token_id=dcfg.eos_token_id,
                                 max_length=codes_len + dcfg.num_codebooks + 2)
        samples.append({
            "input_ids": rng.integers(0, cfg.text_encoder.vocab_size, (int(rng.integers(8, desc_len + 1)),)),
            "prompt_input_ids": rng.integers(0, cfg.vocab_size, (int(rng.integers(6, prompt_len + 1)),)),
            "labels": labels[0],
            "prompt_text": f"synthetic prompt {i}",
            "description_text": f"synthetic description {i}",
        })
    return samples


def prepare_rows(rows: Iterable[dict], data_args, cfg, codec, description_tokenizer, prompt_tokenizer, *,
                 split: str = "train", max_samples: int | None = None, process_index: int = 0,
                 process_count: int = 1) -> list[dict]:
    """The JAX ``prepare_hf``'s row loop over any iterable of row dicts (an
    HF dataset, or rows held in memory): this process's strided share of the
    raw rows (``raw index % process_count == process_index``, taken before
    any work); the duration filter, the description-length filter
    (``max_text_length`` characters) and the token-length filters, all
    before the codec runs; at most ``audio_encoder_batch_size`` waveforms
    held, encoded by ``codec`` on its device (``tokenize_audio_batches``),
    their codes kept in the ``CodesCache`` under ``temporary_save_to_disk``
    (where a re-run reads them back and encodes nothing); then the
    delay-pattern labels.  Each sample carries its raw row index ``_idx``,
    ``prompt_text`` and ``description_text``.  ``max_samples`` bounds the raw
    rows read.  A row whose audio states another sampling rate than the
    codec's raises (the JAX loop would encode it as it is)."""
    sr = cfg.audio_encoder.sampling_rate
    min_len = int(data_args.min_duration_in_seconds * sr)
    max_len = int(data_args.max_duration_in_seconds * sr)
    k = cfg.decoder.num_codebooks
    t_lab = int(data_args.max_duration_in_seconds * cfg.audio_encoder.frame_rate) + k + 2
    cache = None
    if data_args.temporary_save_to_disk:
        cache = D.CodesCache(data_args.temporary_save_to_disk, split=split, process_index=process_index,
                             process_count=process_count)
    samples: list[dict] = []
    pending: list[dict] = []  # rows awaiting the codec ("wav") or their labels ("codes")

    def flush_pending() -> None:
        to_encode = [r for r in pending if "codes" not in r]
        if to_encode:
            codes = D.tokenize_audio_batches(codec, cfg.audio_encoder, [r.pop("wav") for r in to_encode],
                                             batch_size=data_args.audio_encoder_batch_size)
            for r, c in zip(to_encode, codes):
                r["codes"] = c
                if cache is not None:
                    cache.put(r["_idx"], c)
        if cache is not None:
            cache.flush()
        for r in pending:
            codes = r.pop("codes")
            labels, _ = D.build_labels([codes.astype(np.int32)], bos_token_id=cfg.decoder.bos_token_id,
                                       eos_token_id=cfg.decoder.eos_token_id,
                                       max_length=min(t_lab, codes.shape[1] + k + 2))
            r["labels"] = labels[0]
            samples.append(r)
        pending.clear()

    for gi, ex in enumerate(rows):
        if max_samples is not None and gi >= max_samples:
            break
        if gi % process_count != process_index:
            continue
        audio = ex[data_args.target_audio_column_name]
        rate = audio.get("sampling_rate") if hasattr(audio, "get") else None
        if rate is not None and int(rate) != sr:
            raise ValueError(f"row {gi}: audio at {rate} Hz, the codec takes {sr} Hz (cast the audio column)")
        wav = np.asarray(audio["array"], np.float32)
        if not min_len <= len(wav) <= max_len:
            continue
        if len(str(ex[data_args.description_column_name])) > data_args.max_text_length:
            continue
        desc_ids = np.asarray(description_tokenizer(ex[data_args.description_column_name]).input_ids)
        prompt_ids = np.asarray(prompt_tokenizer(ex[data_args.prompt_column_name]).input_ids)
        if data_args.max_description_token_length and len(desc_ids) > data_args.max_description_token_length:
            continue
        if data_args.max_prompt_token_length and len(prompt_ids) > data_args.max_prompt_token_length:
            continue
        r = {"_idx": gi, "input_ids": desc_ids, "prompt_input_ids": prompt_ids,
             "prompt_text": ex.get(data_args.prompt_column_name),
             "description_text": ex.get(data_args.description_column_name)}
        c = cache.get(gi) if cache is not None else None
        if c is not None:
            r["codes"] = c
        else:
            r["wav"] = wav
        pending.append(r)
        if len(pending) >= data_args.audio_encoder_batch_size:
            flush_pending()
    flush_pending()
    return samples


def prepare_hf(data_args, model_args, cfg, codec, *, split: str = "train", max_samples: int | None = None,
               process_index: int = 0, process_count: int = 1) -> list[dict]:
    """HF datasets to prepared samples, as the JAX function prepares them:
    the split's specs merged by ``load_multiple_datasets`` (the eval split
    falls back to the train dataset's names and configs), the description
    and prompt tokenizers read from their directories
    (``utils/tokenizer.Tokenizer``), then ``prepare_rows``.  Streaming needs
    ``max_samples`` to bound the stream."""
    if split == "train":
        specs = D.parse_dataset_spec(data_args.train_dataset_name, data_args.train_dataset_config_name,
                                     data_args.train_split_name, data_args.train_metadata_dataset_name,
                                     data_args.train_dataset_samples)
    else:
        specs = D.parse_dataset_spec(data_args.eval_dataset_name or data_args.train_dataset_name,
                                     data_args.eval_dataset_config_name or data_args.train_dataset_config_name,
                                     data_args.eval_split_name, data_args.eval_metadata_dataset_name)
    if data_args.streaming and max_samples is None:
        raise ValueError("streaming mode needs max_train_samples/max_eval_samples to bound the stream")
    ds = D.load_multiple_datasets(specs, sampling_rate=cfg.audio_encoder.sampling_rate,
                                  streaming=data_args.streaming, stopping_strategy=data_args.stopping_strategy)
    desc_tok = Tokenizer.from_pretrained(model_args.description_tokenizer_name or model_args.model_name_or_path)
    prompt_tok = Tokenizer.from_pretrained(model_args.prompt_tokenizer_name or model_args.model_name_or_path)
    return prepare_rows(ds, data_args, cfg, codec, desc_tok, prompt_tok, split=split, max_samples=max_samples,
                        process_index=process_index, process_count=process_count)


def _prepare_fingerprint(data_args, model_args, cfg) -> str:
    """Hash of every argument that changes the prepared samples (dataset
    specs, columns, filters, tokenizers, length caps, the codec config): the
    JAX function's payload and hash, so both name a cache file alike."""
    data = dataclasses.asdict(data_args)
    for k in ("save_to_disk", "temporary_save_to_disk", "preprocessing_only",
              "preprocessing_num_workers", "audio_encoder_batch_size"):
        data.pop(k, None)
    payload = {
        "data": data,
        "tokenizers": [model_args.description_tokenizer_name, model_args.prompt_tokenizer_name,
                       model_args.model_name_or_path],
        "audio_encoder": dataclasses.asdict(cfg.audio_encoder),
        "num_codebooks": cfg.decoder.num_codebooks,
    }
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def _load_or_prepare(data_args, model_args, cfg, *, split: str, codec=None, max_samples: int | None = None,
                     make=None) -> list[dict]:
    """The prepared samples of ``split``: loaded from
    ``save_to_disk/{split}_prepared_{fingerprint}.npy`` (with a
    ``_h{index}of{count}`` suffix under several processes: the payload is
    this process's share) when it exists, else made by ``make()``
    (``synthetic://N``, the same on every process) or by ``prepare_hf`` with
    ``codec`` (this process's share), and saved there when ``save_to_disk``
    is set."""
    cache = None
    pi, pc = dist.process_index(), dist.process_count()
    if data_args.save_to_disk:
        os.makedirs(data_args.save_to_disk, exist_ok=True)
        fp = _prepare_fingerprint(data_args, model_args, cfg)
        suffix = f"_h{pi}of{pc}" if pc > 1 else ""
        cache = os.path.join(data_args.save_to_disk, f"{split}_prepared_{fp}{suffix}.npy")
        if os.path.exists(cache):
            samples = list(np.load(cache, allow_pickle=True))
            print(f"[data] loaded {len(samples)} prepared samples from {cache}")
            return samples
    if make is None:
        samples = prepare_hf(data_args, model_args, cfg, codec, split=split, max_samples=max_samples,
                             process_index=pi, process_count=pc)
    else:
        samples = make()
    if cache:
        np.save(cache, np.asarray(samples, dtype=object), allow_pickle=True)
        print(f"[data] saved {len(samples)} prepared samples to {cache}")
    return samples


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs) / 1e9


class _Silent:
    """The logger of a process other than 0: it records nothing."""

    def log(self, *args, **kwargs) -> None:
        pass

    log_predictions = close = log


def main(argv: list[str] | None = None, *, device: str | torch.device = "cuda") -> dict:
    """Train as the arguments say; returns ``steps`` (optimizer steps done),
    ``output_dir`` and ``timings`` (synchronised ms of each optimizer step,
    of each checkpoint save with its GB, of the resume load, of each eval's
    loss and generation passes, and of the final artifact with its GB).
    Under several processes every process calls it (module docstring)."""
    model_args, data_args, train_args = parse_args(argv)
    device = dist.initialize(device=device)
    if train_args.push_to_hub:
        raise NotImplementedError("push_to_hub: the port does not push to the hub (no network on the card's machine)")
    if train_args.scan_unroll != "auto":
        print(f"[plan] scan_unroll={train_args.scan_unroll} ignored: an XLA knob, the port's layers are a loop")
    np.random.seed(train_args.seed)
    timings: dict = {"step_ms": [], "save": [], "load": None, "eval": [], "artifact": None}

    # ----- processes and mesh -----
    pi, pc = dist.process_index(), dist.process_count()
    model_par = train_args.model_parallel_size
    if model_par < 1 or pc % model_par:
        raise ValueError(f"model_parallel_size={model_par} must divide the {pc} processes (launch a multiple of it "
                         f"with python -m torch.distributed.run --nproc_per_node=N)")
    mesh = pmesh.make_mesh(data=pc // model_par, model=model_par)
    logger_on = pi == 0

    # ----- model -----
    gen_cfg = GenerationConfig()
    if model_args.model_name_or_path and os.path.isdir(model_args.model_name_or_path):
        model, cfg, gen_cfg = ck.load_model(model_args.model_name_or_path, device=device, mesh=mesh)
    else:
        cfg = dummy_config() if model_args.model_name_or_path == "dummy" else mini_600m_config()
        model = pmesh.shard_params(parler.init(train_args.seed, cfg, device=device), mesh)

    # ----- data -----
    # map-style: every process prepares its share and the shares are
    # gathered, so each holds the whole set; streaming: each keeps its share
    # (a data rank's model ranks merge theirs: they must see the same rows)
    synthetic = data_args.train_dataset_name.startswith("synthetic://")
    full_data = synthetic or not data_args.streaming or pc == 1

    def placed(prepared: list[dict]) -> list[dict]:
        if synthetic or pc == 1:
            return prepared
        if full_data:
            return dist.gather_prepared(prepared)
        return dist.gather_prepared(prepared, mesh.model_group.group) if mesh.model > 1 else prepared

    if synthetic:
        n = int(data_args.train_dataset_name.split("://", 1)[1])
        samples = _load_or_prepare(data_args, model_args, cfg, split="train",
                                   make=lambda: prepare_synthetic(n, cfg, seed=train_args.seed))
    else:
        samples = placed(_load_or_prepare(data_args, model_args, cfg, split="train", codec=model.audio_encoder,
                                          max_samples=data_args.max_train_samples))
    if data_args.max_train_samples and full_data:
        samples = samples[: data_args.max_train_samples]
    eval_samples: list[dict] = []
    if train_args.do_eval:
        if synthetic:
            n_eval = data_args.max_eval_samples or 16
            eval_samples = _load_or_prepare(data_args, model_args, cfg, split="eval",
                                            make=lambda: prepare_synthetic(n_eval, cfg, seed=train_args.seed + 1))
        elif data_args.eval_dataset_name:
            eval_samples = placed(_load_or_prepare(data_args, model_args, cfg, split="eval",
                                                   codec=model.audio_encoder, max_samples=data_args.max_eval_samples))
        else:
            eval_samples = samples[: data_args.max_eval_samples or 16]
        if data_args.max_eval_samples and full_data:
            eval_samples = eval_samples[: data_args.max_eval_samples]
    if data_args.preprocessing_only:
        dist.barrier("preprocessing_only")
        print(f"preprocessing_only: prepared {len(samples)} samples")
        return {"samples": len(samples)}

    all_samples = samples + eval_samples
    label_len = max(s["labels"].shape[1] for s in all_samples)
    desc_len = max(len(s["input_ids"]) for s in all_samples)
    prompt_len = max(len(s["prompt_input_ids"]) for s in all_samples)
    if not full_data:  # every process collates to the same shapes
        label_len, desc_len, prompt_len = (int(v) for v in dist.global_max([label_len, desc_len, prompt_len]))
    if data_args.pad_to_max_length:
        label_len = (int(data_args.max_duration_in_seconds * cfg.audio_encoder.frame_rate)
                     + cfg.decoder.num_codebooks + 2)
        if data_args.max_description_token_length:
            desc_len = data_args.max_description_token_length
        if data_args.max_prompt_token_length:
            prompt_len = data_args.max_prompt_token_length
    collator = Collator(description_pad_id=0, prompt_pad_id=0, max_description_len=desc_len,
                        max_prompt_len=prompt_len, label_len=label_len)

    # ----- optimizer and state -----
    accum = max(1, train_args.gradient_accumulation_steps)
    per_device = train_args.per_device_train_batch_size
    per_step = per_device * mesh.data  # the global batch
    if full_data:
        micro_per_epoch = len(samples) // per_step
    else:  # the least any process has: every process takes as many steps
        micro_per_epoch = int(dist.global_min([len(samples) // per_device])[0])
    steps_per_epoch = micro_per_epoch // accum
    total_steps = (train_args.max_steps if train_args.max_steps > 0
                   else int(train_args.num_train_epochs * max(1, steps_per_epoch)))
    opt_kwargs = dict(learning_rate=train_args.learning_rate, schedule=train_args.lr_scheduler_type,
                      warmup_steps=train_args.warmup_steps, total_steps=total_steps, b1=train_args.adam_beta1,
                      b2=train_args.adam_beta2, eps=train_args.adam_epsilon, weight_decay=train_args.weight_decay,
                      max_grad_norm=train_args.max_grad_norm,
                      grad_accum_steps=train_args.gradient_accumulation_steps)
    state = tstep.create_state(model, mesh, **opt_kwargs)
    dims = tstep.trainable_dims(model)

    # ----- resume: optimizer steps done, epoch, micro-batches of that epoch done -----
    start_epoch, done_steps, skip_micro = 0, 0, 0
    resume = train_args.resume_from_checkpoint or ck.latest_checkpoint(train_args.output_dir)
    if resume and os.path.isdir(resume):
        t0 = time.perf_counter()
        payload, meta = ck.load_train_state(resume)
        ck.restore_params(model, payload["params"], mesh)
        try:
            state.optimizer.load_state_dict(map_param_state(
                payload["opt_state"], lambda i, t: pmesh.shard_tensor(t, dims[i], mesh)))
        except (KeyError, ValueError, RuntimeError) as e:
            print(f"[resume] optimizer state not restored ({e!r}); parameters restored, optimizer state "
                  f"reinitialised", file=sys.stderr)
            state = tstep.create_state(model, mesh, **opt_kwargs)
        _sync(device)
        timings["load"] = {"ms": 1e3 * (time.perf_counter() - t0), "gb": _gb(resume)}
        done_steps = int(meta.get("step", 0))
        start_epoch = int(meta.get("epoch", 0))
        skip_micro = int(meta.get("micro_in_epoch", 0))
        state.step = done_steps * accum  # seeds dropout as a straight run would
        del payload
        print(f"resumed from {resume} at optimizer step {done_steps}, epoch {start_epoch}, "
              f"skipping {skip_micro} micro-batches")

    dtype = DTYPES[train_args.dtype]
    remat = resolve_train_plan(cfg, per_device_batch=per_device, fused_len=prompt_len + label_len,
                               gradient_checkpointing=train_args.gradient_checkpointing,
                               gradient_checkpointing_policy=train_args.gradient_checkpointing_policy,
                               device=device)
    if logger_on:
        print(f"[plan] remat={remat} (batch {per_device} x fused {prompt_len + label_len}; mesh {mesh.shape})")
    train_step = tstep.make_train_step(cfg, dtype=dtype, dropout_seed=train_args.seed, remat=remat, mesh=mesh)
    eval_step = tstep.make_eval_step(cfg, dtype=dtype, mesh=mesh)
    logger = (MetricLogger(train_args.output_dir, report_to=train_args.report_to,
                           config={"total_steps": total_steps, "per_step_batch": per_step})
              if logger_on else _Silent())

    def save_checkpoint(opt_step: int, epoch: int, micro_in_epoch: int) -> None:
        """Full tensors gathered on every rank, written by rank 0."""
        path = os.path.join(train_args.output_dir, ck.checkpoint_name(opt_step, epoch))
        t0 = time.perf_counter()
        params = ck.trainable_state_dict(model, mesh)
        opt_state = map_param_state(state.optimizer.state_dict(),
                                    lambda i, t: pmesh.gather_tensor(t, dims[i], mesh))
        if pi == 0:
            ck.save_train_state(path, params=params, opt_state=opt_state, step=opt_step, epoch=epoch,
                                extra={"micro_in_epoch": micro_in_epoch})
            ck.rotate_checkpoints(train_args.output_dir, train_args.save_total_limit)
        dist.barrier("checkpoint")
        timings["save"].append({"step": opt_step, "ms": 1e3 * (time.perf_counter() - t0), "gb": _gb(path)})

    # ----- eval -----
    per_eval = max(1, train_args.per_device_eval_batch_size)
    eval_per_step = per_eval * mesh.data  # the global eval batch
    egen = dataclasses.replace(gen_cfg, max_length=train_args.generation_max_length or gen_cfg.max_length,
                               decoder_start_token_id=cfg.decoder.bos_token_id,
                               pad_token_id=cfg.decoder.pad_token_id, bos_token_id=cfg.decoder.bos_token_id,
                               eos_token_id=cfg.decoder.eos_token_id)
    metric_hooks: list = []

    def pad_eval_batch(ebatch: dict, n: int) -> dict:
        """Pad a partial eval batch to ``n`` rows that repeat real rows with
        all-(-100) labels: they add nothing to the loss sum or the count."""
        b = next(iter(ebatch.values())).shape[0]
        if b >= n:
            return ebatch
        reps = np.arange(n - b) % b
        return {k: np.concatenate([v, np.full_like(v[reps], -100) if k == "labels" else v[reps]], axis=0)
                for k, v in ebatch.items()}

    def collate_eval_rows(rows: list[dict]) -> dict:
        """This data rank's eval rows padded to ``per_eval``; with none (a
        lockstep filler), rows whose labels are all -100."""
        if rows:
            return pad_eval_batch(collator(rows), per_eval)
        dummy = collator([eval_samples[0]] * per_eval)
        dummy["labels"] = np.full_like(dummy["labels"], -100)
        return dummy

    def eval_loss_batches():
        """This data rank's rows of each global eval batch; every process
        takes as many batches."""
        if full_data:
            n_batches = -(-len(eval_samples) // eval_per_step) if eval_samples else 0
            for bi in range(n_batches):
                lo = bi * eval_per_step + mesh.data_index * per_eval
                yield collate_eval_rows(eval_samples[lo : lo + per_eval])
        else:
            n_local = -(-len(eval_samples) // per_eval) if eval_samples else 0
            for bi in range(int(dist.global_max([n_local])[0])):
                yield collate_eval_rows(eval_samples[bi * per_eval : (bi + 1) * per_eval])

    def run_eval_generation(opt_step: int, emetrics: dict) -> None:
        """Generation over this data rank's share of the eval split (the
        whole of it on one data rank), in chunks of the eval batch, in the
        compute dtype; code lengths, WER/CLAP, weighted over the processes,
        and up to 100 predictions."""
        rows = eval_samples[mesh.data_index::mesh.data] if full_data else eval_samples
        code_lens: list[float] = []
        all_audio: list[np.ndarray] = []
        all_texts: list = []
        all_descs: list = []
        if rows:
            gen_model = model if dtype == torch.float32 else copy.deepcopy(model).to(dtype)
            gsize = min(per_eval, len(rows))
            for ci in range(0, len(rows), gsize):
                chunk = rows[ci : ci + gsize]
                nvalid = len(chunk)
                gbatch = collator(chunk + [chunk[-1]] * (gsize - nvalid))
                out = generate(gen_model, egen, input_ids=gbatch["input_ids"],
                               attention_mask=gbatch["attention_mask"], prompt_input_ids=gbatch["prompt_input_ids"],
                               prompt_attention_mask=gbatch["prompt_attention_mask"],
                               generator=torch.Generator(device=device).manual_seed(opt_step * 100003 + ci),
                               vocode=True, device=device)
                code_lens.extend(out.code_lengths.cpu()[:nvalid].tolist())
                audio, alen = out.audio.float().cpu().numpy(), out.audio_lengths.cpu().numpy()
                all_audio.extend(audio[i, : int(alen[i])] for i in range(nvalid))
                all_texts.extend(s.get("prompt_text") for s in chunk)
                all_descs.extend(s.get("description_text") for s in chunk)
            del gen_model
        gmetrics = {"gen_code_len_mean": float(np.mean(code_lens))} if code_lens else {}
        if all_audio and all(t is not None for t in all_texts):
            if not metric_hooks:
                metric_hooks.extend([WerMetric(model_args.asr_model_name_or_path),
                                     ClapMetric(model_args.clap_model_name_or_path)])
            sr = cfg.audio_encoder.sampling_rate
            gmetrics.update(metric_hooks[0](all_texts, all_audio, sr))
            if all(d is not None for d in all_descs):
                gmetrics.update(metric_hooks[1](all_descs, all_audio, sr))
        emetrics.update(dist.all_gather_metrics(gmetrics, weight=len(code_lens)))
        logger.log_predictions(step=opt_step, prompts=all_texts[:100], descriptions=all_descs[:100],
                               audio=all_audio[:100], sampling_rate=cfg.audio_encoder.sampling_rate)

    def run_eval(opt_step: int) -> None:
        t0 = time.perf_counter()
        # the eval step's loss is the global batch's: the same on every process
        losses = [float(eval_step(model, ebatch)["loss"]) for ebatch in eval_loss_batches()]
        emetrics = {"loss": float(np.mean(losses))} if losses else {}
        t1 = time.perf_counter()
        if train_args.generation_max_length and eval_samples:
            run_eval_generation(opt_step, emetrics)
        _sync(device)
        timings["eval"].append({"step": opt_step, "loss_ms": 1e3 * (t1 - t0),
                                "generation_ms": 1e3 * (time.perf_counter() - t1)})
        if emetrics:
            logger.log(emetrics, step=opt_step, prefix="eval")

    # ----- loop: save, eval, log and max_steps count optimizer steps -----
    micro = 0
    opt_step = done_steps
    t_start = time.time()
    stop = False
    if train_args.max_steps > 0:
        remaining = max(1, train_args.max_steps - done_steps)
        first_epoch_steps = max(0, steps_per_epoch - skip_micro // accum)
        extra_epochs = math.ceil(max(0, remaining - first_epoch_steps) / max(1, steps_per_epoch))
        last_epoch = start_epoch + 1 + extra_epochs
    else:
        last_epoch = math.ceil(train_args.num_train_epochs)
    for epoch in range(start_epoch, last_epoch):
        if full_data:  # one shared permutation; this data rank's rows of each global batch
            lo = mesh.data_index * per_device
            epoch_iter = batches(samples, collator, per_step, seed=train_args.seed + epoch,
                                 group_by_length=train_args.group_by_length,
                                 row_slice=(lo, lo + per_device) if mesh.data > 1 else None)
        else:
            epoch_iter = itertools.islice(batches(samples, collator, per_device, seed=train_args.seed + epoch,
                                                  group_by_length=train_args.group_by_length), micro_per_epoch)
        micro_in_epoch = 0
        if epoch == start_epoch and skip_micro:
            # the same seed replays the epoch's order; skip what was consumed
            for _ in range(skip_micro):
                if next(epoch_iter, None) is None:
                    break
                micro_in_epoch += 1
        t_step = time.perf_counter()
        for batch in epoch_iter:
            metrics = train_step(state, dist.host_local_to_global(batch, device))
            micro += 1
            micro_in_epoch += 1
            if micro % accum:
                continue
            opt_step += 1
            _sync(device)
            timings["step_ms"].append(1e3 * (time.perf_counter() - t_step))
            if opt_step % train_args.logging_steps == 0:
                logger.log({"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                            "steps_per_sec": (opt_step - done_steps) / max(1e-9, time.time() - t_start)},
                           step=opt_step)
            if train_args.save_steps and opt_step % train_args.save_steps == 0:
                save_checkpoint(opt_step, epoch, micro_in_epoch)
            if train_args.do_eval and train_args.eval_steps and opt_step % train_args.eval_steps == 0:
                run_eval(opt_step)
            if train_args.max_steps > 0 and opt_step >= train_args.max_steps:
                stop = True
                break
            t_step = time.perf_counter()
        if stop:
            break

    # ----- final artifact -----
    final_dir = os.path.join(train_args.output_dir, "final")
    # the artifact carries the prompt tokenizer (prompts and descriptions
    # share one in every recipe); a run without one saves none
    save_tok = None
    tok_src = model_args.prompt_tokenizer_name or model_args.model_name_or_path
    if tok_src and pi == 0:
        try:
            save_tok = Tokenizer.from_pretrained(tok_src)
        except FileNotFoundError as e:
            print(f"artifact tokenizer not saved ({tok_src}: {e})", file=sys.stderr)
    t0 = time.perf_counter()
    ck.save_model(final_dir, model, cfg, gen_cfg, tokenizer=save_tok, mesh=mesh)
    dist.barrier("artifact")
    timings["artifact"] = {"ms": 1e3 * (time.perf_counter() - t0), "gb": _gb(final_dir)}
    logger.log({"final_step": opt_step, "wall_s": time.time() - t_start}, step=opt_step)
    logger.close()
    return {"steps": opt_step, "output_dir": train_args.output_dir, "timings": timings}


if __name__ == "__main__":
    main()
