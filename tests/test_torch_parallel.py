"""Multi-process placement of the port (``parallel/``, the CLI's data and
model parallelism) against the single-process port and the JAX package, at
fp32 on CPU, with 2 and 4 gloo processes (``tests/torch_multiprocess_worker.py``,
the counterpart of ``tests/multihost_worker.py``), on the tiny composite:

* the specs name every parameter and place it as JAX's
  ``composite_param_specs`` does, leaf for leaf through ``from_jax``;
* two-process preparation: each process encodes its strided share, the
  re-run encodes nothing, ``gather_prepared`` restores the source order;
* ``data=2``: the CLI's losses and gradient norms against the
  single-process run at the same global batch and the JAX loop;
* streaming with unequal shards: the same steps and logged losses on both;
* ``model=2``: the loss and the gathered gradients, the T5 encoder with its
  sliced relative bias, and greedy tokens against the unsplit model and
  JAX's ``generate``; the CLI against the single-process run;
* ``data=2 x model=2`` (4 processes): the CLI's steps;
* checkpoints: saved at ``model=2``, resumed at ``model=1`` bit for bit,
  and the reverse.

Tolerances: ``LOSS_TOL`` (1e-5 absolute) on losses and 1e-5 relative on
gradient norms, those of the single-process CLI test against JAX: the sums
run in another order over two ranks (row shares, head shares).  Gradients
1e-5 absolute (``GRAD_TOL``).  Parameters restored from a checkpoint, the
ranks' shards against the checkpoint, and tokens: exact.
"""

from __future__ import annotations

import copy
import json
import os
import pathlib
import shutil
import subprocess
import sys

import datasets as hfds
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu.parallel import mesh as jmesh
from parler_tts_tpu.training import data as jdata
from parler_tts_tpu.training import optim as joptim
from parler_tts_tpu.training import run_training as jrun
from parler_tts_tpu.training import step as jstep
from parler_tts_tpu_torch.core import checkpoint as ck
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core.from_jax import load_jax_params
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.parallel import distributed as pdist
from parler_tts_tpu_torch.parallel import mesh as pmesh
from parler_tts_tpu_torch.training import args as pargs
from parler_tts_tpu_torch.training import run_training as prun
from parler_tts_tpu_torch.training import step as pstep
from parler_tts_tpu_torch.training.optim import map_param_state
from tests import torch_tokenizer_fixtures as fx
from tests.test_torch_blocks import jax_params, port_model, tiny_config
from tests.test_torch_train import GRAD_TOL, LOSS_TOL

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_multiprocess_worker.py"
SPAWN_TIMEOUT = 120  # seconds for one group of workers
SR = 16000
SPECIALS = dict(decoder_start_token_id=33, pad_token_id=32, bos_token_id=33, eos_token_id=32)
GREEDY = dict(max_length=14, do_sample=False, **SPECIALS)
SEED, STEPS = 42, 3
CLI = ["--train_dataset_name", "synthetic://16", "--logging_steps", "1", "--dtype", "float32",
       "--lr_scheduler_type", "constant", "--max_steps", str(STEPS)]
# an eval at the last step: the loss pass over 3 samples in one global batch of
# 4 (data=2: 2 rows per rank, one a padding row) and a short generation pass
EVAL = ["--do_eval", "--eval_steps", str(STEPS), "--max_eval_samples", "3", "--generation_max_length", "10"]
CORPUS_FLAGS = ["--target_audio_column_name", "audio_raw", "--min_duration_in_seconds", "0.01",
                "--max_duration_in_seconds", "0.12", "--audio_encoder_batch_size", "2"]


def _spawn(world: int, workdir: pathlib.Path, jobs: list[dict]) -> dict[str, list[dict]]:
    """``world`` workers over one gloo group running ``jobs``; each job's
    result per rank."""
    workdir.mkdir(parents=True, exist_ok=True)
    spec = workdir / "spec.json"
    spec.write_text(json.dumps({"workdir": str(workdir), "jobs": jobs}))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), str(workdir / "store"), str(spec)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out.decode(errors='replace')[-4000:]}"
    return {job["name"]: [torch.load(workdir / f"{job['name']}_r{r}.pt", weights_only=False) for r in range(world)]
            for job in jobs}


def _steps(out: pathlib.Path, run) -> list[dict]:
    """Run ``run()`` with the train step spied: each step's metrics and the
    parameters and optimizer state it started from."""
    seen, make = [], pstep.make_train_step

    def spy(*args, **kwargs):
        inner = make(*args, **kwargs)

        def step(state, batch, timings=None):
            before = {"params": {k: v.clone() for k, v in ck.trainable_state_dict(state.model).items()},
                      "opt_state": copy.deepcopy(state.optimizer.state_dict())}
            metrics = inner(state, batch, timings)
            seen.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), **before})
            return metrics
        return step

    pstep.make_train_step = spy
    try:
        run()
    finally:
        pstep.make_train_step = make
    return seen


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A JAX-initialised tiny composite as a port artifact, an 8-row corpus
    of 0.02-0.05 s clips, the toy WordPiece and the split job's inputs."""
    base = tmp_path_factory.mktemp("parallel")
    params = jax_params(tiny_config(jcfg), seed=3)
    model = port_model(params)
    ck.save_model(str(base / "art"), model, tiny_config(pcfg), pcfg.GenerationConfig(**SPECIALS))
    rng = np.random.default_rng(0)
    hfds.Dataset.from_dict({
        "audio_raw": [{"array": (0.3 * rng.standard_normal(int(SR * rng.uniform(0.02, 0.05)))).astype(np.float32),
                       "sampling_rate": SR} for _ in range(8)],
        "text": [f"hey how are you doing today {i}" for i in range(8)],
        "description": [f"a female speaker with a low pitched voice {i}" for i in range(8)],
    }).save_to_disk(str(base / "corpus"))
    shutil.copytree(os.path.join(fx.FIXTURES, "toy_wordpiece"), base / "tok")
    samples = jrun.prepare_synthetic(4, tiny_config(jcfg), seed=9)
    collator = jdata.Collator(0, 0, 24, 16, max(s["labels"].shape[1] for s in samples))
    np.savez(base / "inputs.npz", **collator(samples))
    return {"base": base, "art": str(base / "art"), "params": params, "corpus": str(base / "corpus"),
            "tok": str(base / "tok"), "inputs": str(base / "inputs.npz")}


@pytest.fixture(scope="module")
def single(setup):
    """The single-process CLI at batch 2 (a checkpoint at step 2), and the
    JAX loop over the same batches."""
    out = setup["base"] / "single"
    argv = ["--model_name_or_path", setup["art"], "--output_dir", str(out), "--per_device_train_batch_size", "2",
            "--save_steps", "2", *CLI, *EVAL, "--per_device_eval_batch_size", "4"]
    steps = _steps(out, lambda: prun.main(argv, device="cpu"))
    jc = tiny_config(jcfg)
    samples = jrun.prepare_synthetic(16, jc, seed=SEED)
    collator = jdata.Collator(0, 0, max(len(s["input_ids"]) for s in samples),
                              max(len(s["prompt_input_ids"]) for s in samples),
                              max(s["labels"].shape[1] for s in samples))
    tx = joptim.make_optimizer(9.5e-4, schedule="constant", warmup_steps=0, total_steps=STEPS, b1=0.9, b2=0.99,
                               eps=1e-8, weight_decay=0.01, max_grad_norm=1.0, grad_accum_steps=1)
    state, frozen = jstep.create_state(setup["params"], tx)
    jax_step = jax.jit(jstep.make_train_step(jc, tx, dtype=jnp.float32, dropout_seed=SEED))
    ref = []
    for batch in list(jdata.batches(samples, collator, 2, seed=SEED))[:STEPS]:
        state, metrics = jax_step(state, frozen, batch)
        ref.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return {"steps": steps, "jax": ref, "checkpoint": str(out / "checkpoint-2-epoch-0")}


@pytest.fixture(scope="module")
def two(setup, single):
    """One group of 2 processes: preparation, the data-parallel CLI,
    streaming, the split model, the model-parallel CLI (a checkpoint at
    step 2) and a model-parallel resume from the single run's checkpoint."""
    base, art = setup["base"], setup["art"]
    corpus_cli = ["--model_name_or_path", art, "--train_dataset_name", setup["corpus"], "--streaming", "true",
                  "--max_train_samples", "7", "--description_tokenizer_name", setup["tok"],
                  "--prompt_tokenizer_name", setup["tok"], *CORPUS_FLAGS, "--per_device_train_batch_size", "1",
                  "--logging_steps", "1", "--dtype", "float32", "--output_dir", str(base / "stream")]
    jobs = [
        {"kind": "prepare", "name": "prepare", "artifact": art, "tok": setup["tok"], "data_args": dict(
            train_dataset_name=setup["corpus"], target_audio_column_name="audio_raw", min_duration_in_seconds=0.01,
            max_duration_in_seconds=10.0, audio_encoder_batch_size=2,
            temporary_save_to_disk=str(base / "codes_cache"))},
        {"kind": "train", "name": "data2", "argv": ["--model_name_or_path", art, "--output_dir", str(base / "data2"),
                                                     "--per_device_train_batch_size", "1", *CLI, *EVAL,
                                                     "--per_device_eval_batch_size", "2"]},
        {"kind": "train", "name": "stream", "argv": corpus_cli},
        {"kind": "split", "name": "split", "artifact": art, "inputs": setup["inputs"], "generation": GREEDY},
        {"kind": "train", "name": "model2", "argv": [
            "--model_name_or_path", art, "--output_dir", str(base / "model2"), "--per_device_train_batch_size", "2",
            "--model_parallel_size", "2", "--save_steps", "2", *CLI, *EVAL, "--per_device_eval_batch_size", "4"]},
        {"kind": "train", "name": "resume2", "argv": [
            "--model_name_or_path", art, "--output_dir", str(base / "resume2"), "--per_device_train_batch_size", "2",
            "--model_parallel_size", "2", "--resume_from_checkpoint", single["checkpoint"], *CLI]},
    ]
    return _spawn(2, base / "two", jobs)


# --- specs and the single-process layer -------------------------------------------------


def test_specs_cover_every_parameter_and_place_it_as_jax_does(setup):
    """Each JAX leaf becomes a marker array (1 + its index along the axis
    split on ``model``, 0 where replicated), carried into the port model by
    ``load_jax_params``: every port parameter's spec names the axis its
    markers vary along, or None where they are all 0."""
    params = setup["params"]
    specs = jmesh.composite_param_specs(params)

    def marker(x, spec):
        x = np.asarray(x)
        if "model" not in tuple(spec):
            return np.zeros(x.shape, np.float32)
        axis = tuple(spec).index("model")
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        return np.broadcast_to(1 + np.arange(x.shape[axis], dtype=np.float32).reshape(shape), x.shape)

    markers = jax.tree.map(marker, params, specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    model = pparler.init(0, tiny_config(pcfg), device="cpu")
    load_jax_params(model, markers)
    got = pmesh.composite_param_specs(model)
    assert set(got) == {name for name, _ in model.named_parameters()}
    split = {}
    for name, p in model.named_parameters():
        dim = got[name]
        if dim is None:
            assert not p.any(), name
        else:
            shape = [1] * p.dim()
            shape[dim] = p.shape[dim]
            assert torch.equal(p, (1 + torch.arange(p.shape[dim], dtype=p.dtype)).reshape(shape).expand_as(p)), name
            split[name.rsplit(".", 2)[-2] if ".layers." in name else name] = dim
    assert split == {"q": 1, "k": 1, "v": 1, "o": 0, "fc1": 1, "fc2": 0, "wi_0": 1, "wi_1": 1, "wo": 0,
                     "decoder.lm_heads.kernel": 2}


@pytest.mark.parametrize("model", [2, 4])
def test_large_2b_config_splits_without_materialising(model):
    """``large_2b_config`` (the JAX package's model-parallel target) on the
    meta device: every split dimension divides by 2 and by 4."""
    with torch.device("meta"):
        net = pparler.ParlerTTSModel(pcfg.large_2b_config())
    specs = pmesh.composite_param_specs(net)
    assert specs["decoder.layers.0.fc1.kernel"] == 1 and specs["decoder.lm_heads.kernel"] == 2
    for m in range(model):
        mesh = pmesh.Mesh(1, model, rank=m)
        for name, p in net.named_parameters():
            shard = pmesh.shard_tensor(p, specs[name], mesh)
            dim = specs[name]
            assert shard.shape == p.shape if dim is None else shard.shape[dim] * model == p.shape[dim]


def test_one_process_degrades_and_refuses_what_does_not_divide():
    assert pdist.process_index() == 0 and pdist.process_count() == 1 and not pdist.is_initialized()
    assert pdist.initialize(device="cpu") == torch.device("cpu") and not pdist.is_initialized()
    assert pdist.process_shard(list(range(5))) == [0, 1, 2, 3, 4]
    assert pdist.process_shard(list(range(5)), process_index=1, process_count=2) == [1, 3]
    assert pdist.global_max([1, 5]) == [1.0, 5.0] and pdist.global_min([2]) == [2.0] and pdist.global_sum([3]) == [3.0]
    assert pdist.all_gather_metrics({"wer": 1}, weight=3) == {"wer": 1.0}
    assert [s["_idx"] for s in pdist.gather_prepared([{"_idx": 2}, {"_idx": 0}])] == [0, 2]
    with pdist.main_process_first() as first:
        assert first
    mesh = pmesh.make_mesh()
    assert (mesh.data, mesh.model, mesh.data_group, mesh.model_group) == (1, 1, None, None)
    assert pmesh.single_device_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="do not divide by model=2"):
        pmesh.make_mesh(model=2)
    batch = {"x": np.arange(6).reshape(3, 2)}
    assert pmesh.shard_batch(batch, mesh)["x"].shape == (3, 2)
    with pytest.raises(ValueError, match="does not divide by data=2"):
        pmesh.shard_batch(batch, pmesh.Mesh(2, 1, rank=1))
    with pytest.raises(ValueError, match="heads do not divide by model=3"):
        pmesh.shard_params(pparler.init(0, tiny_config(pcfg), device="cpu"), pmesh.Mesh(1, 3))
    with pytest.raises(ValueError, match="does not divide by model=3"):
        pmesh.shard_tensor(torch.zeros(4, 8), 1, pmesh.Mesh(1, 3))


# --- two processes --------------------------------------------------------------------


def test_two_process_prepare_shards_and_gathers(two):
    r0, r1 = two["prepare"]
    assert r0["encoded"] == 4 and r1["encoded"] == 4
    assert sorted(r0["idx"]) == [0, 2, 4, 6] and sorted(r1["idx"]) == [1, 3, 5, 7]
    assert r0["encoded_rerun"] == 0 and r1["encoded_rerun"] == 0
    assert r0["gathered_idx"] == r1["gathered_idx"] == list(range(8))


def test_two_process_prepare_matches_one_process(setup, two):
    """The union of the shards' labels equals one process's, row for row."""
    import hashlib

    model, cfg, _ = ck.load_model(setup["art"], device="cpu")
    data_args = pargs.DataTrainingArguments(train_dataset_name=setup["corpus"], target_audio_column_name="audio_raw",
                                            min_duration_in_seconds=0.01, max_duration_in_seconds=10.0,
                                            audio_encoder_batch_size=2)
    model_args = pargs.ModelArguments(model_name_or_path=setup["tok"], description_tokenizer_name=setup["tok"],
                                      prompt_tokenizer_name=setup["tok"])
    one = prun.prepare_hf(data_args, model_args, cfg, model.audio_encoder)
    merged = {**two["prepare"][0]["labels_md5"], **two["prepare"][1]["labels_md5"]}
    assert merged == {int(s["_idx"]): hashlib.md5(np.ascontiguousarray(s["labels"]).tobytes()).hexdigest()
                      for s in one}


def test_data_parallel_cli_matches_one_process_and_jax(single, two):
    """Per-device batch 1 on 2 processes: each rank took 1 row of the same
    global batches of 2, and both report the global batch's loss and norm."""
    for rank in two["data2"]:
        got = rank["steps"]
        assert rank["done"] == STEPS and [s["rows"] for s in got] == [1] * STEPS
        for g, s, (jloss, jnorm) in zip(got, single["steps"], single["jax"]):
            np.testing.assert_allclose(g["loss"], s["loss"], atol=LOSS_TOL, rtol=0)
            np.testing.assert_allclose(g["grad_norm"], s["grad_norm"], rtol=1e-5)
            np.testing.assert_allclose(g["loss"], jloss, atol=LOSS_TOL, rtol=0)
            np.testing.assert_allclose(g["grad_norm"], jnorm, rtol=1e-5)
    assert [s["loss"] for s in two["data2"][0]["steps"]] == [s["loss"] for s in two["data2"][1]["steps"]]


def _eval(out: pathlib.Path) -> dict:
    (rec,) = [json.loads(line) for line in open(out / "metrics.jsonl") if "eval/loss" in line]
    return rec


@pytest.mark.parametrize("run", ["data2", "model2"])
def test_eval_over_processes_equals_one_process(setup, single, two, run):
    """The eval loss pass over several processes is the global batch's (the
    padding and filler rows count for nothing), and the generation pass's
    metrics are gathered; rank 0 alone wrote them."""
    got, want = _eval(setup["base"] / run), _eval(setup["base"] / "single")
    assert got["step"] == want["step"] == STEPS
    np.testing.assert_allclose(got["eval/loss"], want["eval/loss"], atol=LOSS_TOL, rtol=0)
    assert got.keys() == want.keys() and np.isfinite(got["eval/gen_code_len_mean"])


def test_streaming_lockstep_with_unequal_shards(two):
    """7 streamed rows: shards of 4 and 3; both processes take 3 steps and
    report the same losses."""
    r0, r1 = two["stream"]
    assert r0["done"] == r1["done"] == 3 and len(r0["steps"]) == len(r1["steps"]) == 3
    assert all(np.isfinite(s["loss"]) for s in r0["steps"])
    assert [s["loss"] for s in r0["steps"]] == [s["loss"] for s in r1["steps"]]
    assert [s["grad_norm"] for s in r0["steps"]] == [s["grad_norm"] for s in r1["steps"]]


@pytest.fixture(scope="module")
def unsplit(setup):
    """The unsplit port model on the split job's inputs: T5, loss,
    gradients, norm; JAX's greedy tokens."""
    model, _, _ = ck.load_model(setup["art"], device="cpu")
    inputs = {k: torch.from_numpy(v) for k, v in np.load(setup["inputs"]).items()}
    with torch.no_grad():
        t5 = model.text_encoder(inputs["input_ids"], inputs["attention_mask"])
    state = pstep.create_state(model, learning_rate=1e-3, warmup_steps=0)
    loss, _ = model.train_forward(**{k: inputs[k] for k in pstep.BATCH_KEYS if k in inputs}, dtype=torch.float32)
    grads = torch.autograd.grad(loss, state.optimizer.params)
    ref = jgenerate.generate(setup["params"], tiny_config(jcfg), jcfg.GenerationConfig(**GREEDY),
                             key=jax.random.PRNGKey(0), vocode=False,
                             **{k: np.asarray(inputs[k]) for k in ("input_ids", "attention_mask", "prompt_input_ids",
                                                                   "prompt_attention_mask")})
    port = pgenerate.generate(model, pcfg.GenerationConfig(**GREEDY), vocode=False, device="cpu",
                              **{k: inputs[k] for k in ("input_ids", "attention_mask", "prompt_input_ids",
                                                        "prompt_attention_mask")})
    return {"t5": t5, "loss": loss, "grads": dict(zip(pstep.trainable_names(model), grads)),
            "grad_norm": state.optimizer.norm(list(grads)), "jax_tokens": np.asarray(ref.tokens),
            "tokens": port.tokens}


def test_split_model_loss_and_gradients_equal_the_unsplit(two, unsplit):
    for rank in two["split"]:
        assert rank["local_heads"] == 2 and rank["local_t5_heads"] == 2
        np.testing.assert_allclose(rank["loss"].item(), unsplit["loss"].item(), atol=LOSS_TOL, rtol=0)
        assert rank["grads"].keys() == unsplit["grads"].keys()
        for name, g in unsplit["grads"].items():
            np.testing.assert_allclose(rank["grads"][name].numpy(), g.numpy(), atol=GRAD_TOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(rank["grad_norm"].item(), unsplit["grad_norm"].item(), rtol=1e-5)


def test_split_t5_with_its_heads_bias_equals_the_unsplit(two, unsplit):
    for rank in two["split"]:
        np.testing.assert_allclose(rank["t5"].numpy(), unsplit["t5"].numpy(), atol=1e-5, rtol=0)


def test_split_model_greedy_tokens_equal_jax_s(two, unsplit):
    np.testing.assert_array_equal(unsplit["tokens"].numpy(), unsplit["jax_tokens"])
    for rank in two["split"]:
        np.testing.assert_array_equal(rank["tokens"].numpy(), unsplit["jax_tokens"])


def test_split_model_refuses_what_waits(two):
    """The int8 decode, streaming and the batching engine of a split model
    raise ``NotImplementedError`` (ROADMAP.md queue 1)."""
    for rank in two["split"]:
        assert rank["refused"] == {"int8": True, "stream": True, "engine": True}


def test_model_parallel_cli_matches_one_process(single, two):
    for rank in two["model2"]:
        assert rank["done"] == STEPS and [s["rows"] for s in rank["steps"]] == [2] * STEPS
        for g, s in zip(rank["steps"], single["steps"]):
            np.testing.assert_allclose(g["loss"], s["loss"], atol=LOSS_TOL, rtol=0)
            np.testing.assert_allclose(g["grad_norm"], s["grad_norm"], rtol=1e-5)


def test_model_2_checkpoint_holds_the_shards_and_resumes_at_model_1_bit_for_bit(setup, two, tmp_path):
    """The checkpoint written under model=2 is the ranks' shards joined (its
    step-2 state: the run went on to step 3, so the shards compared are
    those the spy saw at step 3's start); a one-process run resumes from it
    with exactly its parameters and optimizer state."""
    ckpt = setup["base"] / "model2" / "checkpoint-2-epoch-0"
    payload, meta = ck.load_train_state(str(ckpt))
    assert meta["step"] == 2
    resumed = _steps(tmp_path, lambda: prun.main(
        ["--model_name_or_path", setup["art"], "--output_dir", str(tmp_path), "--per_device_train_batch_size", "2",
         "--resume_from_checkpoint", str(ckpt), *CLI], device="cpu"))
    assert len(resumed) == 1
    first = resumed[0]
    assert first["params"].keys() == payload["params"].keys()
    assert all(torch.equal(first["params"][k], payload["params"][k]) for k in payload["params"])
    _same_state(first["opt_state"], payload["opt_state"])
    specs = pmesh.composite_param_specs(pparler.init(0, tiny_config(pcfg), device="cpu"))
    ranks = two["model2"]
    dims = [specs[n] for n in payload["params"]]
    for name, full in payload["params"].items():
        shards = [r["last"]["params"][name] for r in ranks]
        joined = shards[0] if specs[name] is None else torch.cat(shards, specs[name])
        assert torch.equal(joined, full), name
        assert specs[name] is not None or torch.equal(shards[1], full), name
    for i, dim in enumerate(dims):
        for key in ("exp_avg", "exp_avg_sq"):
            parts = [r["last"]["opt_state"]["adamw"]["state"][i][key] for r in ranks]
            want = payload["opt_state"]["adamw"]["state"][i][key]
            assert torch.equal(parts[0] if dim is None else torch.cat(parts, dim), want), (i, key)


def test_model_1_checkpoint_resumes_at_model_2_bit_for_bit(single, two):
    payload, _ = ck.load_train_state(single["checkpoint"])
    specs = pmesh.composite_param_specs(pparler.init(0, tiny_config(pcfg), device="cpu"))
    for rank, r in enumerate(two["resume2"]):
        assert r["done"] == STEPS and len(r["steps"]) == 1
        mesh = pmesh.Mesh(1, 2, rank=rank)
        first = r["first"]
        for name, full in payload["params"].items():
            assert torch.equal(first["params"][name], pmesh.shard_tensor(full, specs[name], mesh)), name
        dims = [specs[n] for n in payload["params"]]
        want = map_param_state(payload["opt_state"], lambda i, t: pmesh.shard_tensor(t, dims[i], mesh))
        _same_state(first["opt_state"], want)


def _same_state(got: dict, want: dict) -> None:
    assert got["count"] == want["count"] and got["mini_step"] == want["mini_step"]
    assert got["adamw"]["state"].keys() == want["adamw"]["state"].keys()
    for i, s in want["adamw"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["adamw"]["state"][i][k], v), (i, k)


# --- four processes -------------------------------------------------------------------


def test_data_2_by_model_2_cli_steps(setup, single):
    """4 processes, per-device batch 1: two data ranks of two model ranks
    each; every rank reports the global batch's loss."""
    base = setup["base"]
    results = _spawn(4, base / "four", [{"kind": "train", "name": "dp_tp", "argv": [
        "--model_name_or_path", setup["art"], "--output_dir", str(base / "dp_tp"), "--per_device_train_batch_size",
        "1", "--model_parallel_size", "2", *CLI]}])["dp_tp"]
    for rank in results:
        assert rank["done"] == STEPS and [s["rows"] for s in rank["steps"]] == [1] * STEPS
        for g, s in zip(rank["steps"], single["steps"]):
            np.testing.assert_allclose(g["loss"], s["loss"], atol=LOSS_TOL, rtol=0)
            np.testing.assert_allclose(g["grad_norm"], s["grad_norm"], rtol=1e-5)
    assert len({tuple(s["loss"] for s in r["steps"]) for r in results}) == 1
