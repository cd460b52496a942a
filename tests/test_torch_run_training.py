"""The port's training CLI against the JAX package at fp32 on CPU, on the
tiny composite: argument parsing, the CLI's losses and gradient norms
against a JAX loop of ``make_train_step``, resume (bit for bit equal to a
straight run), accumulation and rotation of checkpoints, the eval passes,
the prepared-data cache and its fingerprint, the checkpoint helpers, the
artifact's JSON files, ``from_pretrained``, WER and WAV bytes, the memory
plan, and the refusals (no CUDA, no ``datasets`` package, hub push, a
model-parallel size that does not divide the processes)."""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import checkpoint as jck
from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.training import args as jargs
from parler_tts_tpu.training import autotune as jautotune
from parler_tts_tpu.training import data as jdata
from parler_tts_tpu.training import eval_metrics as jeval
from parler_tts_tpu.training import optim as joptim
from parler_tts_tpu.training import run_training as jrun
from parler_tts_tpu.training import step as jstep
from parler_tts_tpu.utils import audio_io as jaudio
from parler_tts_tpu_torch.core import checkpoint as ck
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.training import args as pargs
from parler_tts_tpu_torch.training import autotune
from parler_tts_tpu_torch.training import eval_metrics as peval
from parler_tts_tpu_torch.training import optim as poptim
from parler_tts_tpu_torch.training import run_training as prun
from parler_tts_tpu_torch.utils import audio_io as paudio
from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer
from tests.test_torch_blocks import jax_params, port_model, tiny_config
from tests.test_torch_train import LOSS_TOL

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = pathlib.Path(__file__).resolve().parents[1]
RECIPES = sorted((REPO / "helpers" / "training_configs").glob("*.json"))
SPECIALS = dict(decoder_start_token_id=33, pad_token_id=32, bos_token_id=33, eos_token_id=32)


def _artifact(path, model=None, cfg=None, **gen_kw) -> str:
    """A port artifact of the tiny composite (random weights unless
    ``model`` is given) with the tiny model's token ids."""
    cfg = cfg or tiny_config(pcfg)
    model = model or pparler.init(0, cfg, device="cpu")
    ck.save_model(str(path), model, cfg, pcfg.GenerationConfig(**SPECIALS, **gen_kw))
    return str(path)


def _main(art, out, *extra, **kw):
    argv = ["--model_name_or_path", art, "--train_dataset_name", "synthetic://16", "--output_dir", str(out),
            "--per_device_train_batch_size", "2", "--logging_steps", "1", "--save_steps", "0",
            "--dtype", "float32", *extra]
    return prun.main(argv, device="cpu", **kw)


def _records(out) -> list[dict]:
    return [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]


def _train(out) -> list[dict]:
    return [r for r in _records(out) if "train/loss" in r]


# --- arguments ----------------------------------------------------------------


@pytest.mark.parametrize("argv", [[str(p)] for p in RECIPES] + [[
    "--train_dataset_name", "synthetic://8", "--do_eval", "--max_steps", "5", "--learning_rate", "1e-3",
    "--gradient_checkpointing", "false", "--save_total_limit", "2", "--max_eval_samples", "3",
    "--gradient_checkpointing_policy", "dots", "--unknown_flag", "x"]], ids=lambda a: os.path.basename(a[0]))
def test_parse_args_matches_jax(argv):
    assert len(RECIPES) == 2
    ref, got = jargs.parse_args(argv), pargs.parse_args(argv)
    for r, g in zip(ref, got):
        assert type(r).__name__ == type(g).__name__
        assert dataclasses.asdict(g) == dataclasses.asdict(r)
    for cls in ("ModelArguments", "DataTrainingArguments", "TrainingArguments"):
        assert ([(f.name, f.default) for f in dataclasses.fields(getattr(pargs, cls))]
                == [(f.name, f.default) for f in dataclasses.fields(getattr(jargs, cls))])


# --- the CLI against a JAX loop -----------------------------------------------------


def test_cli_losses_and_grad_norms_match_a_jax_loop(tmp_path):
    """Three logged steps from a JAX-initialised tree saved as a port
    artifact, against JAX's make_train_step over JAX's batches with the
    CLI's seed, collator maxima and optimizer arguments."""
    jc, pc = tiny_config(jcfg), tiny_config(pcfg)
    params = jax_params(jc, seed=3)
    art = _artifact(tmp_path / "art", port_model(params), pc)
    _main(art, tmp_path / "out", "--max_steps", "3", "--lr_scheduler_type", "constant")
    got = _train(tmp_path / "out")

    seed, n_steps = 42, 3
    samples = jrun.prepare_synthetic(16, jc, seed=seed)
    collator = jdata.Collator(0, 0, max(len(s["input_ids"]) for s in samples),
                              max(len(s["prompt_input_ids"]) for s in samples),
                              max(s["labels"].shape[1] for s in samples))
    tx = joptim.make_optimizer(9.5e-4, schedule="constant", warmup_steps=0, total_steps=n_steps, b1=0.9, b2=0.99,
                               eps=1e-8, weight_decay=0.01, max_grad_norm=1.0, grad_accum_steps=1)
    state, frozen = jstep.create_state(params, tx)
    step = jax.jit(jstep.make_train_step(jc, tx, dtype=jnp.float32, dropout_seed=seed))
    ref = []
    for batch in list(jdata.batches(samples, collator, 2, seed=seed))[:n_steps]:
        state, metrics = step(state, frozen, batch)
        ref.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    assert [r["step"] for r in got] == [1, 2, 3]
    for r, (loss, norm) in zip(got, ref):
        np.testing.assert_allclose(r["train/loss"], loss, atol=LOSS_TOL, rtol=0)
        np.testing.assert_allclose(r["train/grad_norm"], norm, rtol=1e-5)
    assert ref[0][0] != ref[2][0]


# --- resume, accumulation, rotation -----------------------------------------------


def _dropout_artifact(path) -> str:
    cfg = tiny_config(pcfg)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, dropout=0.1, attention_dropout=0.1))
    return _artifact(path, cfg=cfg)


def _spy_batches(monkeypatch) -> list[bytes]:
    """Record a hash of every micro-batch the CLI's train step takes."""
    seen = []
    make = prun.tstep.make_train_step

    def spy(*args, **kwargs):
        inner = make(*args, **kwargs)

        def step(state, batch, timings=None):
            seen.append(hashlib.sha1(b"".join(np.ascontiguousarray(batch[k]).tobytes()
                                              for k in sorted(batch))).hexdigest())
            return inner(state, batch, timings)
        return step

    monkeypatch.setattr(prun.tstep, "make_train_step", spy)
    return seen


def test_resume_equals_a_straight_run_bit_for_bit(tmp_path, monkeypatch):
    """Dropout on, 3 steps per epoch: a run to 2 and a resume to 4 (across
    the epoch boundary) take the same batches, losses and final parameters
    as a straight run to 4."""
    art = _dropout_artifact(tmp_path / "art")
    seen = _spy_batches(monkeypatch)
    common = ("--train_dataset_name", "synthetic://6", "--save_steps", "2", "--warmup_steps", "1")
    _main(art, tmp_path / "straight", "--max_steps", "4", *common)
    straight = list(seen)
    seen.clear()
    _main(art, tmp_path / "split", "--max_steps", "2", *common)
    assert [os.path.basename(p) for p in ck.sorted_checkpoints(str(tmp_path / "split"))] == ["checkpoint-2-epoch-0"]
    _main(art, tmp_path / "split", "--max_steps", "4", *common)
    assert seen == straight and len(set(straight)) == 4  # two epochs, each in its own order
    a, b = _train(tmp_path / "straight"), _train(tmp_path / "split")
    assert [r["step"] for r in b] == [1, 2, 3, 4]
    assert [r["train/loss"] for r in a] == [r["train/loss"] for r in b]
    assert [r["train/grad_norm"] for r in a] == [r["train/grad_norm"] for r in b]
    wa = torch.load(tmp_path / "straight" / "final" / ck.WEIGHTS_FILE, weights_only=True)
    wb = torch.load(tmp_path / "split" / "final" / ck.WEIGHTS_FILE, weights_only=True)
    assert wa.keys() == wb.keys() and all(torch.equal(wa[k], wb[k]) for k in wa)
    meta = json.loads((tmp_path / "split" / "checkpoint-4-epoch-1" / "trainer_state.json").read_text())
    assert meta == {"step": 4, "epoch": 1, "micro_in_epoch": 1}


def test_accumulation_counts_optimizer_steps(tmp_path):
    art = _artifact(tmp_path / "art")
    _main(art, tmp_path / "out", "--gradient_accumulation_steps", "2", "--save_steps", "1", "--max_steps", "2")
    names = [os.path.basename(p) for p in ck.sorted_checkpoints(str(tmp_path / "out"))]
    assert names == ["checkpoint-1-epoch-0", "checkpoint-2-epoch-0"]
    payload, meta = ck.load_train_state(str(tmp_path / "out" / "checkpoint-2-epoch-0"))
    assert meta == {"step": 2, "epoch": 0, "micro_in_epoch": 4}
    assert payload["opt_state"]["count"] == 2 and payload["opt_state"]["mini_step"] == 0
    assert [r["step"] for r in _train(tmp_path / "out")] == [1, 2]


def test_rotation_keeps_the_newest(tmp_path):
    art = _artifact(tmp_path / "art")
    _main(art, tmp_path / "out", "--save_steps", "1", "--save_total_limit", "2", "--max_steps", "4")
    names = [os.path.basename(p) for p in ck.sorted_checkpoints(str(tmp_path / "out"))]
    assert names == ["checkpoint-3-epoch-0", "checkpoint-4-epoch-0"]


def test_resume_without_optimizer_state_reinitialises_it(tmp_path, capsys):
    """As the JAX CLI: parameters restored, the optimizer rebuilt, said on
    stderr."""
    art = _artifact(tmp_path / "art")
    out = tmp_path / "out"
    _main(art, out, "--save_steps", "2", "--max_steps", "2")
    path = str(out / "checkpoint-2-epoch-0")
    payload, meta = ck.load_train_state(path)
    ck.save_train_state(path, params=payload["params"], step=meta["step"], epoch=meta["epoch"],
                        extra={"micro_in_epoch": meta["micro_in_epoch"]})
    capsys.readouterr()
    _main(art, out, "--save_steps", "2", "--max_steps", "3")
    assert "optimizer state not restored" in capsys.readouterr().err
    assert [r["step"] for r in _train(out)] == [1, 2, 3]


def test_optimizer_state_dict_round_trip_mid_accumulation():
    rng = np.random.default_rng(3)
    shapes = ((4, 3), (5,))
    grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes] for _ in range(5)]
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    kw = dict(warmup_steps=1, grad_accum_steps=2, max_grad_norm=0.5)
    a = poptim.make_optimizer([p.clone() for p in params], 1e-2, **kw)
    for g in grads[:3]:
        a.update(g)
    buf = io.BytesIO()
    torch.save(a.state_dict(), buf)
    b = poptim.make_optimizer([p.clone() for p in a.params], 1e-2, **kw)
    b.load_state_dict(torch.load(io.BytesIO(buf.getvalue()), weights_only=True))
    assert (b.count, b.mini_step) == (a.count, a.mini_step) == (1, 1)
    for g in grads[3:]:
        a.update(g)
        b.update(g)
    assert all(torch.equal(x, y) for x, y in zip(a.params, b.params))


# --- eval ---------------------------------------------------------------------------


def test_eval_logs_loss_generation_and_unavailable_metrics(tmp_path):
    """Greedy generation over the eval split with the special-id heads
    zeroed runs to full length, so every prediction has a WAV."""
    cfg = tiny_config(pcfg)
    model = pparler.init(0, cfg, device="cpu")
    with torch.no_grad():
        model.decoder.lm_heads.kernel[..., cfg.audio_encoder.codebook_size:] = 0
    art = _artifact(tmp_path / "art", model, cfg, do_sample=False)
    out = tmp_path / "out"
    _main(art, out, "--do_eval", "--eval_steps", "2", "--max_steps", "2", "--max_eval_samples", "3",
          "--generation_max_length", "12", "--per_device_eval_batch_size", "2")
    ev = [r for r in _records(out) if "eval/loss" in r]
    assert len(ev) == 1 and ev[0]["step"] == 2 and np.isfinite(ev[0]["eval/loss"])
    assert ev[0]["eval/gen_code_len_mean"] > 0
    assert ev[0]["eval/wer_available"] == 0.0 and ev[0]["eval/clap_available"] == 0.0
    assert np.isnan(ev[0]["eval/wer"]) and np.isnan(ev[0]["eval/clap"])
    rows = [json.loads(line) for line in open(out / "predictions.jsonl")]
    assert [r["prompt"] for r in rows] == [f"synthetic prompt {i}" for i in range(3)]
    for r in rows:
        audio, sr = paudio.read_wav(r["audio"])
        assert sr == cfg.audio_encoder.sampling_rate and audio.shape[0] == 1
        assert audio.shape[1] % cfg.audio_encoder.hop_length == 0 and audio.shape[1] > 0


def test_eval_loss_padding_rows_add_nothing(tmp_path):
    """The eval loss of 3 samples in batches of 2 (one padded row) equals
    the loss of batches without padding."""
    art = _artifact(tmp_path / "art")
    losses = []
    for bs in ("2", "3"):
        out = tmp_path / f"out{bs}"
        _main(art, out, "--do_eval", "--eval_steps", "1", "--max_steps", "1", "--max_eval_samples", "3",
              "--per_device_eval_batch_size", bs)
        losses.append([r for r in _records(out) if "eval/loss" in r][0]["eval/loss"])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3)


# --- prepared data --------------------------------------------------------------------


@pytest.mark.parametrize("change", [dict(), dict(max_duration_in_seconds=7.5), dict(train_dataset_name="a+b"),
                                    dict(prompt_column_name="words", streaming=True)])
def test_prepare_fingerprint_matches_jax(change):
    model = dict(model_name_or_path="dummy", prompt_tokenizer_name="tok")
    ref = jrun._prepare_fingerprint(jargs.DataTrainingArguments(**change), jargs.ModelArguments(**model),
                                    jcfg.dummy_config())
    got = prun._prepare_fingerprint(pargs.DataTrainingArguments(**change), pargs.ModelArguments(**model),
                                    pcfg.dummy_config())
    assert got == ref


def test_load_or_prepare_hits_its_cache_and_reads_jax_s(tmp_path, monkeypatch):
    cfg, calls = pcfg.dummy_config(), []

    def make():
        calls.append(1)
        return prun.prepare_synthetic(3, cfg, seed=len(calls))

    data = pargs.DataTrainingArguments(train_dataset_name="synthetic://3", save_to_disk=str(tmp_path))
    model = pargs.ModelArguments()
    first = prun._load_or_prepare(data, model, cfg, split="train", make=make)
    second = prun._load_or_prepare(data, model, cfg, split="train", make=make)
    assert len(calls) == 1 and np.array_equal(first[2]["labels"], second[2]["labels"])
    changed = dataclasses.replace(data, max_duration_in_seconds=7.5)
    prun._load_or_prepare(changed, model, cfg, split="train", make=make)
    prun._load_or_prepare(changed, model, cfg, split="train", make=make)
    assert len(calls) == 2
    # a cache the JAX package wrote for the same arguments is read as it is
    jdata_args = jargs.DataTrainingArguments(train_dataset_name="x", save_to_disk=str(tmp_path))
    written = jrun._load_or_prepare(jdata_args, jargs.ModelArguments(), jcfg.dummy_config(), None, split="eval",
                                    max_samples=None, make=lambda: jrun.prepare_synthetic(2, jcfg.dummy_config()))
    read = prun._load_or_prepare(pargs.DataTrainingArguments(train_dataset_name="x", save_to_disk=str(tmp_path)),
                                 model, cfg, split="eval")
    assert len(read) == 2 and all(np.array_equal(r["labels"], w["labels"]) for r, w in zip(read, written))
    # without a cache or ``make`` the samples come from prepare_hf (tests/test_torch_prepare_hf.py)
    seen = []
    monkeypatch.setattr(prun, "prepare_hf", lambda *a, **kw: seen.append((a[-1], kw)) or [])
    prun._load_or_prepare(pargs.DataTrainingArguments(train_dataset_name="y"), model, cfg, split="train",
                          codec="codec", max_samples=3)
    assert seen == [("codec", dict(split="train", max_samples=3, process_index=0, process_count=1))]


# --- checkpoints and the artifact ---------------------------------------------------------


def test_checkpoint_helpers_match_jax(tmp_path):
    names = ["checkpoint-10-epoch-1", "checkpoint-2-epoch-0", "checkpoint-9-epoch-0", "checkpoint-x-epoch-0",
             "final", "checkpoint-3-epoch-0.tmp"]
    for root in ("j", "p"):
        for name in names:
            (tmp_path / root / name).mkdir(parents=True)
        (tmp_path / root / "checkpoint-4-epoch-0").write_text("a file, not a checkpoint")
    j, p = str(tmp_path / "j"), str(tmp_path / "p")
    strip = lambda paths: [os.path.basename(x) for x in paths]  # noqa: E731
    assert strip(ck.sorted_checkpoints(p)) == strip(jck.sorted_checkpoints(j)) == [
        "checkpoint-2-epoch-0", "checkpoint-9-epoch-0", "checkpoint-10-epoch-1"]
    assert os.path.basename(ck.latest_checkpoint(p)) == os.path.basename(jck.latest_checkpoint(j))
    assert ck.latest_checkpoint(str(tmp_path / "none")) is jck.latest_checkpoint(str(tmp_path / "none")) is None
    for path in ("a/checkpoint-7-epoch-2", "checkpoint-7-epoch-2/"):
        assert ck.parse_step_epoch(path) == jck.parse_step_epoch(path) == (7, 2)
    with pytest.raises(ValueError):
        ck.parse_step_epoch("final")
    assert ck.checkpoint_name(5, 1) == jck.checkpoint_name(5, 1)
    ck.rotate_checkpoints(p, 2)
    jck.rotate_checkpoints(j, 2)
    assert sorted(os.listdir(p)) == sorted(os.listdir(j))


@pytest.mark.parametrize("which", ["tiny", "mini"])
def test_artifact_json_files_equal_jax_s_byte_for_byte(tmp_path, which):
    """config.json, generation_config.json and preprocessor_config.json, and
    each package loads the other's."""
    jc, pc = ((tiny_config(jcfg), tiny_config(pcfg)) if which == "tiny"
              else (jcfg.mini_600m_config(), pcfg.mini_600m_config()))
    gen = dict(max_length=300, top_k=50, guidance_scale=2.0)
    jck.save_model(str(tmp_path / "j"), {"x": np.zeros(2, np.float32)}, jc, jcfg.GenerationConfig(**gen))
    model = pparler.init(0, tiny_config(pcfg), device="cpu")
    ck.save_model(str(tmp_path / "p"), model, pc, pcfg.GenerationConfig(**gen))
    for name in ("config.json", "generation_config.json", "preprocessor_config.json"):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    assert jcfg.ParlerTTSConfig.load(str(tmp_path / "p" / "config.json")) == jc
    assert pcfg.ParlerTTSConfig.load(str(tmp_path / "j" / "config.json")) == pc
    assert pcfg.GenerationConfig.load(str(tmp_path / "j" / "generation_config.json")) == pcfg.GenerationConfig(**gen)
    assert jcfg.GenerationConfig.load(str(tmp_path / "p" / "generation_config.json")) == jcfg.GenerationConfig(**gen)


def test_load_model_is_strict_and_casts(tmp_path):
    art = _artifact(tmp_path / "art")
    model, cfg, gen = ck.load_model(art, device="cpu", dtype=torch.bfloat16)
    assert cfg == tiny_config(pcfg) and gen.bos_token_id == 33
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in model.parameters())
    state = torch.load(os.path.join(art, ck.WEIGHTS_FILE), weights_only=True)
    state.pop("embed_prompts.embedding")
    torch.save(state, os.path.join(art, ck.WEIGHTS_FILE))
    with pytest.raises(RuntimeError, match="embed_prompts"):
        ck.load_model(art, device="cpu")


def test_from_pretrained_speaks_as_a_pipeline_built_from_the_jax_tree(tmp_path):
    """Greedy tts from the artifact equals a pipeline over load_jax_params."""
    jc, pc = tiny_config(jcfg), tiny_config(pcfg)
    params = jax_params(jc, seed=1)
    gen = pcfg.GenerationConfig(max_length=24, do_sample=False, **SPECIALS)
    ck.save_model(str(tmp_path / "art"), port_model(params), pc, gen)
    tok = ToyTokenizer(vocab_size=150)
    pipe = ParlerTTSPipeline.from_pretrained(str(tmp_path / "art"), tokenizer=tok, dtype=torch.float32, device="cpu")
    ref = ParlerTTSPipeline(port_model(params), pc, gen, tok, tok, dtype=torch.float32, device="cpu")
    args = (["a calm voice", "a fast speaker in a room"], ["hello there", "the weather is fine today"])
    (sr_a, wa), (sr_b, wb) = pipe.tts(*args), ref.tts(*args)
    assert sr_a == sr_b and len(wa) == 2 and any(w.size for w in wa)
    for a, b in zip(wa, wb):
        np.testing.assert_array_equal(a, b)


# --- WER and WAV ----------------------------------------------------------------------------


@pytest.mark.parametrize("refs,hyps", [(["Hello, world!"], ["hello world"]), (["a b c d"], ["a x c"]),
                                       (["the cat sat", "on the mat"], ["the cat", "on a mat there"]),
                                       ([""], ["extra words"]), (["Don't stop"], ["dont stop"])])
def test_word_error_rate_matches_jax(refs, hyps):
    assert peval.word_error_rate(refs, hyps) == jeval.word_error_rate(refs, hyps)


def test_metric_hooks_report_unavailable():
    audio = [np.zeros(100, np.float32)]
    wer = peval.WerMetric("distil-whisper/distil-large-v2")(["a"], audio, 44100)
    clap = peval.ClapMetric("laion/larger_clap_music_and_speech")(["a"], audio, 44100)
    assert set(wer) == {"wer", "wer_available"} and wer["wer_available"] == 0.0 and np.isnan(wer["wer"])
    assert set(clap) == {"clap", "clap_available"} and clap["clap_available"] == 0.0 and np.isnan(clap["clap"])


@pytest.mark.parametrize("kind", ["mono", "stereo", "int16"])
def test_wav_bytes_read_and_resample_match_jax(kind):
    rng = np.random.default_rng(8)
    audio = {"mono": 1.3 * rng.standard_normal(1001), "stereo": 0.5 * rng.standard_normal((2, 777)),
             "int16": rng.integers(-32768, 32767, 500)}[kind].astype(np.int16 if kind == "int16" else np.float32)
    data = paudio.wav_bytes(audio, 24000)
    assert data == jaudio.wav_bytes(audio, 24000)
    got, ref = paudio.read_wav(io.BytesIO(data)), jaudio.read_wav(io.BytesIO(data))
    assert got[1] == ref[1] == 24000 and np.array_equal(got[0], ref[0])
    x = got[0]
    np.testing.assert_array_equal(paudio.resample_linear(x, 24000, 44100), jaudio.resample_linear(x, 24000, 44100))


# --- the memory plan ------------------------------------------------------------------------------


def test_memory_plan_on_the_h100():
    mini = pcfg.mini_600m_config()
    assert autotune.memory_limit() == autotune.H100_MEMORY_BYTES
    assert autotune.trainable_decoder_params(mini) == jautotune.trainable_decoder_params(jcfg.mini_600m_config())
    small = autotune.plan_train_memory(mini, per_device_batch=3, fused_len=903)
    assert small.remat is False and small.est_peak_bytes < small.memory_limit_bytes
    big = autotune.plan_train_memory(mini, per_device_batch=64, fused_len=2623)
    assert big.remat is True and autotune.estimate_peak_bytes(
        mini, per_device_batch=64, fused_len=2623, remat=False) > 80e9
    assert big.est_peak_bytes < autotune.estimate_peak_bytes(mini, per_device_batch=64, fused_len=2623, remat=False)
    resolve = lambda gc, policy, b=3: autotune.resolve_train_plan(  # noqa: E731
        mini, per_device_batch=b, fused_len=2623 if b > 3 else 903, gradient_checkpointing=gc,
        gradient_checkpointing_policy=policy)
    assert resolve(None, "auto") is False and resolve(None, "auto", 64) is True
    assert resolve(False, "auto", 64) is False and resolve(True, "auto") is True
    assert resolve(None, "dots") is True and resolve(None, "full") is True and resolve(False, "dots") is False


def test_memory_plan_has_a_fit_for_mini_only():
    """Another config gets no estimate and no recompute, whatever its
    shape, unless the arguments ask for it."""
    dummy = pcfg.dummy_config()
    assert autotune.estimate_peak_bytes(dummy, per_device_batch=512, fused_len=2623, remat=False) is None
    plan = autotune.plan_train_memory(dummy, per_device_batch=512, fused_len=2623)
    assert plan.remat is False and plan.est_peak_bytes is None
    assert autotune.resolve_train_plan(dummy, per_device_batch=512, fused_len=2623, gradient_checkpointing=None,
                                       gradient_checkpointing_policy="dots") is True


# --- model selection and refusals -----------------------------------------------------------------


@pytest.mark.parametrize("name,want", [("dummy", pcfg.dummy_config()), ("", pcfg.mini_600m_config())])
def test_model_from_scratch_and_preprocessing_only(tmp_path, monkeypatch, name, want):
    """Without an artifact dir the CLI builds dummy_config() for "dummy",
    else mini_600m_config(), from the seed; preprocessing_only stops after
    the data (the model is faked: only its config and seed are checked)."""
    built, real_init = [], pparler.init

    def fake_init(seed, cfg, *, device):
        built.append((seed, cfg, str(device)))
        return real_init(0, tiny_config(pcfg), device="cpu")

    monkeypatch.setattr(prun.parler, "init", fake_init)
    out = prun.main(["--model_name_or_path", name, "--train_dataset_name", "synthetic://5", "--seed", "7",
                     "--preprocessing_only", "--output_dir", str(tmp_path)], device="cpu")
    assert out == {"samples": 5} and built == [(7, want, "cpu")]




def test_main_refuses_without_cuda_and_what_is_not_ported(tmp_path, monkeypatch):
    art = _artifact(tmp_path / "art")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prun.main(["--model_name_or_path", art, "--train_dataset_name", "synthetic://4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParlerTTSPipeline.from_pretrained(art, tokenizer=ToyTokenizer())
    with pytest.raises(ImportError, match="`datasets` package"):
        monkeypatch.setitem(sys.modules, "datasets", None)  # as on the card's machine
        _main(art, tmp_path / "o1", "--train_dataset_name", "parler-tts/libritts_r_filtered")
    with pytest.raises(NotImplementedError, match="hub"):
        _main(art, tmp_path / "o2", "--push_to_hub", "true", "--hub_model_id", "me/model")
    with pytest.raises(ValueError, match="model_parallel_size=2 must divide the 1 processes"):
        _main(art, tmp_path / "o3", "--model_parallel_size", "2")
