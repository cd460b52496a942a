"""HF dataset preparation for the port's training CLI against the JAX
package, at fp32 on CPU: ``load_multiple_datasets`` and ``prepare_hf`` on
local ``Dataset.from_dict(...).save_to_disk`` corpora (a plain-dict audio
column, as ``tests/test_multihost.py`` builds them; the tiny codec at
16 kHz), two specs concatenated and interleaved, a metadata side-dataset,
the filters, the ``CodesCache`` re-run; the CLI's losses from such a corpus
against the JAX CLI's, with the prompt tokenizer in its final artifact; and
a JAX artifact carrying its tokenizer through ``tools/convert_jax_artifact.py``
to the port's ``from_pretrained``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import shutil
import sys
import types

import datasets as hfds
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import AutoTokenizer

from parler_tts_tpu import pipeline as jpipeline
from parler_tts_tpu.core import checkpoint as jck
from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu.training import args as jargs
from parler_tts_tpu.training import data as jdata
from parler_tts_tpu.training import run_training as jrun
from parler_tts_tpu.utils.toy_tokenizer import build_toy_tokenizer
from parler_tts_tpu_torch import pipeline as ppipeline
from parler_tts_tpu_torch.core import checkpoint as ck
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.training import args as pargs
from parler_tts_tpu_torch.training import data as pdata
from parler_tts_tpu_torch.training import run_training as prun
from parler_tts_tpu_torch.utils.tokenizer import Tokenizer
from tests import torch_tokenizer_fixtures as fx
from tests.test_torch_blocks import jax_params, port_model, tiny_config
from tests.test_torch_train import LOSS_TOL

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 16000  # the tiny codec's rate: no resampling
SPECIALS = dict(decoder_start_token_id=33, pad_token_id=32, bos_token_id=33, eos_token_id=32)
# the filters: rows of 0.01-0.12 s (at most 246 label positions: the tiny
# decoder has 256), descriptions of at most 60 characters and 12 tokens,
# prompts of at most 10 tokens
FILTERS = dict(target_audio_column_name="audio_raw", min_duration_in_seconds=0.01, max_duration_in_seconds=0.12,
               max_text_length=60, max_description_token_length=12, max_prompt_token_length=10,
               audio_encoder_batch_size=3)
FILTER_FLAGS = [x for k, v in FILTERS.items() for x in (f"--{k}", str(v))]


def _rows(n: int, seed: int, *, description: bool = True) -> dict:
    """``n`` rows of 0.03-0.1 s of seeded noise; row 1 lasts 0.2 s, row 2
    0.005 s, row 3 has a 70-character description and row 4 a 14-token
    prompt (each one filtered out)."""
    rng = np.random.default_rng(seed)
    seconds = rng.uniform(0.03, 0.1, n)
    seconds[1], seconds[2] = 0.2, 0.005
    rows = {
        "audio_raw": [{"array": (0.3 * rng.standard_normal(int(SR * s))).astype(np.float32), "sampling_rate": SR}
                      for s in seconds],
        "text": [f"hey how are you doing today {i}" if i != 4 else "hey " * 14 for i in range(n)],
        "id": [f"row{seed}_{i}" for i in range(n)],
    }
    descriptions = [f"a female speaker with a low pitched voice {i}" for i in range(n)]
    descriptions[3] = "a male speaker with a deep voice speaks very fast in a quiet room here"
    if description:
        rows["description"] = descriptions
    return rows, descriptions


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> dict[str, str]:
    """Corpus ``a`` (12 rows, 8 kept); corpus ``b`` (7 rows, 3 kept; its
    descriptions in the metadata side-dataset ``b_meta``, aligned by id);
    the toy WordPiece."""
    base = tmp_path_factory.mktemp("prepare_hf")
    rows_a, _ = _rows(12, 0)
    hfds.Dataset.from_dict(rows_a).save_to_disk(str(base / "a"))
    rows_b, desc_b = _rows(7, 1, description=False)
    hfds.Dataset.from_dict(rows_b).save_to_disk(str(base / "b"))
    hfds.Dataset.from_dict({"id": rows_b["id"], "description": desc_b}).save_to_disk(str(base / "b_meta"))
    shutil.copytree(os.path.join(fx.FIXTURES, "toy_wordpiece"), base / "tok")
    return {k: str(base / k) for k in ("a", "b", "b_meta", "tok")}


@pytest.fixture(scope="module")
def models():
    params = jax_params(tiny_config(jcfg), seed=5)
    return params, port_model(params)


def _args(corpus, **data) -> tuple:
    data = {**FILTERS, **data}
    model = dict(model_name_or_path=corpus["tok"], description_tokenizer_name=corpus["tok"],
                 prompt_tokenizer_name=corpus["tok"])
    return (jargs.DataTrainingArguments(**data), jargs.ModelArguments(**model),
            pargs.DataTrainingArguments(**data), pargs.ModelArguments(**model))


def _spy(monkeypatch, module) -> list[int]:
    """Waveforms passed to ``module.tokenize_audio_batches``."""
    seen, real = [], module.tokenize_audio_batches

    def spy(codec, codec_cfg, arrays, **kw):
        seen.extend(len(a) for a in arrays)
        return real(codec, codec_cfg, arrays, **kw)
    monkeypatch.setattr(module, "tokenize_audio_batches", spy)
    return seen


def _assert_same_samples(got: list[dict], ref: list[dict]) -> None:
    """``_idx``, ids, texts and labels equal; a code unlike JAX's would show
    in the labels (none is: these encodes have no near-tie)."""
    assert [s["_idx"] for s in got] == [s["_idx"] for s in ref]
    differing = 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["input_ids"], r["input_ids"])
        np.testing.assert_array_equal(g["prompt_input_ids"], r["prompt_input_ids"])
        assert (g["prompt_text"], g["description_text"]) == (r["prompt_text"], r["description_text"])
        assert g["labels"].shape == r["labels"].shape
        differing += int((np.asarray(g["labels"]) != np.asarray(r["labels"])).sum())
    assert differing == 0


# --- load_multiple_datasets ------------------------------------------------------------------------------


@pytest.mark.parametrize("streaming,samples", [(False, None), (False, "4+3"), (True, None), (True, "2+1")])
def test_load_multiple_datasets_matches_jax(corpus, streaming, samples):
    specs_kw = dict(names=f"{corpus['a']}+{corpus['b']}", metadata_names=f"+{corpus['b_meta']}",
                    samples_counts=samples)
    kw = dict(sampling_rate=SR, streaming=streaming, seed=0)
    ref = jdata.load_multiple_datasets(jdata.parse_dataset_spec(**specs_kw), **kw)
    got = pdata.load_multiple_datasets(pdata.parse_dataset_spec(**specs_kw), **kw)
    strip = lambda ds: [(r["id"], r["text"], r["description"], len(r["audio_raw"]["array"])) for r in ds]  # noqa: E731
    assert strip(got) == strip(ref) and len(strip(got)) >= 6


def test_metadata_ids_must_align(corpus, tmp_path):
    rows = {"id": ["other"] * 7, "description": ["x"] * 7}
    hfds.Dataset.from_dict(rows).save_to_disk(str(tmp_path / "meta"))
    specs = pdata.parse_dataset_spec(corpus["b"], metadata_names=str(tmp_path / "meta"))
    with pytest.raises(ValueError, match="metadata id mismatch"):
        pdata.load_multiple_datasets(specs)


def test_without_datasets_the_loader_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="`datasets` package"):
        pdata.load_multiple_datasets(pdata.parse_dataset_spec("anything"))


# --- prepare_hf -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("streaming", [False, True])
def test_prepare_hf_matches_jax_and_its_cache_encodes_nothing(corpus, models, monkeypatch, tmp_path, streaming):
    """Two specs (concatenated, or interleaved as streams), the second's
    descriptions from its metadata side-dataset; the filters drop 4 rows of
    each; each kept row is encoded once, and the re-run reads every code
    from the ``CodesCache``."""
    params, model = models
    jd, jm, pd, pm = _args(corpus, train_dataset_name=f"{corpus['a']}+{corpus['b']}",
                           train_metadata_dataset_name=f"+{corpus['b_meta']}", streaming=streaming,
                           temporary_save_to_disk=str(tmp_path / "codes"))
    max_samples = 17 if streaming else None
    port_seen, jax_seen = _spy(monkeypatch, pdata), _spy(monkeypatch, jdata)
    got = prun.prepare_hf(pd, pm, tiny_config(pcfg), model.audio_encoder, max_samples=max_samples)
    jd = dataclasses.replace(jd, temporary_save_to_disk=str(tmp_path / "jax_codes"))
    ref = jrun.prepare_hf(jd, jm, tiny_config(jcfg), params["audio_encoder"], max_samples=max_samples)
    _assert_same_samples(got, ref)
    assert len(got) == (6 if streaming else 11) and sorted(port_seen) == sorted(jax_seen)
    assert len(port_seen) == len(got) and all("a female speaker" in s["description_text"] for s in got)
    port_seen.clear()
    again = prun.prepare_hf(pd, pm, tiny_config(pcfg), model.audio_encoder, max_samples=max_samples)
    assert port_seen == []
    _assert_same_samples(again, got)
    # the port's cache parts are the JAX package's: JAX reads them and encodes nothing either
    jax_seen.clear()
    jd = dataclasses.replace(jd, temporary_save_to_disk=str(tmp_path / "codes"))
    _assert_same_samples(jrun.prepare_hf(jd, jm, tiny_config(jcfg), params["audio_encoder"],
                                         max_samples=max_samples), got)
    assert jax_seen == []


def test_prepare_rows_shards_before_any_work(corpus, models, monkeypatch):
    """Process 1 of 2 takes the odd raw rows, before the filters and the
    codec; together the two shares are the single-process preparation (one
    waveform per encode, so that no share pads a waveform as another
    batch would, which could move a near-tie).  A row at another sampling
    rate than the codec's raises."""
    _, model = models
    _, _, pd, pm = _args(corpus, train_dataset_name=corpus["a"], audio_encoder_batch_size=1)
    rows = list(pdata.load_multiple_datasets(pdata.parse_dataset_spec(corpus["a"])))
    tok = Tokenizer.from_pretrained(corpus["tok"])
    cfg = tiny_config(pcfg)
    seen = _spy(monkeypatch, pdata)
    whole = prun.prepare_rows(rows, pd, cfg, model.audio_encoder, tok, tok)
    n_whole = len(seen)
    seen.clear()
    shares = [prun.prepare_rows(rows, pd, cfg, model.audio_encoder, tok, tok, process_index=i, process_count=2)
              for i in range(2)]
    assert len(seen) == n_whole == len(whole) == 8
    assert [s["_idx"] % 2 for s in shares[1]] == [1] * len(shares[1])
    _assert_same_samples(sorted(shares[0] + shares[1], key=lambda s: s["_idx"]), whole)
    rows[5]["audio_raw"]["sampling_rate"] = 44100
    with pytest.raises(ValueError, match="row 5: audio at 44100 Hz, the codec takes 16000 Hz"):
        prun.prepare_rows(rows, pd, cfg, model.audio_encoder, tok, tok)


# --- the CLI ------------------------------------------------------------------------------------------------------


def test_cli_from_a_local_corpus_matches_the_jax_cli(corpus, models, tmp_path):
    """Two steps over corpus ``a`` (8 rows kept; the JAX CLI puts one row on
    each of its 8 CPU devices, the port takes batches of 8), losses and
    gradient norms within the CLI test's tolerances; the final artifact holds
    the prompt tokenizer, which ``from_pretrained`` reads; the prepared
    samples are cached under ``save_to_disk``."""
    params, model = models
    jc, pc = tiny_config(jcfg), tiny_config(pcfg)
    jax_art, port_art = str(tmp_path / "jax_art"), str(tmp_path / "port_art")
    jck.save_model(jax_art, params, jc, jcfg.GenerationConfig(**SPECIALS))
    ck.save_model(port_art, model, pc, pcfg.GenerationConfig(**SPECIALS))
    n_dev = len(jax.devices())
    flags = ["--train_dataset_name", corpus["a"], "--description_tokenizer_name", corpus["tok"],
             "--prompt_tokenizer_name", corpus["tok"], *FILTER_FLAGS, "--max_steps", "2", "--logging_steps", "1",
             "--save_steps", "0", "--dtype", "float32", "--lr_scheduler_type", "constant"]
    jrun.main(["--model_name_or_path", jax_art, "--output_dir", str(tmp_path / "jax_out"),
               "--per_device_train_batch_size", "1", *flags])
    port_argv = ["--model_name_or_path", port_art, "--output_dir", str(tmp_path / "port_out"),
                 "--per_device_train_batch_size", str(n_dev), "--save_to_disk", str(tmp_path / "prepared"), *flags]
    out = prun.main(port_argv, device="cpu")
    records = lambda d: [json.loads(x) for x in open(d / "metrics.jsonl") if "train/loss" in x]  # noqa: E731
    got, ref = records(tmp_path / "port_out"), records(tmp_path / "jax_out")
    assert out["steps"] == 2 and [r["step"] for r in got] == [r["step"] for r in ref] == [1, 2]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["train/loss"], r["train/loss"], atol=LOSS_TOL, rtol=0)
        np.testing.assert_allclose(g["train/grad_norm"], r["train/grad_norm"], rtol=1e-5)
    final = tmp_path / "port_out" / "final"
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"):
        assert (final / name).read_bytes() == (pathlib.Path(corpus["tok"]) / name).read_bytes()
    pipe = ppipeline.ParlerTTSPipeline.from_pretrained(str(final), dtype=torch.float32, device="cpu")
    want = AutoTokenizer.from_pretrained(str(tmp_path / "jax_out" / "final"))
    text = "a female speaker with a low pitched voice"
    assert pipe.description_tokenizer(text).input_ids == want(text).input_ids
    # the prepared samples were cached: reading them prepares nothing (no codec is given)
    model_args, data_args, _ = pargs.parse_args(port_argv)
    assert len(prun._load_or_prepare(data_args, model_args, pc, split="train")) == 8


# --- the artifact's own tokenizer -------------------------------------------------------------------------------


def _script(relpath: str):
    spec = importlib.util.spec_from_file_location(pathlib.Path(relpath).stem, REPO / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_a_converted_jax_artifact_speaks_with_its_own_tokenizer(tmp_path, monkeypatch):
    """A JAX artifact saved with the toy WordPiece, converted: the port's
    ``from_pretrained`` with no tokenizer argument gives the JAX pipeline's
    ids, greedy tokens and waveforms."""
    jc = tiny_config(jcfg)
    gen = jcfg.GenerationConfig(max_length=18, do_sample=False, **SPECIALS)
    params = jax_params(jc, seed=6)
    src, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_model(src, params, jc, gen, tokenizer=build_toy_tokenizer())
    assert _script("tools/convert_jax_artifact.py").main([src, out]) == 0
    pipe = ppipeline.ParlerTTSPipeline.from_pretrained(out, dtype=torch.float32, device="cpu")
    jpipe = jpipeline.ParlerTTSPipeline.from_pretrained(src, dtype=jnp.float32)
    assert isinstance(pipe.description_tokenizer, Tokenizer)
    descs = ["a female speaker with a low pitched voice", "clear audio"]
    prompts = ["hey how are you doing today", "hey there"]
    ids = pipe.tokenize(descs, prompts)
    jax_ids = ppipeline.ParlerTTSPipeline.tokenize(types.SimpleNamespace(
        description_tokenizer=jpipe.description_tokenizer, prompt_tokenizer=jpipe.prompt_tokenizer), descs, prompts)
    for k in ids:
        np.testing.assert_array_equal(ids[k], jax_ids[k])
    tokens = []
    real = ppipeline.generate

    def spy(*args, **kw):
        result = real(*args, **kw)
        tokens.append(result.tokens.numpy())
        return result
    monkeypatch.setattr(ppipeline, "generate", spy)
    _, wavs = pipe.tts(descs, prompts)
    ref = jgenerate.generate(jpipe.params, jc, gen, key=jax.random.PRNGKey(0), dtype=jnp.float32, **ids)
    np.testing.assert_array_equal(tokens[0], np.asarray(ref.tokens))
    _, jwavs = jpipe.tts(descs, prompts)
    for w, j in zip(wavs, jwavs):
        assert w.shape == j.shape
        np.testing.assert_allclose(w, j, atol=1e-4, rtol=0)


def test_from_pretrained_tokenizer_choices(tmp_path):
    """``tokenizer_name`` names another directory; an artifact with
    ``spiece.model`` but no ``tokenizer.json`` raises, naming the file; one
    with no tokenizer file serves no text."""
    art = str(tmp_path / "art")
    ck.save_model(art, port_model(jax_params(tiny_config(jcfg))), tiny_config(pcfg),
                  pcfg.GenerationConfig(**SPECIALS))
    pipe = ppipeline.ParlerTTSPipeline.from_pretrained(art, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="needs a description and a prompt tokenizer"):
        pipe.tts("a voice", "hello")
    named = ppipeline.ParlerTTSPipeline.from_pretrained(art, tokenizer_name=os.path.join(fx.FIXTURES,
                                                                                        "toy_wordpiece"),
                                                        dtype=torch.float32, device="cpu")
    assert named.tts("a voice", "hello", max_seconds=0.01)[1][0].size > 0
    (tmp_path / "art" / "spiece.model").write_bytes(b"sentencepiece")
    with pytest.raises(FileNotFoundError, match=r"tokenizer\.json"):
        ppipeline.ParlerTTSPipeline.from_pretrained(art, dtype=torch.float32, device="cpu")
