"""The two converters into the port's model artifact, on CPU:
``helpers/convert_reference_checkpoint_torch.py`` (a reference checkpoint
directory) and ``tools/convert_jax_artifact.py`` (a JAX package artifact).
Each artifact is served by ``ParlerTTSPipeline.from_pretrained`` with the
tokens of the model it came from."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import checkpoint as jax_checkpoint
from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core.from_reference import from_reference_pretrained
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer
from tests.test_torch_blocks import jax_params, tiny_config
from tests.test_torch_encodec_composite import composite_config
from tests.test_torch_from_reference import SPECIAL_IDS, write_reference_dir

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = pathlib.Path(__file__).resolve().parents[1]


def _script(relpath: str):
    spec = importlib.util.spec_from_file_location(pathlib.Path(relpath).stem, REPO / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _batch(vocab: int):
    rng = np.random.default_rng(4)
    return dict(input_ids=rng.integers(0, vocab, (2, 6)), prompt_input_ids=rng.integers(0, vocab, (2, 4)))


def test_reference_dir_to_port_artifact(tmp_path):
    """Tokens of the served artifact equal the in-memory import's, the
    pipeline's waveforms too, and the source's tokenizer and feature-extractor
    files are carried over (its preprocessor_config.json replacing the one
    ``save_model`` writes)."""
    src, out = str(tmp_path / "ref"), str(tmp_path / "port")
    write_reference_dir(src, codec="encodec", weights="sharded", norm_form="parametrizations",
                        codec_prefix="audio_encoder")
    side = {"tokenizer.json": '{"version": "1.0"}', "spiece.model": "spm", "preprocessor_config.json": '{"a": 1}'}
    for name, text in side.items():
        pathlib.Path(src, name).write_text(text)
    assert _script("helpers/convert_reference_checkpoint_torch.py").main([src, out, "--device", "cpu"]) == 0
    for name, text in side.items():
        assert pathlib.Path(out, name).read_text() == text
    assert json.loads(pathlib.Path(out, "config.json").read_text())["audio_encoder"]["codec_type"] == "encodec"

    model, cfg, gen = from_reference_pretrained(src, device="cpu")
    tok = ToyTokenizer(vocab_size=cfg.vocab_size)
    pipe = ParlerTTSPipeline.from_pretrained(out, tokenizer=tok, dtype=torch.float32, device="cpu")
    assert pipe.cfg == cfg and pipe.gen == gen
    greedy = dataclasses.replace(gen, do_sample=False)
    ref = pgenerate.generate(model, greedy, device="cpu", **_batch(cfg.vocab_size))
    got = pgenerate.generate(pipe.model, greedy, device="cpu", **_batch(cfg.vocab_size))
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    direct = ParlerTTSPipeline(model, cfg, gen, tok, tok, dtype=torch.float32, device="cpu")
    texts = (["a calm voice", "fast"], ["hey how are you", "fine"])
    for a, b in zip(pipe.tts(*texts, seed=1, max_seconds=0.1)[1], direct.tts(*texts, seed=1, max_seconds=0.1)[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("codec", ["dac", "encodec"])
def test_jax_artifact_to_port_artifact(tmp_path, codec):
    """A JAX artifact (JAX ``save_model``) converted and served by the port
    gives JAX ``generate``'s greedy tokens."""
    jax_cfg = tiny_config(jcfg) if codec == "dac" else composite_config(jcfg)
    jax_gen = jcfg.GenerationConfig(max_length=18, do_sample=False, **SPECIAL_IDS)
    params = jax_params(jax_cfg, seed=2)
    src, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_checkpoint.save_model(src, params, jax_cfg, jax_gen)
    assert _script("tools/convert_jax_artifact.py").main([src, out]) == 0

    pipe = ParlerTTSPipeline.from_pretrained(out, dtype=torch.float32, device="cpu")
    assert pipe.cfg.to_dict() == jax_cfg.to_dict()
    assert pipe.gen == pcfg.GenerationConfig(max_length=18, do_sample=False, **SPECIAL_IDS)
    vocab = jax_cfg.vocab_size
    ref = jgenerate.generate(params, jax_cfg, jax_gen, key=jax.random.PRNGKey(0), vocode=False, **_batch(vocab))
    got = pgenerate.generate(pipe.model, pipe.gen, vocode=False, device="cpu", **_batch(vocab))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
