"""The port's example CLIs on CPU, as a user runs them (mirroring
tests/test_examples.py): a tiny port artifact that carries the toy
WordPiece tokenizer, ``examples/generate_speech_torch.py`` and
``examples/stream_speech_torch.py`` with no ``--tokenizer`` (a playable WAV,
the first equal to a direct ``tts``), ``examples/finetune_torch.py``, and
the card as every example's default."""

from __future__ import annotations

import importlib.util
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from parler_tts_tpu_torch.core import checkpoint as ck
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.utils.audio_io import read_wav, wav_bytes
from parler_tts_tpu_torch.utils.tokenizer import Tokenizer
from tests import torch_tokenizer_fixtures as fx
from tests.test_torch_blocks import tiny_config

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = pathlib.Path(__file__).resolve().parents[1]
SPECIALS = dict(decoder_start_token_id=33, pad_token_id=32, bos_token_id=33, eos_token_id=32)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def artifact(tmp_path_factory) -> str:
    """The tiny model with the LM-head columns of its special ids zeroed and
    greedy decoding, so that random weights decode full length."""
    path = str(tmp_path_factory.mktemp("examples") / "model")
    cfg = tiny_config(pcfg)
    model = pparler.init(0, cfg, device="cpu")
    with torch.no_grad():
        model.decoder.lm_heads.kernel[..., cfg.audio_encoder.codebook_size:] = 0
    ck.save_model(path, model, cfg, pcfg.GenerationConfig(do_sample=False, **SPECIALS),
                  tokenizer=Tokenizer.from_pretrained(os.path.join(fx.FIXTURES, "toy_wordpiece")))
    return path


def _run(monkeypatch, name: str, argv: list[str]):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return _load(name).main()


def test_generate_speech_example_writes_the_pipelines_waveform(artifact, tmp_path, monkeypatch):
    out = str(tmp_path / "out.wav")
    text = ["--description", "a female speaker with a low pitched voice", "--prompt", "hey how are you"]
    _run(monkeypatch, "generate_speech_torch", [artifact, *text, "--max-seconds", "0.02", "--seed", "3",
                                                "--device", "cpu", "--out", out])
    audio, sr = read_wav(out)
    assert sr == 16000 and audio.ndim == 2 and audio.shape[1] > 0 and np.isfinite(audio).all()
    pipe = ParlerTTSPipeline.from_pretrained(artifact, device="cpu")
    _, (wav,) = pipe.tts(text[1], text[3], seed=3, max_seconds=0.02)
    assert open(out, "rb").read() == wav_bytes(wav, sr)


def test_stream_speech_example_writes_every_chunk(artifact, tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "stream.wav")
    _run(monkeypatch, "stream_speech_torch", [artifact, "--max-seconds", "0.03", "--chunk-frames", "20",
                                              "--device", "cpu", "--out", out])
    audio, sr = read_wav(out)
    assert sr == 16000 and audio.shape[1] > 0 and np.isfinite(audio).all()
    printed = capsys.readouterr().out
    assert printed.count("chunk:") >= 2 and "(final)" in printed


def test_finetune_example_trains_and_saves_the_tokenizer(artifact, tmp_path):
    out = str(tmp_path / "run")
    result = _load("finetune_torch").main(["--model_name_or_path", artifact, "--train_dataset_name", "synthetic://8",
                                           "--output_dir", out, "--max_steps", "2", "--per_device_train_batch_size",
                                           "2", "--save_steps", "0", "--dtype", "float32", "--device", "cpu"])
    assert result["steps"] == 2
    final = os.path.join(out, "final")
    assert Tokenizer.from_pretrained(final)("hey how are you").input_ids == Tokenizer.from_pretrained(
        artifact)("hey how are you").input_ids


@pytest.mark.parametrize("name", ["generate_speech_torch", "stream_speech_torch", "finetune_torch"])
def test_the_examples_run_on_the_card_by_default(artifact, tmp_path, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if name == "finetune_torch":
            _load(name).main(["--model_name_or_path", artifact, "--train_dataset_name", "synthetic://4",
                              "--output_dir", str(tmp_path)])
        else:
            _run(monkeypatch, name, [artifact, "--out", str(tmp_path / "x.wav")])
