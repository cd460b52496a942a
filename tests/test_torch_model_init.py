"""The port's model-init scripts (``helpers/model_init_scripts/*_torch.py``)
against the JAX package's, each run as a user runs it, in a subprocess:

* ``init_dummy_model`` and ``init_dummy_model_with_encodec``: the
  artifacts' ``config.json`` and ``generation_config.json`` byte for byte
  the JAX scripts'; the parameters' names and shapes those of
  ``models/parler.init``'s model (and its values, from the same seed); the
  decoder's weights drawn with ``initializer_factor`` as their standard
  deviation, within five standard errors of the sample estimate;
* ``init_model_600M``'s import path at the dummy geometry (both scripts'
  ``mini_600m_config`` replaced by ``dummy_config``: Mini's DAC and a
  2-layer 64-wide T5): HF ``T5EncoderModel`` and ``DacModel`` directories
  written from random weights, with the toy WordPiece tokenizer beside the
  T5; both artifacts' JSON files byte for byte equal, the tokenizer
  bundled, and the port artifact's T5 and DAC tensors bit for bit those
  that ``transformers``' own loading of the directories imports to; a
  directory of another geometry is refused.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from parler_tts_tpu_torch.core import checkpoint as ck
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core import torch_import as ti
from parler_tts_tpu_torch.models import codec as codec_mod
from parler_tts_tpu_torch.models import parler
from tests import torch_tokenizer_fixtures as fx

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "helpers", "model_init_scripts")
DUMMIES = ("init_dummy_model", "init_dummy_model_with_encodec")
JSON_FILES = ("config.json", "generation_config.json")
# the JAX 600M script at the dummy geometry (its mini_600m_config replaced)
JAX_AT_DUMMY = ("import runpy, sys\n"
                "import parler_tts_tpu.core.config as c\n"
                "c.mini_600m_config = c.dummy_config\n"
                f"runpy.run_path({os.path.join(SCRIPTS, 'init_model_600M.py')!r}, run_name='__main__')\n")
TIMEOUT = 300


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _hf_dirs(base) -> tuple[str, str]:
    """A random ``T5EncoderModel`` at the dummy config's T5 geometry (with
    the toy tokenizer's files) and a random ``DacModel`` at Mini's DAC
    geometry, as ``save_pretrained`` writes them."""
    from transformers import DacConfig, DacModel, T5Config, T5EncoderModel

    te = pcfg.dummy_config().text_encoder
    torch.manual_seed(0)
    t5_dir, dac_dir = str(base / "t5"), str(base / "dac")
    T5EncoderModel(T5Config(vocab_size=te.vocab_size, d_model=te.d_model, d_kv=te.d_kv, d_ff=te.d_ff,
                            num_layers=te.num_layers, num_heads=te.num_heads, feed_forward_proj="gated-gelu",
                            dropout_rate=0.0)).save_pretrained(t5_dir)
    shutil.copytree(os.path.join(fx.FIXTURES, "toy_wordpiece"), t5_dir, dirs_exist_ok=True)
    DacModel(DacConfig(sampling_rate=44100)).save_pretrained(dac_dir)
    return t5_dir, dac_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every script at once, each in its own process: the JAX and port
    dummy scripts, and the JAX 600M script at the dummy geometry; then the
    port's 600M script at that geometry in this process."""
    base = tmp_path_factory.mktemp("init")
    t5_dir, dac_dir = _hf_dirs(base)
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    cmds = {}
    for name in DUMMIES:
        cmds[f"jax/{name}"] = [os.path.join(SCRIPTS, f"{name}.py"), str(base / "jax" / name)]
        cmds[f"port/{name}"] = [os.path.join(SCRIPTS, f"{name}_torch.py"), str(base / "port" / name), "--device", "cpu"]
    cmds["jax/600M"] = ["-c", JAX_AT_DUMMY, str(base / "jax" / "600M"), "--text-encoder", t5_dir, "--dac", dac_dir]
    procs = {k: subprocess.Popen([sys.executable, *cmd], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for k, cmd in cmds.items()}
    try:
        script = _load("init_model_600M_torch")
        script.mini_600m_config = pcfg.dummy_config
        script.main([str(base / "port" / "600M"), "--text-encoder", t5_dir, "--dac", dac_dir, "--device", "cpu"])
        outs = {k: p.communicate(timeout=TIMEOUT)[0].decode(errors="replace") for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k} failed:\n{outs[k][-4000:]}"
    return {"base": base, "t5": t5_dir, "dac": dac_dir, "script": script}


@pytest.mark.parametrize("fname", JSON_FILES)
@pytest.mark.parametrize("name", [*DUMMIES, "600M"])
def test_json_files_are_the_jax_script_s_byte_for_byte(runs, name, fname):
    with open(runs["base"] / "jax" / name / fname, "rb") as a, open(runs["base"] / "port" / name / fname, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", DUMMIES)
def test_parameters_are_parler_init_s(runs, name):
    """Names and shapes of ``parler.init``'s model, and its values: the
    same seed draws the same weights."""
    model, cfg, _ = ck.load_model(str(runs["base"] / "port" / name), device="cpu")
    want = parler.init(0, cfg, device="cpu").state_dict()
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("name", DUMMIES)
def test_decoder_weights_have_the_initializer_s_std(runs, name):
    """Every decoder kernel and the embedding tables ~ N(0, initializer_factor):
    the sample std within 5 standard errors (std / sqrt(2n)), the mean
    within 5 std / sqrt(n); layer norms ones and zeros."""
    model, cfg, _ = ck.load_model(str(runs["base"] / "port" / name), device="cpu")
    std = cfg.decoder.initializer_factor
    drawn = [p.flatten().double() for n, p in model.decoder.named_parameters()
             if not n.endswith((".scale", ".bias"))]
    x = torch.cat(drawn)
    n = x.numel()
    assert abs(float(x.std()) - std) < 5 * std / np.sqrt(2 * n)
    assert abs(float(x.mean())) < 5 * std / np.sqrt(n)
    for name_, p in model.decoder.named_parameters():
        if name_.endswith(".scale"):
            assert torch.all(p == 1.0), name_
        elif name_.endswith(".bias"):
            assert torch.all(p == 0.0), name_


def test_600m_import_path_gives_transformers_tensors_and_the_tokenizer(runs):
    """The port artifact's T5 and DAC: bit for bit what ``transformers``'
    ``from_pretrained`` of the same directories imports to; the toy
    tokenizer bundled in both artifacts."""
    from transformers import DacModel, T5EncoderModel

    model, cfg, _ = ck.load_model(str(runs["base"] / "port" / "600M"), device="cpu")
    t5 = ti.import_t5_encoder(T5EncoderModel.from_pretrained(runs["t5"]).state_dict(), cfg.text_encoder.num_layers)
    dac = codec_mod.import_torch(DacModel.from_pretrained(runs["dac"]).state_dict(), cfg.audio_encoder)
    for part, want in (("text_encoder", t5), ("audio_encoder", dac)):
        got = getattr(model, part).state_dict()
        assert got.keys() == want.keys(), part
        for k, v in want.items():
            assert torch.equal(got[k], v.float()), (part, k)
    for side in ("jax", "port"):
        assert os.path.exists(runs["base"] / side / "600M" / "tokenizer.json"), side


def test_600m_import_refuses_another_geometry(runs):
    """Mini's geometry against the dummy-geometry directories: both raise,
    naming the fields that differ."""
    script, cfg = runs["script"], pcfg.mini_600m_config()
    with torch.device("meta"):
        model = parler.ParlerTTSModel(cfg)
    with pytest.raises(ValueError, match="T5 encoder is not the model's geometry: d_model 64 \\(want 768\\)"):
        script.import_text_encoder(model, cfg, runs["t5"])
    small = pcfg.ParlerTTSConfig.from_dict({**cfg.to_dict(), "audio_encoder": {
        **cfg.audio_encoder.to_dict(), "codebook_dim": 4}})
    with pytest.raises(ValueError, match="DAC is not the model's geometry: codebook_dim 8 \\(want 4\\)"):
        script.import_dac(model, small, runs["dac"])
