"""The port's quality gate (``helpers/quality_gate_torch.py``) against the
JAX package's (``helpers/quality_gate.py``) on one tiny reference-format
checkpoint directory (written from random weights, as
``tests/test_torch_from_reference.py`` writes them), both gates with the
toy WordPiece tokenizer of ``tests/fixtures/torch_tokenizers``: the fp32
greedy codes equal, every gate's ``ran`` and ``ok`` verdict the JAX gate's
(the torch reference unavailable to both here, and recorded so), the
stream's token agreement 1.0, and the engine bit for bit against direct
``tts`` wherever JAX's check is conclusive.  Codes: exact; no other number
is compared across the packages (each gate holds its own to the shared
thresholds)."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

import parler_tts_tpu.pipeline  # noqa: F401  imported before the spies: it binds the real generate
import parler_tts_tpu_torch.pipeline  # noqa: F401
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu_torch.generation import generate as pgenerate
from tests import torch_tokenizer_fixtures as fx
from tests.test_torch_from_reference import write_reference_dir

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "helpers", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _spy(module, calls: list):
    """``module.generate`` recording the codes of the gate's first call,
    its fp32 quality path."""
    real = module.generate

    def generate(*args, **kw):
        out = real(*args, **kw)
        if not calls:
            calls.append(np.asarray(out.codes))
        return out
    return real, generate


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    base = tmp_path_factory.mktemp("gate")
    ckpt = str(base / "ckpt")
    write_reference_dir(ckpt, codec="hf_dac", weights="safetensors", norm_form="plain", codec_prefix="audio_encoder")
    tok = os.path.join(fx.FIXTURES, "toy_wordpiece")
    codes = {"jax": [], "port": []}
    out = {}
    for name, module, gate in (("jax", jgenerate, "quality_gate"), ("port", pgenerate, "quality_gate_torch")):
        real, spy = _spy(module, codes[name])
        module.generate = spy
        try:
            kw = {"device": "cpu"} if name == "port" else {}
            out[name] = _load(gate).run_quality_gate(ckpt, batch=2, seed=0, tokenizer_name=tok, **kw)
        finally:
            module.generate = real
    return (out["jax"], out["port"]), codes


def test_fp32_greedy_codes_equal(reports):
    _, codes = reports
    assert codes["jax"] and codes["port"]
    np.testing.assert_array_equal(codes["port"][0], codes["jax"][0])


def test_torch_reference_unavailable_to_both(reports):
    """Without the torch reference on this machine both gates record the
    fp32 gate as not run, with the error, and neither fails for it."""
    (jax_report, port_report), _ = reports
    for report in (jax_report, port_report):
        gate = report["gates"]["fp32_vs_torch"]
        assert gate["ran"] is False and gate["error"]


@pytest.mark.parametrize("gate,verdicts", [("serving_vs_fp32", ("vocoder_mel_ok",)),
                                           ("stream_vs_offline", ("ran", "ok")),
                                           ("serving_engine_vs_direct", ("ran",))])
def test_every_gate_reaches_jax_s_verdict(reports, gate, verdicts):
    (jax_report, port_report), _ = reports
    for key in verdicts:
        assert port_report["gates"][gate][key] == jax_report["gates"][gate][key], (gate, key)
    assert port_report["gates"][gate].keys() == jax_report["gates"][gate].keys()
    assert port_report["pass"] == jax_report["pass"] is True


def test_stream_tokens_agree_fully(reports):
    (jax_report, port_report), _ = reports
    assert jax_report["gates"]["stream_vs_offline"]["token_agreement"] == 1.0
    assert port_report["gates"]["stream_vs_offline"]["token_agreement"] == 1.0


def test_engine_bit_for_bit_where_jax_is_conclusive(reports):
    (jax_report, port_report), _ = reports
    jax_engine, port_engine = (r["gates"]["serving_engine_vs_direct"] for r in (jax_report, port_report))
    assert port_engine["ran"] and jax_engine["ran"]
    if jax_engine["batches"] == 1:
        assert jax_engine["bitwise_equal"]
        assert port_engine["batches"] == 1 and port_engine["bitwise_equal"]
