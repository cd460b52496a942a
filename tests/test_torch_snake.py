"""K6, the DAC decoder's Snake on the card (``ops/snake.py``,
``csrc/snake.cu``): what stays on the CPU and at other dtypes (the plain
functions, unchanged, with no launch counted), the wrapper's refusals before
any library is loaded, and the build's route to ``csrc/snake.cu``.  The kernel
itself is checked bit for bit against ``snake_fast`` on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

from __future__ import annotations

import shutil
import subprocess

import pytest
import torch

from parler_tts_tpu_torch.core import graphs as pgraphs
from parler_tts_tpu_torch.core.config import DACConfig
from parler_tts_tpu_torch.models import dac as pdac
from parler_tts_tpu_torch.ops import cuda_build
from parler_tts_tpu_torch.ops import snake as psnake

torch.set_num_threads(1)  # tier-1 runs several pytest workers


def _inputs(dtype, c: int = 6, t: int = 13):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((2, c, t), generator=gen) * 3).to(dtype)
    alpha = torch.randn(c, generator=gen).abs() + 0.1
    return x, alpha


@pytest.mark.parametrize("fast,dtype,plain", [
    (True, torch.bfloat16, pdac.snake_fast),  # the decoder's bf16 Snake on the CPU
    (True, torch.float32, pdac.snake),  # an fp32 decoder
    (False, torch.bfloat16, pdac.snake),  # the encoder's exact Snakes
    (False, torch.float32, pdac.snake),
])
def test_snake_off_the_card_is_the_plain_function(monkeypatch, fast, dtype, plain):
    before = pgraphs.launches()["snake"]
    monkeypatch.setattr(pdac, "snake_fast_cuda", lambda *a: pytest.fail("K6 called off the card"))
    x, alpha = _inputs(dtype)
    module = pdac.Snake(x.shape[1], fast=fast)
    with torch.no_grad():
        module.alpha.copy_(alpha)
        got = module(x)
    assert got.dtype == dtype
    assert torch.equal(got, plain(x, module.alpha))
    assert pgraphs.launches()["snake"] == before


def test_a_bf16_dac_decode_on_the_cpu_runs_29_plain_snakes_a_call(monkeypatch):
    """Mini's decoder layout (four blocks of a Snake and three residual units
    of two, then the last Snake) at narrow widths: 29 ``snake_fast`` calls per
    ``decode``, none of them K6."""
    calls = []
    plain = pdac.snake_fast
    monkeypatch.setattr(pdac, "snake_fast", lambda x, a: calls.append(x.shape) or plain(x, a))
    before = pgraphs.launches()["snake"]
    cfg = DACConfig(codebook_size=64, latent_dim=32, decoder_hidden_size=32, encoder_hidden_size=8)
    codec = pdac.DAC(cfg)
    codec.reset_parameters(torch.Generator().manual_seed(0))
    codec = codec.to(torch.bfloat16)
    codes = torch.randint(0, cfg.codebook_size, (2, cfg.num_codebooks, 3))
    with torch.no_grad():
        wave = codec.decode(codes)
    assert wave.shape == (2, 3 * cfg.hop_length) and bool(torch.isfinite(wave).all())
    assert len(calls) == 29 and pgraphs.launches()["snake"] == before
    assert calls[0] == (2, 32, 3) and calls[-1] == (2, 2, 3 * cfg.hop_length)


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA tensors"),
    ("fp32", TypeError, "bf16"),
    ("non_contiguous", ValueError, "contiguous"),
    ("two_dims", ValueError, r"\(B, C, T\)"),
    ("four_dims", ValueError, r"\(B, C, T\)"),
    ("alpha_shape", ValueError, "alpha"),
    ("needs_grad", RuntimeError, "no backward"),
])
def test_wrapper_refuses_before_loading_a_library(monkeypatch, case, error, match):
    monkeypatch.setattr(cuda_build, "library", lambda *a, **k: pytest.fail("a library was loaded"))
    before = pgraphs.launches()["snake"]
    x, alpha = _inputs(torch.bfloat16)
    if case == "fp32":
        x = x.float()
    elif case == "non_contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "two_dims":
        x = x[0]
    elif case == "four_dims":
        x = x[None]
    elif case == "alpha_shape":
        alpha = alpha[:-1]
    elif case == "needs_grad":
        alpha = alpha.requires_grad_()
    with pytest.raises(error, match=match):
        psnake.snake_fast_cuda(x, alpha, pdac._SIN2_COEFFS)
    assert pgraphs.launches()["snake"] == before


def test_the_build_takes_snake_from_csrc(monkeypatch, tmp_path):
    """``library("snake")`` resolves to ``libsnake.so`` under a hash that
    covers ``csrc/snake.cu``, and is compiled from that source."""
    lib = cuda_build._library_path("snake")
    assert lib.name == "libsnake.so" and lib.parent.parent == cuda_build.BUILD_ROOT
    assert (cuda_build.CSRC / "snake.cu").is_file()
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    assert cuda_build._library_path("snake", copy) == lib
    (copy / "snake.cu").write_text((copy / "snake.cu").read_text() + "\n// edited\n")
    assert cuda_build._library_path("snake", copy) != lib

    started = []

    class Proc:
        returncode = 1

        def __init__(self, cmd, **kw):
            started.append(cmd)

        def communicate(self):
            return "stand-in compiler", None

    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Proc)
    with pytest.raises(RuntimeError, match="snake: nvcc exited 1"):
        cuda_build.build(["snake"], copy)
    assert len(started) == 1 and started[0][-1] == str(copy / "snake.cu")
    assert "arch=compute_90a,code=sm_90a" in started[0]
