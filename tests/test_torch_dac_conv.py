"""K7, the DAC decoder's stride-1 convolutions on the card (``ops/dac_conv.py``,
``csrc/dac_conv.cu``): the plain function against ``nn.Conv1d`` with its bias
and the residual add and against a float64 sum over the taps, the wrapper's
refusals before any library is loaded, the build's route to
``csrc/dac_conv.cu``, and a bf16 decode on the CPU that keeps ``nn.Conv1d``
and returns what the decoder returned before K7.  The kernel itself is
checked against an fp32 reference on the card by tests/test_torch_cuda.py
and chip_smoke.py."""

from __future__ import annotations

import shutil
import subprocess

import pytest
import torch
from torch import nn

from parler_tts_tpu_torch.core import graphs as pgraphs
from parler_tts_tpu_torch.core.config import DACConfig
from parler_tts_tpu_torch.models import dac as pdac
from parler_tts_tpu_torch.ops import cuda_build
from parler_tts_tpu_torch.ops import dac_conv as pconv

torch.set_num_threads(1)  # tier-1 runs several pytest workers

U = 2.0**-8  # a bf16 rounding, relative


def _conv(c_in, c_out, k, d, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    conv = nn.Conv1d(c_in, c_out, k, dilation=d, padding=(k - 1) // 2 * d)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * (c_in * k) ** -0.5)
        conv.bias.copy_(torch.randn(c_out, generator=gen) * 0.1)
    return conv.to(dtype).requires_grad_(False)


def _taps_sum(x, weight, bias, d, residual=None):
    """float64: bias + sum over taps j of weight[:, :, j] @ x shifted by
    (j - (k - 1) / 2) * d, zero outside the row; and the same over the terms'
    sizes."""
    k = weight.shape[-1]
    x64, w64 = x.double(), weight.double()
    b, _, t = x.shape
    y = bias.double()[None, :, None].expand(b, -1, t).clone()
    size = y.abs()
    for j in range(k):
        shift = (j - (k - 1) // 2) * d
        xs = torch.zeros_like(x64)
        lo, hi = max(0, -shift), min(t, t - shift)
        if lo < hi:
            xs[:, :, lo:hi] = x64[:, :, lo + shift:hi + shift]
        y += torch.einsum("oi,bit->bot", w64[:, :, j], xs)
        size += torch.einsum("oi,bit->bot", w64[:, :, j].abs(), xs.abs())
    if residual is not None:
        y += residual.double()
        size += residual.double().abs()
    return y, size


CASES = [  # (B, C_in, C_out, taps, dilation, T)
    (1, 32, 32, 7, 1, 64),
    (2, 64, 96, 7, 3, 37),  # T odd, B > 1
    (3, 32, 64, 7, 9, 5),  # T shorter than the halo (27 steps each side)
    (2, 96, 32, 1, 1, 41),
    (2, 32, 96, 1, 1, 8),
]


@pytest.mark.parametrize("b,c_in,c_out,k,d,t", CASES)
@pytest.mark.parametrize("with_residual", [False, True])
def test_plain_function_is_the_conv_chain_in_fp32(b, c_in, c_out, k, d, t, with_residual):
    """fp32: ``dac_conv`` equals ``nn.Conv1d`` then the residual add to fp32
    rounding, and the float64 sum over the taps within fp32's summation
    error."""
    gen = torch.Generator().manual_seed(b * 1000 + t)
    conv = _conv(c_in, c_out, k, d, torch.float32, seed=t)
    x = torch.randn((b, c_in, t), generator=gen)
    r = torch.randn((b, c_out, t), generator=gen) if with_residual else None
    got = pconv.dac_conv(x, conv.weight, conv.bias, d, r)
    chain = conv(x) if r is None else r + conv(x)
    assert got.dtype == torch.float32 and got.shape == (b, c_out, t)
    torch.testing.assert_close(got, chain, rtol=1e-6, atol=1e-6)
    ref, size = _taps_sum(x, conv.weight, conv.bias, d, r)
    assert bool(((got.double() - ref).abs() <= 2.0**-20 * size + 1e-12).all())


@pytest.mark.parametrize("b,c_in,c_out,k,d,t", CASES)
def test_plain_function_rounds_once_in_bf16(b, c_in, c_out, k, d, t):
    """bf16: ``dac_conv`` is the float64 sum of the bf16 inputs rounded once
    (within 2**-8 of its size, plus fp32's summation error); the parent's
    chain (``nn.Conv1d`` in bf16, then the residual add in bf16) within one
    rounding of each of its two roundings of that."""
    gen = torch.Generator().manual_seed(b * 1000 + t + 1)
    conv = _conv(c_in, c_out, k, d, torch.bfloat16, seed=t)
    x = torch.randn((b, c_in, t), generator=gen).to(torch.bfloat16)
    r = torch.randn((b, c_out, t), generator=gen).to(torch.bfloat16)
    got = pconv.dac_conv(x, conv.weight, conv.bias, d, r)
    assert got.dtype == torch.bfloat16
    ref, size = _taps_sum(x, conv.weight, conv.bias, d, r)
    slack = 2.0**-20 * size + 1e-12
    assert bool(((got.double() - ref).abs() <= U * ref.abs() + slack).all())
    y, _ = _taps_sum(x, conv.weight, conv.bias, d)  # the chain's first rounding is of the conv alone
    chain = r + conv(x)
    assert bool(((chain.double() - got.double()).abs() <= U * (2 * ref.abs() + y.abs()) + 2 * slack).all())


def test_plain_function_keeps_rows_apart():
    """Each row of a batch is the row convolved alone, to fp32 rounding (the
    CPU's convolution may sum in another order by batch size): nothing leaks
    across the row boundary, at the halo of dilation 9."""
    gen = torch.Generator().manual_seed(5)
    conv = _conv(32, 32, 7, 9, torch.float32)
    x = torch.randn((3, 32, 40), generator=gen)
    r = torch.randn((3, 32, 40), generator=gen)
    whole = pconv.dac_conv(x, conv.weight, conv.bias, 9, r)
    for i in range(3):
        alone = pconv.dac_conv(x[i:i + 1], conv.weight, conv.bias, 9, r[i:i + 1])
        torch.testing.assert_close(whole[i:i + 1], alone, rtol=1e-6, atol=1e-6)


def _refusal_inputs(case):
    conv = _conv(64, 64, 7, 3, torch.bfloat16)
    x = torch.randn((2, 64, 16)).to(torch.bfloat16)
    r = None
    if case == "fp32":
        x = x.float()
    elif case == "fp32_weights":
        conv = conv.float()
    elif case == "non_contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "two_dims":
        x = x[0]
    elif case == "four_dims":
        x = x[None]
    elif case == "width":
        conv = _conv(64, 64, 3, 1, torch.bfloat16)
    elif case == "stride":
        conv = nn.Conv1d(64, 64, 7, stride=2, padding=3).to(torch.bfloat16)
    elif case == "padding":
        conv = nn.Conv1d(64, 64, 7, dilation=3, padding=3).to(torch.bfloat16)
    elif case == "groups":
        conv = nn.Conv1d(64, 64, 7, padding=3, groups=2).to(torch.bfloat16)
    elif case == "no_bias":
        conv = nn.Conv1d(64, 64, 7, padding=3, bias=False).to(torch.bfloat16)
    elif case == "c_in":
        conv, x = _conv(48, 64, 7, 1, torch.bfloat16), torch.zeros((2, 48, 16), dtype=torch.bfloat16)
    elif case == "c_out":
        conv = _conv(64, 40, 1, 1, torch.bfloat16)
    elif case == "input_channels":
        x = torch.zeros((2, 32, 16), dtype=torch.bfloat16)
    elif case == "residual_shape":
        r = torch.zeros((2, 64, 15), dtype=torch.bfloat16)
    elif case == "needs_grad":
        conv.weight.requires_grad_()
    return x, conv, r


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA tensors"),
    ("fp32", TypeError, "bf16"),
    ("fp32_weights", TypeError, "bf16"),
    ("non_contiguous", ValueError, "contiguous"),
    ("two_dims", ValueError, r"\(B, C, T\)"),
    ("four_dims", ValueError, r"\(B, C, T\)"),
    ("width", ValueError, "widths"),
    ("stride", ValueError, "stride 1"),
    ("padding", ValueError, "'same' padding"),
    ("groups", ValueError, "one group"),
    ("no_bias", ValueError, "a bias"),
    ("c_in", ValueError, "multiples of 32"),
    ("c_out", ValueError, "multiples of 32"),
    ("input_channels", ValueError, "an input of 32"),
    ("residual_shape", ValueError, "residual must be"),
    ("needs_grad", RuntimeError, "no backward"),
])
def test_wrapper_refuses_before_loading_a_library(monkeypatch, case, error, match):
    monkeypatch.setattr(cuda_build, "library", lambda *a, **k: pytest.fail("a library was loaded"))
    before = pgraphs.launches()["dac_conv"]
    x, conv, r = _refusal_inputs(case)
    with pytest.raises(error, match=match):
        pconv.dac_conv_cuda(x, conv, r)
    assert pgraphs.launches()["dac_conv"] == before


def test_the_build_takes_dac_conv_from_csrc(monkeypatch, tmp_path):
    """``library("dac_conv")`` resolves to ``libdac_conv.so`` under a hash
    that covers ``csrc/dac_conv.cu``, and is compiled from that source."""
    lib = cuda_build._library_path("dac_conv")
    assert lib.name == "libdac_conv.so" and lib.parent.parent == cuda_build.BUILD_ROOT
    assert (cuda_build.CSRC / "dac_conv.cu").is_file()
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    assert cuda_build._library_path("dac_conv", copy) == lib
    (copy / "dac_conv.cu").write_text((copy / "dac_conv.cu").read_text() + "\n// edited\n")
    assert cuda_build._library_path("dac_conv", copy) != lib

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
    with pytest.raises(RuntimeError, match="dac_conv: nvcc exited 1"):
        cuda_build.build(["dac_conv"], copy)
    assert len(started) == 1 and started[0][-1] == str(copy / "dac_conv.cu")
    assert "arch=compute_90a,code=sm_90a" in started[0]


def _parent_res_unit(self, x):
    return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


def _parent_decoder(self, z):
    x = self.conv_in(z)
    for block in self.blocks:
        x = block(x)
    x = self.conv_out(self.snake_out(x))
    return torch.tanh(x.float())[:, 0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_dac_decode_on_the_cpu_keeps_nn_conv1d(monkeypatch, dtype):
    """Mini's decoder layout at narrow widths: a decode on the CPU launches
    no K7 and returns, bit for bit, what the decoder returned before K7
    (``nn.Conv1d``, then the residual add), in bf16 and in fp32."""
    monkeypatch.setattr(pdac, "dac_conv_cuda", lambda *a, **k: pytest.fail("K7 called off the card"))
    cfg = DACConfig(codebook_size=64, latent_dim=32, decoder_hidden_size=64, encoder_hidden_size=8)
    codec = pdac.DAC(cfg)
    codec.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # biases and alphas away from their init, so every term shows
        for name, p in codec.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
            elif name.endswith("alpha"):
                p.copy_(torch.rand(p.shape, generator=gen) * 2 + 0.05)
    codec = codec.to(dtype)
    codes = torch.randint(0, cfg.codebook_size, (2, cfg.num_codebooks, 3), generator=gen)
    before = pgraphs.launches()["dac_conv"]
    with torch.no_grad():
        wave = codec.decode(codes)
        with monkeypatch.context() as mp:
            mp.setattr(pdac.ResUnit, "forward", _parent_res_unit)
            mp.setattr(pdac.DACDecoder, "forward", _parent_decoder)
            parent = codec.decode(codes)
    assert wave.shape == (2, 3 * cfg.hop_length) and bool(torch.isfinite(wave).all())
    assert torch.equal(wave, parent)
    assert pgraphs.launches()["dac_conv"] == before
