"""Descript Audio Codec, decode side (codes -> waveform).

Port of ``parler_tts_tpu/models/dac.py``: the residual vector quantizer's
``from_codes`` and the transposed-conv Snake stack that upsamples 86 Hz
latents by ``prod(upsampling_ratios)`` to the waveform, final tanh in fp32.
The convolutions are ``nn.Conv1d`` / ``nn.ConvTranspose1d`` on NCW
activations.  At bf16 the Snake activation is the polynomial ``snake_fast``;
at fp32 it is the exact one.  The encode side waits for a later slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from parler_tts_tpu_torch.core.config import DACConfig


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``x + sin(alpha*x)^2 / (alpha + 1e-9)`` in fp32, alpha per channel
    (dim 1 of NCW)."""
    x32 = x.float()
    a = alpha.float()[None, :, None]
    return (x32 + torch.sin(a * x32).square() / (a + 1e-9)).to(x.dtype)


# sin^2(pi*u) ~= sum_k c_k (u - 1/2)^(2k) on u in [0, 1), max abs error 4e-7
_SIN2_COEFFS = (
    0.9999996053911587,
    -9.86949017788201,
    32.46432871051712,
    -42.63581076715343,
    29.395246060076758,
    -10.535552813831753,
)


def snake_fast(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake with ``sin^2`` as a range-reduced even polynomial of degree 10
    (max abs error 4e-7), fp32 inside."""
    x32 = x.float()
    a = alpha.float()[None, :, None]
    t = x32 * (a * (1.0 / math.pi))
    v = (t - torch.floor(t)) - 0.5
    w = v * v
    p = w * _SIN2_COEFFS[-1] + _SIN2_COEFFS[-2]
    for c in _SIN2_COEFFS[-3::-1]:
        p = p * w + c
    return (x32 + p * (1.0 / (a + 1e-9))).to(x.dtype)


class Snake(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (snake_fast if x.dtype == torch.bfloat16 else snake)(x, self.alpha)


_DILATIONS = (1, 3, 9)


class ResUnit(nn.Module):
    """Snake -> dilated conv7 -> Snake -> conv1, residual add."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.snake1 = Snake(dim)
        self.conv1 = nn.Conv1d(dim, dim, 7, dilation=dilation, padding=3 * dilation)
        self.snake2 = Snake(dim)
        self.conv2 = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.snake = Snake(dim)
        self.conv_up = nn.ConvTranspose1d(dim, dim // 2, 2 * stride, stride=stride,
                                          padding=math.ceil(stride / 2))
        self.res1, self.res2, self.res3 = (ResUnit(dim // 2, d) for d in _DILATIONS)

    def forward(self, x):
        x = self.conv_up(self.snake(x))
        return self.res3(self.res2(self.res1(x)))


class DACDecoder(nn.Module):
    """(B, latent_dim, T) latents -> (B, T * hop) waveform."""

    def __init__(self, cfg: DACConfig):
        super().__init__()
        d = cfg.decoder_hidden_size
        self.conv_in = nn.Conv1d(cfg.latent_dim, d, 7, padding=3)
        blocks = []
        for stride in cfg.upsampling_ratios:
            blocks.append(DecoderBlock(d, stride))
            d //= 2
        self.blocks = nn.ModuleList(blocks)
        self.snake_out = Snake(d)
        self.conv_out = nn.Conv1d(d, 1, 7, padding=3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z)
        for block in self.blocks:
            x = block(x)
        x = self.conv_out(self.snake_out(x))
        return torch.tanh(x.float())[:, 0]


class ResidualVQ(nn.Module):
    """Decode side of the residual vector quantizer."""

    def __init__(self, cfg: DACConfig):
        super().__init__()
        k, n, d, l = cfg.num_codebooks, cfg.codebook_size, cfg.codebook_dim, cfg.latent_dim
        self.codebooks = nn.Parameter(torch.empty(k, n, d))
        self.out_proj = nn.Module()
        self.out_proj.kernel = nn.Parameter(torch.empty(k, d, l))
        self.out_proj.bias = nn.Parameter(torch.zeros(k, l))

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, K, T) codes -> (B, T, latent_dim) fp32 summed latents: gather
        each codebook's vectors, contract against the stacked out-projections,
        add the summed biases."""
        k = self.codebooks.shape[0]
        zp = self.codebooks.float()[torch.arange(k, device=codes.device)[None, :, None], codes.long()]
        z = torch.einsum("bktd,kdh->bth", zp, self.out_proj.kernel.float())
        return z + self.out_proj.bias.float().sum(dim=0)


class DAC(nn.Module):
    """Codes -> waveform.  Parameter names follow the JAX tree
    (``quantizer.*``, ``decoder.*``)."""

    def __init__(self, cfg: DACConfig):
        super().__init__()
        self.cfg = cfg
        self.quantizer = ResidualVQ(cfg)
        self.decoder = DACDecoder(cfg)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, K, T86) codes -> (B, T86 * hop) fp32 waveform; the convs run
        in the module's dtype."""
        dtype = self.decoder.conv_in.weight.dtype
        z = self.quantizer.from_codes(codes).to(dtype)
        return self.decoder(z.transpose(1, 2))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Conv kernels 0.02 * truncnormal(-2, 2), zero biases, unit Snake
        alphas, codebooks normal(0, 0.02), as the JAX ``init``."""
        for name, p in self.named_parameters():
            if name.endswith("alpha"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "quantizer.codebooks":
                p.normal_(0.0, 0.02, generator=generator)
            else:
                nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(0.02)
