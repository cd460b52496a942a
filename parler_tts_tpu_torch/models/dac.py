"""Descript Audio Codec: encode (waveform -> codes) and decode (codes ->
waveform).

Port of ``parler_tts_tpu/models/dac.py``.  Decode: the residual vector
quantizer's ``from_codes`` and the transposed-conv Snake stack that
upsamples 86 Hz latents by ``prod(upsampling_ratios)`` to the waveform,
final tanh in fp32.  Encode, for the training data's offline audio
tokenization: the strided Snake/conv stack that downsamples the waveform by
the hop (``prod(downsampling_ratios)``, 512 at 44.1 kHz) to latents, then
the residual nearest-codebook walk (``ResidualVQ.encode``) in fp32.  The
convolutions are ``nn.Conv1d`` / ``nn.ConvTranspose1d`` on NCW activations;
these and the quantizer's small matmuls are XLA ops in the JAX package, not
Pallas kernels.  The encoder's Snake activations are exact at every dtype;
the decoder's take the polynomial ``snake_fast`` at bf16 and the exact one
otherwise, as the JAX ``encoder_forward`` and ``decoder_forward`` do.  cuDNN
runs fp32 convolutions in TF32 unless told otherwise
(``torch.backends.cudnn.allow_tf32`` defaults to True), so encode and
decode turn TF32 off around their conv stacks: an fp32 codec is fp32, as
the JAX package's offline tokenizer is.  On the card the decoder's bf16
Snakes run as one hand-written kernel (K6, ``ops/snake.py``) that returns
``snake_fast``'s output bit for bit.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from parler_tts_tpu_torch.core.config import DACConfig
from parler_tts_tpu_torch.ops.conv import fp32_convolutions
from parler_tts_tpu_torch.ops.dac_conv import dac_conv_cuda
from parler_tts_tpu_torch.ops.snake import snake_fast_cuda


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
    """``fast``: the decoder's Snake, ``snake_fast`` on bf16 inputs (K6 on
    CUDA ones, the same bits) and exact on others; otherwise the encoder's,
    exact at every dtype."""

    def __init__(self, dim: int, *, fast: bool):
        super().__init__()
        self.fast = fast
        self.alpha = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.fast and x.dtype == torch.bfloat16):
            return snake(x, self.alpha)
        if x.is_cuda:
            return snake_fast_cuda(x, self.alpha, _SIN2_COEFFS)
        return snake_fast(x, self.alpha)


def _conv(module: nn.Conv1d, x: torch.Tensor, *, fast: bool, residual: torch.Tensor | None = None) -> torch.Tensor:
    """``residual + module(x)`` (``module(x)`` without a residual); the
    decoder's (``fast``) bf16 CUDA activations take K7, which rounds the
    sum once."""
    if fast and x.dtype == torch.bfloat16 and x.is_cuda:
        return dac_conv_cuda(x.contiguous(), module, residual)
    y = module(x)
    return y if residual is None else residual + y


_DILATIONS = (1, 3, 9)


class ResUnit(nn.Module):
    """Snake -> dilated conv7 -> Snake -> conv1, residual add; ``fast`` as
    ``Snake``'s, and the decoder's convolutions on the card by K7."""

    def __init__(self, dim: int, dilation: int, *, fast: bool):
        super().__init__()
        self.fast = fast
        self.snake1 = Snake(dim, fast=fast)
        self.conv1 = nn.Conv1d(dim, dim, 7, dilation=dilation, padding=3 * dilation)
        self.snake2 = Snake(dim, fast=fast)
        self.conv2 = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        h = self.snake2(_conv(self.conv1, self.snake1(x), fast=self.fast))
        return _conv(self.conv2, h, fast=self.fast, residual=x)


class EncoderBlock(nn.Module):
    """Three residual units at ``dim // 2``, Snake, then the strided
    ``conv_down`` to ``dim`` channels."""

    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.res1, self.res2, self.res3 = (ResUnit(dim // 2, d, fast=False) for d in _DILATIONS)
        self.snake = Snake(dim // 2, fast=False)
        self.conv_down = nn.Conv1d(dim // 2, dim, 2 * stride, stride=stride, padding=math.ceil(stride / 2))

    def forward(self, x):
        return self.conv_down(self.snake(self.res3(self.res2(self.res1(x)))))


class DACEncoder(nn.Module):
    """(B, 1, T) waveform -> (B, latent_dim, T / hop) latents; widths double
    from ``encoder_hidden_size`` at each block."""

    def __init__(self, cfg: DACConfig):
        super().__init__()
        d = cfg.encoder_hidden_size
        self.conv_in = nn.Conv1d(1, d, 7, padding=3)
        blocks = []
        for stride in cfg.downsampling_ratios:
            d *= 2
            blocks.append(EncoderBlock(d, stride))
        self.blocks = nn.ModuleList(blocks)
        self.snake_out = Snake(d, fast=False)
        self.conv_out = nn.Conv1d(d, cfg.latent_dim, 3, padding=1)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(audio)
        for block in self.blocks:
            x = block(x)
        return self.conv_out(self.snake_out(x))


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.snake = Snake(dim, fast=True)
        self.conv_up = nn.ConvTranspose1d(dim, dim // 2, 2 * stride, stride=stride,
                                          padding=math.ceil(stride / 2))
        self.res1, self.res2, self.res3 = (ResUnit(dim // 2, d, fast=True) for d in _DILATIONS)

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
        self.snake_out = Snake(d, fast=True)
        self.conv_out = nn.Conv1d(d, 1, 7, padding=3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = _conv(self.conv_in, z, fast=True)
        for block in self.blocks:
            x = block(x)
        x = self.conv_out(self.snake_out(x))
        return torch.tanh(x.float())[:, 0]


class ResidualVQ(nn.Module):
    """The residual vector quantizer: factorised ``codebook_dim``-wide
    codebooks with per-codebook in and out projections."""

    def __init__(self, cfg: DACConfig):
        super().__init__()
        k, n, d, l = cfg.num_codebooks, cfg.codebook_size, cfg.codebook_dim, cfg.latent_dim
        self.codebooks = nn.Parameter(torch.empty(k, n, d))
        self.out_proj = nn.Module()
        self.out_proj.kernel = nn.Parameter(torch.empty(k, d, l))
        self.out_proj.bias = nn.Parameter(torch.zeros(k, l))
        self.in_proj = nn.Module()
        self.in_proj.kernel = nn.Parameter(torch.empty(k, l, d))
        self.in_proj.bias = nn.Parameter(torch.zeros(k, d))

    def _walk(self, z: torch.Tensor, n: int, forced: torch.Tensor | None):
        """The residual walk over the first ``n`` codebooks in fp32: yields
        each codebook's scores (B, T, N) and the code taken, its argmax or,
        given ``forced`` (B, K, T), that code."""
        residual = z.float()
        for k in range(n):
            latents = residual @ self.in_proj.kernel[k].float() + self.in_proj.bias[k].float()
            enc = latents / latents.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            cb = self.codebooks[k].float()
            cbn = cb / cb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            # the JAX function's 2 e.c - |e|^2 + |c|^2; |c|^2 is 1 for every
            # normalised code, so the argmax is the nearest code
            scores = (2.0 * torch.einsum("btd,nd->btn", enc, cbn) - enc.square().sum(-1, keepdim=True)
                      + cbn.square().sum(-1))
            idx = scores.argmax(dim=-1) if forced is None else forced[:, k].long()
            yield scores, idx
            residual = residual - (cb[idx] @ self.out_proj.kernel[k].float() + self.out_proj.bias[k].float())

    @torch.no_grad()
    def encode(self, z: torch.Tensor, n_quantizers: int | None = None) -> torch.Tensor:
        """(B, T, latent_dim) latents -> (B, K, T) int32 codes by the
        residual nearest-neighbour walk over L2-normalised codes."""
        n = n_quantizers or self.codebooks.shape[0]
        return torch.stack([idx for _, idx in self._walk(z, n, None)], dim=1).to(torch.int32)

    @torch.no_grad()
    def code_gaps(self, z: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """For codes computed elsewhere (another device, another package):
        walk ``z`` taking those codes and return, per (B, K, T), how far each
        code's score falls below the best score there, 0 where it is the
        argmax.  Codes that differ at a near-tie have a gap at the level of
        the latents' rounding."""
        gaps = [scores.amax(-1) - scores.gather(-1, idx[..., None])[..., 0]
                for scores, idx in self._walk(z, codes.shape[1], codes)]
        return torch.stack(gaps, dim=1)

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, K, T) codes -> (B, T, latent_dim) fp32 summed latents: gather
        each codebook's vectors, contract against the stacked out-projections,
        add the summed biases."""
        k = self.codebooks.shape[0]
        zp = self.codebooks.float()[torch.arange(k, device=codes.device)[None, :, None], codes.long()]
        z = torch.einsum("bktd,kdh->bth", zp, self.out_proj.kernel.float())
        return z + self.out_proj.bias.float().sum(dim=0)


def pad_audio(audio: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Right-pad (..., T) waveforms with zeros to a multiple of the hop."""
    pad = (-audio.shape[-1]) % hop_length
    return torch.nn.functional.pad(audio, (0, pad)) if pad else audio


def _encode_side(name: str) -> bool:
    return name.startswith(("encoder.", "quantizer.in_proj."))


class DAC(nn.Module):
    """Waveform <-> codes.  Parameter names follow the JAX tree
    (``quantizer.*``, ``decoder.*``, ``encoder.*``)."""

    def __init__(self, cfg: DACConfig):
        super().__init__()
        self.cfg = cfg
        self.quantizer = ResidualVQ(cfg)
        self.decoder = DACDecoder(cfg)
        self.encoder = DACEncoder(cfg)

    @torch.no_grad()
    def encode(self, audio: torch.Tensor, n_quantizers: int | None = None) -> torch.Tensor:
        """(B, T) waveform -> (B, K, ceil(T / hop)) int32 codes: right-padded
        to a multiple of the hop, the conv stack in the module's dtype, the
        quantizer walk in fp32."""
        x = pad_audio(audio, self.cfg.hop_length).to(self.encoder.conv_in.weight.dtype)
        with fp32_convolutions():
            z = self.encoder(x[:, None])
        return self.quantizer.encode(z.transpose(1, 2), n_quantizers)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, K, T86) codes -> (B, T86 * hop) fp32 waveform; the convs run
        in the module's dtype."""
        dtype = self.decoder.conv_in.weight.dtype
        z = self.quantizer.from_codes(codes).to(dtype)
        with fp32_convolutions():
            return self.decoder(z.transpose(1, 2))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Conv kernels and projections 0.02 * truncnormal(-2, 2), zero
        biases, unit Snake alphas, codebooks normal(0, 0.02), as the JAX
        ``init``.  The encode side draws last, so the decode side's weights
        are those of a codec without it."""
        for name, p in sorted(self.named_parameters(), key=lambda item: _encode_side(item[0])):
            if name.endswith("alpha"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "quantizer.codebooks":
                p.normal_(0.0, 0.02, generator=generator)
            else:
                nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(0.02)
