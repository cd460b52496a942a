"""The DAC decoder (Descript Audio Codec): the residual quantizer's codes
to latents (each codebook's vector through its 1x1 out-projection, summed),
then conv7, per upsampling stride a Snake, a transposed conv of width
2 * stride and three residual units (dilations 1, 3, 9), a last Snake,
conv7 and tanh.  Snake(x) = x + sin(alpha x)^2 / (alpha + 1e-9)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import Weights


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a = alpha[None, :, None]
    return x + torch.sin(a * x).square() / (a + 1e-9)


def latents(w: Weights, codes: torch.Tensor) -> torch.Tensor:
    """(B, K, T) codes -> (B, latent, T)."""
    k = codes.shape[1]
    cb = w("quantizer.codebooks")  # (K, N, d)
    picked = cb[torch.arange(k, device=codes.device)[None, :, None], codes.long()]  # (B, K, T, d)
    z = torch.einsum("bktd,kdl->btl", picked, w("quantizer.out_proj.kernel")[:k])
    return (z + w("quantizer.out_proj.bias")[:k].sum(0)).transpose(1, 2)


def decode(w: Weights, cfg: dict, codes: torch.Tensor) -> torch.Tensor:
    """(B, K, T) codes -> (B, T * hop) waveform."""
    x = latents(w, codes)
    dw = w.sub("decoder.")
    x = F.conv1d(x, dw("conv_in.weight"), dw("conv_in.bias"), padding=3)
    for i, stride in enumerate(cfg["upsampling_ratios"]):
        b = dw.sub(f"blocks.{i}.")
        x = F.conv_transpose1d(snake(x, b("snake.alpha")), b("conv_up.weight"), b("conv_up.bias"), stride=stride,
                               padding=math.ceil(stride / 2), output_padding=stride % 2)
        for j, dilation in enumerate((1, 3, 9)):
            r = b.sub(f"res{j + 1}.")
            y = F.conv1d(snake(x, r("snake1.alpha")), r("conv1.weight"), r("conv1.bias"), dilation=dilation,
                         padding=3 * dilation)
            x = x + F.conv1d(snake(y, r("snake2.alpha")), r("conv2.weight"), r("conv2.bias"))
    x = F.conv1d(snake(x, dw("snake_out.alpha")), dw("conv_out.weight"), dw("conv_out.bias"), padding=3)
    return torch.tanh(x)[:, 0]
