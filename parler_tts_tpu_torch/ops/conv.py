"""1-D convolutions on the JAX package's layouts.

Port of ``parler_tts_tpu/ops/conv.py``.  The public functions take
activations ``(B, T, C)`` (NWC) and kernels ``(width, C_in, C_out)`` (WIO),
as the JAX functions do; the transposed-conv kernel is stored time-flipped
and in/out-swapped (``parler_tts_tpu/core/torch_import.py::_conv_t``).
Inside they run ``F.conv1d`` / ``F.conv_transpose1d`` on torch-layout
weights.  The two weight converters below are the one place that knows the
layout change; ``core/from_jax.py`` uses them to fill the codec's
``nn.Conv1d`` / ``nn.ConvTranspose1d`` modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def torch_conv1d_weight(kernel: torch.Tensor) -> torch.Tensor:
    """WIO ``(W, C_in, C_out)`` -> ``Conv1d`` weight ``(C_out, C_in, W)``."""
    return kernel.permute(2, 1, 0)


def torch_conv_transpose1d_weight(kernel: torch.Tensor) -> torch.Tensor:
    """Time-flipped WIO ``(W, C_in, C_out)`` -> ``ConvTranspose1d`` weight
    ``(C_in, C_out, W)``."""
    return kernel.flip(0).permute(1, 2, 0)


def conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, *,
           stride: int = 1, dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """torch ``Conv1d`` on NWC/WIO. x: (B, T, C_in) -> (B, T', C_out)."""
    w = torch_conv1d_weight(kernel).to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv1d(x.transpose(1, 2), w, b, stride=stride, padding=padding, dilation=dilation)
    return y.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, *,
                     stride: int, padding: int = 0) -> torch.Tensor:
    """torch ``ConvTranspose1d`` (output_padding=0) on NWC and a time-flipped
    WIO kernel: ``out_len = (T-1)*stride - 2*padding + width``."""
    w = torch_conv_transpose1d_weight(kernel).to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride, padding=padding)
    return y.transpose(1, 2)
