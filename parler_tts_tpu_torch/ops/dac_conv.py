"""The DAC decoder's stride-1 convolutions on bf16 CUDA activations (K7).

The JAX package has no Pallas kernel here: XLA runs the convolutions
(``parler_tts_tpu/models/dac.py``).  Run eagerly, each of the port's bf16
convolutions was cuDNN's convolution (at dilation 9 a CUDA-core algorithm),
then a separate bias add, and for a residual unit's k1 convolution the
residual add: up to three kernels and three roundings.  ``csrc/dac_conv.cu``
computes the convolution on the tensor cores with fp32 sums, adds the bias
and the residual in fp32 and rounds once; the plain ``dac_conv`` below
computes the same in fp32 on any device.

It takes the decoder's ``nn.Conv1d`` modules with 1 or 7 taps, stride 1,
"same" padding, any dilation whose window fits the kernel's shared memory,
and input and output channels in multiples of 32.  The weight is relaid once
to (taps, C_out, C_in) bf16 and the bias to fp32, kept on the module and made
again when either parameter changes.  The decoder sends its bf16 CUDA
activations here and keeps ``nn.Conv1d`` everywhere else; this wrapper raises
on what the kernel does not take.  Each call counts as one launch of
``dac_conv`` (``core/graphs.count``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from parler_tts_tpu_torch.core import graphs

TAPS = (1, 7)
CHANNEL_MULTIPLE = 32


def dac_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dilation: int,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: ``conv1d(x, weight, bias)`` at stride 1 with "same"
    padding (``(k - 1) // 2 * dilation``), plus ``residual`` where given, all
    in fp32, rounded once to ``x.dtype``."""
    k = weight.shape[-1]
    y = F.conv1d(x.float(), weight.float(), bias.float(), padding=(k - 1) // 2 * dilation, dilation=dilation)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _kernel():
    """The C entry point with its ctypes signature (built at first use)."""
    from parler_tts_tpu_torch.ops.cuda_build import library

    fn = library("dac_conv").dac_conv_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    return fn


def _check(x: torch.Tensor, conv: nn.Conv1d, residual: torch.Tensor | None) -> None:
    """Raise on what the kernel does not take (the device last, so that each
    other refusal shows on the CPU too)."""
    if x.dtype != torch.bfloat16 or conv.weight.dtype != torch.bfloat16:
        raise TypeError(f"the DAC conv kernel takes bf16 activations and weights, got {x.dtype} and "
                        f"{conv.weight.dtype}")
    if x.dim() != 3:
        raise ValueError(f"the DAC conv kernel takes (B, C, T) activations, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"the DAC conv kernel takes contiguous activations, got strides {x.stride()}")
    k, d = conv.kernel_size[0], conv.dilation[0]
    if k not in TAPS:
        raise ValueError(f"the DAC conv kernel takes widths {TAPS}, got {k}")
    if conv.stride != (1,) or conv.groups != 1 or conv.padding_mode != "zeros" or conv.bias is None:
        raise ValueError(f"the DAC conv kernel takes stride 1, one group, zero padding and a bias, got stride "
                         f"{conv.stride}, groups {conv.groups}, {conv.padding_mode}, bias {conv.bias is not None}")
    if conv.padding != ((k - 1) // 2 * d,):
        raise ValueError(f"the DAC conv kernel takes 'same' padding {(k - 1) // 2 * d}, got {conv.padding}")
    c_out, c_in = conv.out_channels, conv.in_channels
    if x.shape[1] != c_in or c_in % CHANNEL_MULTIPLE or c_out % CHANNEL_MULTIPLE:
        raise ValueError(f"the DAC conv kernel takes channels in multiples of {CHANNEL_MULTIPLE}, {c_in} in: got "
                         f"{c_in} -> {c_out} on an input of {x.shape[1]}")
    if residual is not None and (residual.shape != (x.shape[0], c_out, x.shape[2]) or residual.dtype != x.dtype
                                 or not residual.is_contiguous() or residual.device != x.device):
        raise ValueError(f"the residual must be ({x.shape[0]}, {c_out}, {x.shape[2]}) bf16 contiguous on "
                         f"{x.device}, got {tuple(residual.shape)} {residual.dtype} on {residual.device}")
    if torch.is_grad_enabled() and (x.requires_grad or conv.weight.requires_grad
                                    or (residual is not None and residual.requires_grad)):
        raise RuntimeError("the DAC conv kernel has no backward: call it under torch.no_grad()")
    if x.device.type != "cuda" or conv.weight.device != x.device:
        raise ValueError(f"the DAC conv kernel runs on CUDA tensors, got {x.device} and weights on "
                         f"{conv.weight.device}")


def _operands(conv: nn.Conv1d) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight as (taps, C_out, C_in) bf16 and the bias in fp32, relaid
    once and kept on the module until either parameter changes (in place, or
    by a move to another device)."""
    w, b = conv.weight, conv.bias
    key = (w.data_ptr(), w._version, b.data_ptr(), b._version)
    kept = conv.__dict__.get("_dac_conv_operands")
    if kept is None or kept[0] != key:
        with torch.no_grad():
            kept = (key, w.permute(2, 0, 1).contiguous(), b.float().contiguous())
        conv.__dict__["_dac_conv_operands"] = kept
    return kept[1], kept[2]


def dac_conv_cuda(x: torch.Tensor, conv: nn.Conv1d, residual: torch.Tensor | None = None) -> torch.Tensor:
    """K7: ``dac_conv(x, conv.weight, conv.bias, conv.dilation[0], residual)``
    for x (B, C_in, T) bf16 contiguous on the card -> (B, C_out, T) bf16."""
    _check(x, conv, residual)
    w, b = _operands(conv)
    batch, c_in, t = x.shape
    out = torch.empty((batch, conv.out_channels, t), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), w.data_ptr(), b.data_ptr(), None if residual is None else residual.data_ptr(),
                        out.data_ptr(), batch, c_in, conv.out_channels, t, conv.kernel_size[0], conv.dilation[0],
                        stream)
    if err:
        raise RuntimeError(f"dac_conv launch failed: CUDA error {err} (1 is a size the kernel does not take, such as "
                           f"a dilation of {conv.dilation[0]} whose window does not fit its shared memory)")
    graphs.count("dac_conv")
    return out
