"""The DAC decoder's polynomial Snake on bf16 CUDA activations (K6).

The JAX package has no Pallas kernel here: XLA fuses ``snake_fast``'s chain
(``parler_tts_tpu/models/dac.py``) into one pass.  Run eagerly, the port's
plain ``models/dac.py::snake_fast`` is 19 full-size kernels (a cast to fp32,
17 fp32 operations, a cast back), about 176 bytes of device memory per
element.  ``csrc/snake.cu`` reads the bf16 activations once and writes the
bf16 result once, and runs the plain function's chain in its order in fp32,
each operation rounded to nearest: its output is ``snake_fast``'s bit for
bit.  The two per-channel constants are computed here with the plain
function's own expressions, over the C channels.

The decoder's ``Snake`` sends its bf16 CUDA inputs here and keeps the plain
functions everywhere else; this wrapper raises on what the kernel does not
take.  Each call counts as one launch of ``snake`` (``core/graphs.count``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from parler_tts_tpu_torch.core import graphs


def _kernel():
    """The C entry point with its ctypes signature (built at first use)."""
    from parler_tts_tpu_torch.ops.cuda_build import library

    fn = library("snake").snake_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    return fn


def _check(x: torch.Tensor, alpha: torch.Tensor) -> None:
    """Raise on what the kernel does not take (the device last, so that each
    other refusal shows on the CPU too)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the Snake kernel takes bf16 activations, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"the Snake kernel takes (B, C, T) activations, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"the Snake kernel takes contiguous activations, got strides {x.stride()}")
    if alpha.shape != (x.shape[1],) or alpha.device != x.device or not alpha.is_floating_point():
        raise ValueError(f"alpha must be ({x.shape[1]},) floating point on {x.device}, "
                         f"got {tuple(alpha.shape)} {alpha.dtype} on {alpha.device}")
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad):
        raise RuntimeError("the Snake kernel has no backward: call it under torch.no_grad()")
    if x.device.type != "cuda":
        raise ValueError(f"the Snake kernel runs on CUDA tensors, got {x.device}")


def snake_fast_cuda(x: torch.Tensor, alpha: torch.Tensor, coeffs) -> torch.Tensor:
    """K6: ``models/dac.py::snake_fast(x, alpha)`` for x (B, C, T) bf16
    contiguous on the card, alpha (C,), ``coeffs`` the polynomial's six
    coefficients from the constant term up -> (B, C, T) bf16, bit for bit."""
    _check(x, alpha)
    a = alpha.float()
    c1 = (a * (1.0 / math.pi)).contiguous()  # snake_fast's expressions, per channel
    c2 = (1.0 / (a + 1e-9)).contiguous()
    k = torch.tensor(coeffs, dtype=torch.float32).tolist()  # each rounded to fp32 as the plain chain rounds it
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    b, c, t = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), c1.data_ptr(), c2.data_ptr(), out.data_ptr(), b * c, c, t, *k, stream)
    if err:
        raise RuntimeError(f"snake launch failed: CUDA error {err}")
    graphs.count("snake")
    return out
