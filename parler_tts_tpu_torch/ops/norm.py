"""The port's LayerNorm and RMSNorm on bf16 CUDA activations (K9).

The JAX package has no Pallas kernel here: XLA fuses each norm
(``parler_tts_tpu/ops/nn.py``) into one pass.  Run eagerly, the port's
plain LayerNorm is 5 kernels (x, scale and bias cast to fp32,
``F.layer_norm``, a cast back) and its RMSNorm 9, each a launch that moves
a few hundred KB at the decode step's shapes.  ``csrc/norm.cu`` reads the
bf16 rows once and writes them once, with fp32 statistics (a two-pass
variance over the row in registers) and one rounding at the store; the
scale and bias are read in their own dtype (bf16 or fp32).

``ops/nn.py``'s ``layer_norm`` and ``rms_norm`` send x here when ``takes``
says it is K9's (bf16 on the card, no autograd through it), and to the
plain chains (``layer_norm_plain``, ``rms_norm_plain``) everywhere else:
CPU tensors, other dtypes, autograd.  ``norm_cuda`` checks the rest once and
raises on what the kernel does not take (a layout, a width, the weights), so
a bf16 norm on the card never falls back to the plain chain unseen.  Each
call counts as one launch of ``norm`` (``core/graphs.count``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parler_tts_tpu_torch.core import graphs

#: the widest row the kernel takes (384 chunks of 8 elements; the widest a
#: configuration sends is Nemotron-H's 2688)
MAX_WIDTH = 3072
#: the weights' dtypes, by the flag the C entry point takes
_WEIGHTS_BF16 = {torch.bfloat16: 1, torch.float32: 0}


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain LayerNorm: fp32 statistics, result in ``x.dtype``."""
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain T5 RMSNorm (no mean subtraction, no bias), fp32
    statistics."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _kernel():
    """The C entry point with its ctypes signature (built at first use)."""
    from parler_tts_tpu_torch.ops.cuda_build import library

    fn = library("norm").norm_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                ctypes.c_void_p])
    return fn


def _refusal(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None) -> Exception | None:
    """What the kernel does not take in these arguments, as the error
    ``norm_cuda`` raises (the device last, so that each other refusal
    shows on the CPU too); None when it takes them."""
    if x.dtype != torch.bfloat16:
        return TypeError(f"the norm kernel takes bf16 activations, got {x.dtype}")
    if x.dim() == 0:
        return ValueError("the norm kernel takes activations of one dimension or more, got a scalar")
    width = x.shape[-1]
    if width == 0 or width % 8 or width > MAX_WIDTH:
        return ValueError(f"the norm kernel takes a width that is a multiple of 8 up to {MAX_WIDTH}, got {width}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        return ValueError(f"the norm kernel takes contiguous rows on a 16-byte boundary, got strides {x.stride()}")
    for name, w in (("scale", scale), ("bias", bias)):
        if w is None:
            continue
        if w.shape != (width,) or w.dtype != scale.dtype or w.dtype not in _WEIGHTS_BF16:
            return ValueError(f"{name} must be ({width},) bf16 or fp32 (bias as scale), got {tuple(w.shape)} "
                              f"{w.dtype}")
        if w.device != x.device or not w.is_contiguous() or w.data_ptr() % 16:
            return ValueError(f"{name} must be contiguous on a 16-byte boundary on {x.device}, got {w.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, scale, bias)):
        return RuntimeError("the norm kernel has no backward: call it under torch.no_grad()")
    if x.device.type != "cuda":
        return ValueError(f"the norm kernel runs on CUDA tensors, got {x.device}")
    return None


def takes(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None) -> bool:
    """Whether this norm is K9's: x bf16 on the card and no autograd
    through it.  The layout, the width and the weights are not asked here:
    ``norm_cuda`` raises on what the kernel does not take."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, scale, bias))))


def norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None, eps: float) -> torch.Tensor:
    """K9: x (..., width) bf16 normed over its last dimension -> bf16 of
    x's shape; with ``bias`` ``layer_norm(x, scale, bias, eps=eps)``,
    without it ``rms_norm(x, scale, eps=eps)``, fp32 statistics."""
    err = _refusal(x, scale, bias)
    if err is not None:
        raise err
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    width = x.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _kernel()(x.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
                         x.numel() // width, width, _WEIGHTS_BF16[scale.dtype], eps, stream)
    if code:
        raise RuntimeError(f"norm launch failed: CUDA error {code}")
    graphs.count("norm")
    return out
