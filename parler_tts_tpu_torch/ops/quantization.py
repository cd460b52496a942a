"""Symmetric int8 storage for the decode loop.

Port of ``parler_tts_tpu/ops/quantization.py``.  Both uses rest on one
property: a scale that is constant over a dot's contraction dimension folds
out of the dot.

* KV cache (``quantize_kv``): one scale per ``(..., position)`` row over the
  head dim, so attention computes ``(q . k_int8) * k_scale`` for the scores
  and ``(probs * v_scale) . v_int8`` for the output.
* Weights (``quantize_dense``): one scale per output channel over the input
  dim, ``y = (x @ w_int8) * scale``.

Both are storage formats: the products run in the compute dtype.  The
rounding is ``jnp.round``'s (half to even, as ``torch.round``), the clip
``±INT8_MAX`` and the scale ``max(amax, 1e-8) / INT8_MAX`` in fp32, so the
int8 values and scales equal the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


def _quantize(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    x32 = x.float()
    scale = x32.abs().amax(dim=dim).clamp(min=1e-8) / INT8_MAX
    q = torch.round(x32 / scale.unsqueeze(dim)).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (..., T, D)`` -> ``(q (..., T, D) int8, scale (..., T) fp32)`` with
    ``x ~= q * scale[..., None]``."""
    return _quantize(x, -1)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale[..., None]`` in fp32, cast to ``dtype`` (tests)."""
    return (q.float() * scale.float()[..., None]).to(dtype)


def quantize_dense(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``kernel (..., In, Out)`` -> ``(kernel_q int8 of the same shape, scale
    (..., Out) fp32)`` with ``kernel ~= kernel_q * scale[..., None, :]``; each
    leading index (a codebook) gets its own scales."""
    return _quantize(kernel, -2)


def quantize_lm_heads(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused LM heads ``(K, H, V)`` -> int8 and per-(codebook, vocab) scales
    ``(K, V)``."""
    return quantize_dense(kernel)
