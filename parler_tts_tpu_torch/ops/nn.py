"""Shared neural-net ops and parameter-holding modules.

Port of ``parler_tts_tpu/ops/nn.py``.  Layouts are the JAX package's, so
weights carry across unchanged (``core/from_jax.py``):

* dense kernels are ``(in_features, out_features)``: ``y = x @ kernel + bias``;
* embedding tables are ``(vocab, features)``;
* attention tensors are ``(B, H, T, D)``.

The compute dtype is that of the activations: weights are cast to ``x.dtype``
at use (a no-op when the model already holds that dtype), norms and softmax
take their statistics in fp32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from parler_tts_tpu_torch.ops import norm
from parler_tts_tpu_torch.ops.quantization import quantize_dense

NEG_INF = -1e9  # finite additive mask: a fully masked row is uniform, not NaN


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with the JAX package's semantics: the identity at
    ``rate`` 0 or without a ``generator`` (eval mode); otherwise each element
    is kept with probability ``1 - rate`` and survivors are scaled by
    ``1 / (1 - rate)``.  The generator lives on ``x``'s device."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, *,
          scale: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ kernel (+ bias)`` with an ``(in, out)`` kernel.  With ``scale``
    (per output channel) the kernel is int8 storage (``ops/quantization.
    quantize_dense``): ``(x @ kernel.to(x.dtype)) * scale.to(x.dtype)``, the
    scale cast to the compute dtype before the multiply, as the JAX
    package does."""
    y = torch.matmul(x, kernel.to(x.dtype))
    if scale is not None:
        y = y * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, result in ``x.dtype``: K9 where it
    takes x (``ops/norm.takes``: bf16 on the card, no autograd), else the
    plain chain."""
    if norm.takes(x, scale, bias):
        return norm.norm_cuda(x, scale, bias, eps)
    return norm.layer_norm_plain(x, scale, bias, eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """T5 RMSNorm (no mean subtraction, no bias), fp32 statistics: K9
    where it takes x, as ``layer_norm``."""
    if norm.takes(x, scale):
        return norm.norm_cuda(x, scale, None, eps)
    return norm.rms_norm_plain(x, scale, eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU computed in fp32 (flan-T5's FFN activation)."""
    x32 = x.float()
    y = 0.5 * x32 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x32 + 0.044715 * x32.pow(3.0))))
    return y.to(x.dtype)


ACTIVATIONS = {"gelu": gelu, "gelu_new": gelu_new, "relu": F.relu, "silu": F.silu}


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, H*D) -> (B, H, T, D)"""
    b, t, _ = x.shape
    return x.reshape(b, t, num_heads, -1).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)"""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     bias: torch.Tensor | None = None,
                     mask: torch.Tensor | None = None,
                     dropout_rate: float = 0.0,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Plain softmax attention over (B, H, T, D) tensors with materialised
    fp32 scores.  ``bias`` is added to the scores; ``mask`` (bool,
    broadcastable to (B, H, Tq, Tk), True = attend) sets the others to
    ``NEG_INF``.  With a ``generator``, dropout at ``dropout_rate`` is applied
    to the probabilities (train mode).  No scaling: the caller pre-scales q
    where it needs to."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = dropout(torch.softmax(scores, dim=-1).to(q.dtype), dropout_rate, generator)
    return torch.matmul(probs, v.to(q.dtype))


class Dense(nn.Module):
    """``(in, out)`` kernel and optional bias."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel, self.bias)


class DenseWeight(NamedTuple):
    """An inference copy of a bias-free ``(in, out)`` kernel: as stored
    (``scale`` None), or int8 with per-output-channel ``scale``."""

    kernel: torch.Tensor
    scale: torch.Tensor | None = None

    @classmethod
    def of(cls, kernel: torch.Tensor, int8: bool = False, group=None) -> "DenseWeight":
        """``group``: the model group that splits ``kernel``'s input
        dimension, whose ranks take the scales together
        (``ops/quantization.quantize_dense``)."""
        return cls(*quantize_dense(kernel, group)) if int8 else cls(kernel)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel, scale=self.scale)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, eps=self.eps)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, eps=self.eps)


class Embedding(nn.Module):
    """``(vocab, dim)`` lookup table."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def forward(self, ids: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Rows of the table, cast to ``dtype`` (the compute dtype; None =
        the table's own)."""
        return F.embedding(ids, self.embedding if dtype is None else self.embedding.to(dtype))
