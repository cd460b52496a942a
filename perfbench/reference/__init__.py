"""The plain reference: Parler-TTS in float32 PyTorch, written from the
published descriptions (T5, the MusicGen-style Parler decoder with its delay
pattern, DAC and EnCodec decoders).

It imports nothing of the program and nothing of JAX.  It reads the raw
weights that ``perfbench/weights.py`` makes (a name -> tensor dict, named as
the program's state dict, which is the benchmark's raw layout) and a plain
configuration dict (the ``model`` section of a file under
``perfbench/configs``), and works out everything else itself.  Matrix
products and convolutions run in true float32: ``exact_fp32`` turns TF32
off.
"""

from __future__ import annotations

import contextlib

import torch

NEG = -1e9  # finite: a query with no valid key (a padded one) stays finite


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and cuDNN while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


class Weights:
    """Float32 views of the raw weights under a name prefix, cast on use in
    ``dtype`` (float32 unless a control asks for less)."""

    def __init__(self, raw: dict[str, torch.Tensor], prefix: str = "", dtype: torch.dtype = torch.float32,
                 transform=None):
        self.raw, self.prefix, self.dtype, self.transform = raw, prefix, dtype, transform

    def __call__(self, name: str) -> torch.Tensor:
        t = self.raw[self.prefix + name]
        if self.transform is not None:
            t = self.transform(self.prefix + name, t)
        return t.to(self.dtype)

    def sub(self, prefix: str) -> "Weights":
        return Weights(self.raw, self.prefix + prefix, self.dtype, self.transform)


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n, -1).transpose(1, 2)


def unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def attend(q, k, v, allowed: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T + bias) v over (B, H, T, D), ``allowed`` broadcast to
    (B, H, Tq, Tk) (True = attend)."""
    scores = q @ k.transpose(-1, -2)
    if bias is not None:
        scores = scores + bias
    scores = scores.masked_fill(~allowed, NEG)
    return torch.softmax(scores, dim=-1) @ v
