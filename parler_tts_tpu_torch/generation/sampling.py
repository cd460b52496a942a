"""Logits processors and token selection for multi-codebook decoding.

Port of ``parler_tts_tpu/generation/sampling.py``: classifier-free guidance,
temperature, top-k, top-p, then argmax (greedy) or Gumbel-max sampling per
``(batch, codebook)`` row.  ``jax.random.categorical`` is
``argmax(logits + gumbel)``; here the Gumbel noise comes from an explicit
``torch.Generator`` or is passed in (``noise=``), which lets a test feed the
noise the JAX package drew and get its tokens.
"""

from __future__ import annotations

import torch

from parler_tts_tpu_torch.core.config import GenerationConfig

NEG_INF = -1e9


def apply_cfg(cond: torch.Tensor, uncond: torch.Tensor, scale: float) -> torch.Tensor:
    """``uncond + scale * (cond - uncond)``."""
    return uncond + scale * (cond - uncond)


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / temperature


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits per row; ties at the k-th value are
    kept."""
    k = min(k, logits.shape[-1])
    if k == logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering (min_tokens_to_keep=1): keep tokens while the
    exclusive cumulative probability of the sorted row is below ``p``."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    exclusive = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], dim=-1)
    kth = torch.where(exclusive < p, sorted_logits, torch.full_like(sorted_logits, float("inf")))
    kth = kth.amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < kth, NEG_INF)


def process_logits(logits: torch.Tensor, gen: GenerationConfig) -> torch.Tensor:
    """Temperature, top-k, top-p in HF's warper order (sampling only)."""
    if gen.do_sample and gen.temperature not in (None, 1.0):
        logits = apply_temperature(logits, gen.temperature)
    if gen.do_sample and gen.top_k and gen.top_k > 0:
        logits = apply_top_k(logits, gen.top_k)
    if gen.do_sample and gen.top_p is not None and gen.top_p < 1.0:
        logits = apply_top_p(logits, gen.top_p)
    return logits


def gumbel(shape, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def select_tokens(logits: torch.Tensor, gen: GenerationConfig, *,
                  generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """logits (..., V) -> ids (...): argmax when greedy, else
    ``argmax(logits.float() + g)`` with Gumbel noise ``g`` taken from
    ``noise`` when given, else drawn from ``generator``."""
    if not gen.do_sample:
        return torch.argmax(logits, dim=-1)
    if noise is None:
        if generator is None:
            raise ValueError("sampling needs a torch.Generator or injected noise")
        noise = gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits.float() + noise.to(logits.device), dim=-1)
