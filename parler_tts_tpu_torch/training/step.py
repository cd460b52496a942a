"""The training step: forward, backward and optimizer update.

Port of ``parler_tts_tpu/training/step.py``.  The text encoder and the codec
stay frozen (the reference's ``freeze_encoders``): only the
``TRAINABLE_KEYS`` subtrees require grad and are updated.  Compute runs in
``dtype`` (bf16 by default) over the parameters' own dtype (fp32), as the
JAX step does.

Dropout randomness comes from a generator seeded per (``dropout_seed``,
step), so masks are fixed per step and differ across steps; torch's bits are
not JAX's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from parler_tts_tpu_torch.core.config import ParlerTTSConfig
from parler_tts_tpu_torch.models.parler import TRAINABLE_KEYS, ParlerTTSModel, set_trainable
from parler_tts_tpu_torch.training.optim import Optimizer, global_norm, make_optimizer

BATCH_KEYS = ("input_ids", "attention_mask", "prompt_input_ids", "prompt_attention_mask", "labels",
              "decoder_attention_mask")


@dataclasses.dataclass
class TrainState:
    model: ParlerTTSModel
    optimizer: Optimizer
    step: int = 0


def trainable_parameters(model: ParlerTTSModel) -> list[torch.nn.Parameter]:
    """The parameters of the ``TRAINABLE_KEYS`` subtrees, in a fixed order."""
    return [p for key in TRAINABLE_KEYS if getattr(model, key) is not None
            for p in getattr(model, key).parameters()]


def create_state(model: ParlerTTSModel, **optimizer_kwargs) -> TrainState:
    """Mark the trainable subtrees and build their optimizer
    (``optimizer_kwargs`` go to ``make_optimizer``)."""
    set_trainable(model)
    return TrainState(model, make_optimizer(trainable_parameters(model), **optimizer_kwargs))


def has_dropout(cfg: ParlerTTSConfig) -> bool:
    d = cfg.decoder
    return any(r > 0.0 for r in (d.dropout, d.attention_dropout, d.activation_dropout, d.layerdrop))


def dropout_generator(seed: int, step: int) -> torch.Generator:
    """A host generator seeded from (``seed``, ``step``)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def _to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    def tensor(x):
        return (x if torch.is_tensor(x) else torch.from_numpy(np.array(x))).to(device)

    return {k: tensor(batch[k]) for k in BATCH_KEYS if batch.get(k) is not None}


def _device(model: ParlerTTSModel) -> torch.device:
    return model.decoder.embed_tokens.embedding.device


def make_train_step(cfg: ParlerTTSConfig, *, dtype: torch.dtype = torch.bfloat16,
                    dropout_seed: int | None = None, remat: bool = False) -> Callable[..., dict[str, Any]]:
    """Returns ``step(state, batch, timings=None) -> metrics``.

    ``batch`` holds numpy arrays or tensors: input_ids, attention_mask,
    prompt_input_ids, prompt_attention_mask, labels (B, K, T) and optionally
    decoder_attention_mask.  The step updates ``state`` in place and
    returns ``loss``, ``grad_norm`` (before clipping; 0-d tensors on the
    model's device) and ``step`` (the index this step ran at).  With a
    ``timings`` dict it synchronises the device after each phase and
    records ``forward_ms``, ``backward_ms`` and ``optimizer_ms`` there."""
    use_dropout = dropout_seed is not None and has_dropout(cfg)

    def step(state: TrainState, batch: dict, timings: dict | None = None) -> dict[str, Any]:
        device = _device(state.model)
        clock = _Clock(device, timings)
        gen = dropout_generator(dropout_seed, state.step) if use_dropout else None
        params = state.optimizer.params
        loss, _ = state.model.train_forward(**_to_device(batch, device), generator=gen, remat=remat,
                                            dtype=dtype)
        clock.mark("forward_ms")
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a layer that layerdrop skipped has no grad: zero, as in JAX
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        grad_norm = global_norm(grads)
        clock.mark("backward_ms")
        state.optimizer.update(grads, grad_norm)
        clock.mark("optimizer_ms")
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "step": state.step}
        state.step += 1
        return metrics

    return step


def make_eval_step(cfg: ParlerTTSConfig, *, dtype: torch.dtype = torch.bfloat16):
    """Loss-only eval pass: ``step(model, batch) -> {"loss"}``."""
    del cfg  # the model carries its config; kept for the JAX signature

    @torch.no_grad()
    def step(model: ParlerTTSModel, batch: dict) -> dict[str, torch.Tensor]:
        loss, _ = model.train_forward(**_to_device(batch, _device(model)), dtype=dtype)
        return {"loss": loss}

    return step


class _Clock:
    """Synchronised phase times for ``make_train_step``'s ``timings``."""

    def __init__(self, device: torch.device, timings: dict | None):
        self.device, self.timings = device, timings
        self.last = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        if self.timings is not None:
            now = self._now()
            self.timings[name] = 1e3 * (now - self.last)
            self.last = now
