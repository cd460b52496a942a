"""Learning-rate schedules and the optimizer, with optax's semantics.

Port of ``parler_tts_tpu/training/optim.py``, in plain PyTorch (optax is not
on the card's machine).  ``make_optimizer`` is the counterpart of
``MultiSteps(chain(clip_by_global_norm, adamw(schedule)))``:

* a schedule is evaluated at the number of updates applied before this one,
  so the first warmup update uses lr 0;
* clipping is optax's: the grads are scaled by ``max_norm / norm`` when
  ``norm >= max_norm`` (no ``+ 1e-6`` as in ``clip_grad_norm_``);
* AdamW with decoupled weight decay on every trainable tensor (the update
  itself is ``torch.optim.AdamW``, whose arithmetic is optax's);
* with ``grad_accum_steps = k`` the running mean of k micro-batch grads is
  applied on every k-th call and the schedule advances once per update.

Defaults follow the Mini v0.1 recipe: AdamW beta (0.9, 0.99), wd 0.01,
lr 9.5e-4 constant with warmup, clip 1.0.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, steps: int) -> Schedule:
    if steps <= 0:
        raise ValueError(f"a cosine schedule needs positive decay steps, got {steps}")
    return lambda count: init * 0.5 * (1 + math.cos(math.pi * min(count, steps) / steps))


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_schedule(name: str, learning_rate: float, *, warmup_steps: int = 0,
                  total_steps: int | None = None) -> Schedule:
    """HF ``get_scheduler`` names: constant | constant_with_warmup | linear |
    cosine; update count -> learning rate."""
    warm = max(warmup_steps, 1)
    if name == "constant":
        return lambda count: learning_rate
    if name == "constant_with_warmup":
        return _join(_linear(0.0, learning_rate, warm), lambda count: learning_rate, warm)
    if name in ("linear", "cosine") and total_steps is None:
        raise ValueError(f"the {name} schedule needs total_steps")
    if name == "linear":
        return _join(_linear(0.0, learning_rate, warm),
                     _linear(learning_rate, 0.0, total_steps - warmup_steps), warm)
    if name == "cosine":
        return _join(_linear(0.0, learning_rate, warm), _cosine(learning_rate, total_steps - warm), warm)
    raise ValueError(f"unknown schedule {name!r}")


def global_norm(tensors: list[torch.Tensor], split: list[bool] | None = None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d fp32 tensor on
    the tensors' device (no host synchronisation).  The sums are float64:
    the CPU's fp32 norm drifts by up to 5e-4 on a 5M-element gradient.

    With ``split`` (one flag per tensor) and a model ``group``
    (``parallel/tensor_parallel.ModelGroup``), a split tensor holds this
    rank's shard: the squares of the split tensors are summed over the
    group, and the replicated ones, the same on every rank, count once."""
    norms = torch.stack(torch._foreach_norm(tensors, 2, dtype=torch.float64))
    if group is None or split is None:
        return torch.linalg.vector_norm(norms).float()
    mask = torch.tensor(split, dtype=torch.bool, device=norms.device)
    split_squares = norms[mask].square().sum()
    torch.distributed.all_reduce(split_squares, group=group.group)
    return (split_squares + norms[~mask].square().sum()).sqrt().float()


class Optimizer:
    """Clipped AdamW with gradient accumulation over a fixed list of
    parameters, updated in place by :meth:`update`.  ``split`` flags the
    parameters that hold a model rank's shard, ``model_group`` is their
    group (``global_norm``)."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule, *, b1: float, b2: float,
                 eps: float, weight_decay: float, max_grad_norm: float | None, grad_accum_steps: int,
                 split: list[bool] | None = None, model_group=None):
        self.params = list(params)
        self.split, self.model_group = split, model_group
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.grad_accum_steps = grad_accum_steps
        self.count = 0  # updates applied
        self.mini_step = 0  # micro-batches accumulated towards the next update
        self._acc: list[torch.Tensor] | None = None
        self._adamw = torch.optim.AdamW(self.params, lr=0.0, betas=(b1, b2), eps=eps,
                                        weight_decay=weight_decay)

    def update(self, grads: list[torch.Tensor], grad_norm: torch.Tensor | None = None) -> bool:
        """Take one micro-batch of grads (one per parameter).  Returns whether
        the parameters were updated.  ``grad_norm``, the grads' global norm
        if the caller has it, saves recomputing it without accumulation."""
        grads = list(grads)
        if self.grad_accum_steps > 1:
            n = self.mini_step
            if n == 0:
                self._acc = [g.detach().clone() for g in grads]
            else:  # optax's running mean: acc + (g - acc) / (n + 1)
                for a, g in zip(self._acc, grads):
                    a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.grad_accum_steps
            if self.mini_step:
                return False
            grads, self._acc, grad_norm = self._acc, None, None
        if self.max_grad_norm is not None:
            norm = self.norm(grads) if grad_norm is None else grad_norm
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        lr = self.schedule(self.count)
        for group in self._adamw.param_groups:
            group["lr"] = lr
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        self._adamw.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return True

    def norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The global norm of a full set of grads, over the model group's
        shards."""
        return global_norm(grads, self.split, self.model_group)

    def state_dict(self) -> dict:
        """AdamW's ``state_dict`` (keyed by the index in ``params``), the
        update count, the accumulation position and, mid-accumulation, the
        running mean of the grads."""
        return {"adamw": self._adamw.state_dict(), "count": self.count, "mini_step": self.mini_step,
                "acc": None if self._acc is None else list(self._acc)}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` over the same ``params`` (in the same
        order); tensors move to the parameters' devices."""
        acc = state["acc"]
        if acc is not None and [a.shape for a in acc] != [p.shape for p in self.params]:
            raise ValueError("the accumulation buffer does not match the parameters")
        self._adamw.load_state_dict(state["adamw"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self._acc = None if acc is None else [a.to(p.device, p.dtype) for a, p in zip(acc, self.params)]


def make_optimizer(params: Iterable[torch.Tensor], learning_rate: float = 9.5e-4, *,
                   schedule: str = "constant_with_warmup", warmup_steps: int = 20000,
                   total_steps: int | None = None, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                   weight_decay: float = 0.01, max_grad_norm: float | None = 1.0,
                   grad_accum_steps: int = 1, split: list[bool] | None = None, model_group=None) -> Optimizer:
    """AdamW with global-norm clipping and optional gradient accumulation
    over ``params`` (the JAX ``make_optimizer``'s arguments; ``split`` and
    ``model_group`` place the parameters, see :class:`Optimizer`)."""
    sched = make_schedule(schedule, learning_rate, warmup_steps=warmup_steps, total_steps=total_steps)
    return Optimizer(params, sched, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                     max_grad_norm=max_grad_norm, grad_accum_steps=grad_accum_steps, split=split,
                     model_group=model_group)


def map_param_state(state: dict, fn) -> dict:
    """A copy of :meth:`Optimizer.state_dict` ``state`` with ``fn(i, t)``
    applied to each tensor shaped like parameter ``i`` (AdamW's moments and
    the accumulated grads); used to gather shards into full tensors and to
    slice them back."""
    adamw = state["adamw"]
    moments = {i: {k: fn(i, v) if torch.is_tensor(v) and v.dim() else v for k, v in s.items()}
               for i, s in adamw["state"].items()}
    acc = None if state["acc"] is None else [fn(i, a) for i, a in enumerate(state["acc"])]
    return {**state, "adamw": {**adamw, "state": moments}, "acc": acc}
