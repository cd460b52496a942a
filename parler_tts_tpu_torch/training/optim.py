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


def capturable(device: torch.device) -> bool:
    """Whether AdamW runs its capturable form on ``device`` (its step count
    and learning rate on the device, no host reads): on CUDA, where train
    steps are captured; torch refuses it on the CPU."""
    return device.type == "cuda"


class Optimizer:
    """Clipped AdamW with gradient accumulation over a fixed list of
    parameters, updated in place by :meth:`update`.  ``split`` flags the
    parameters that hold a model rank's shard, ``model_group`` is their
    group (``global_norm``).

    Every tensor it updates is made once, here, and changed in place ever
    after (AdamW's moments and step counts, the accumulation buffer, the
    learning rate and the accumulation's divisor on the device), so a
    captured train step's graph stays valid through updates and loads.
    An update is three parts: :meth:`stage` on the host (whether this call
    updates, its learning rate from the schedule, the divisor), :meth:`apply`
    on the device (all a graph holds) and :meth:`advance` on the host (the
    counts).  On CUDA, AdamW is torch's capturable form with a device
    learning rate, on either route, so a captured and an eager step do the
    same arithmetic."""

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
        device = self.params[0].device
        on_device = capturable(device)
        lr = torch.zeros((), device=device) if on_device else 0.0
        self._adamw = torch.optim.AdamW(self.params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                                        capturable=on_device, foreach=on_device or None)
        for p in self.params:
            self._adamw.state[p] = {
                "step": torch.zeros((), dtype=torch.float32, device=device if on_device else "cpu"),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
        self._acc = [torch.zeros_like(p) for p in self.params] if grad_accum_steps > 1 else None
        self._divisor = torch.ones((), device=device)  # the running mean's n + 1

    def update(self, grads: list[torch.Tensor], grad_norm: torch.Tensor | None = None) -> bool:
        """Take one micro-batch of grads (one per parameter).  Returns whether
        the parameters were updated.  ``grad_norm``, the grads' global norm
        if the caller has it, saves recomputing it without accumulation."""
        updates = self.stage()
        self.apply(grads, grad_norm, updates)
        self.advance(updates)
        return updates

    def stage(self) -> bool:
        """The next call's host part, before its device work: returns whether
        it updates; sets its learning rate (``schedule(count)``) and the
        accumulation's divisor, and zeroes the buffer at an accumulation's
        start.  It launches only fills."""
        updates = self.mini_step == self.grad_accum_steps - 1
        if self._acc is not None:
            if self.mini_step == 0:
                torch._foreach_zero_(self._acc)
            self._divisor.fill_(self.mini_step + 1)
        if updates:
            lr = self.schedule(self.count)
            for group in self._adamw.param_groups:
                if torch.is_tensor(group["lr"]):
                    group["lr"].fill_(lr)
                else:
                    group["lr"] = lr
        return updates

    def apply(self, grads: list[torch.Tensor], grad_norm: torch.Tensor | None, updates: bool) -> None:
        """The device part of a call that :meth:`stage` staged: the running
        mean of the micro-batch grads (optax's ``acc + (g - acc) / (n + 1)``),
        then, when ``updates``, clipping and AdamW.  Reads nothing on the
        host."""
        grads = list(grads)
        if self._acc is not None:
            diff = torch._foreach_sub(grads, self._acc)
            torch._foreach_div_(diff, self._divisor)
            torch._foreach_add_(self._acc, diff)
            if not updates:
                return
            grads, grad_norm = self._acc, None
        if self.max_grad_norm is not None:
            norm = self.norm(grads) if grad_norm is None else grad_norm
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        self._adamw.step()
        for p in self.params:
            p.grad = None

    def advance(self, updates: bool) -> None:
        """The counts after a call that :meth:`stage` staged."""
        self.mini_step = (self.mini_step + 1) % self.grad_accum_steps
        self.count += int(updates)

    def norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The global norm of a full set of grads, over the model group's
        shards."""
        return global_norm(grads, self.split, self.model_group)

    def state_dict(self) -> dict:
        """AdamW's ``state_dict`` (keyed by the index in ``params``; the
        learning rate a float), the update count, the accumulation position
        and, mid-accumulation, the running mean of the grads."""
        adamw = self._adamw.state_dict()
        adamw["param_groups"] = [{**g, "lr": float(g["lr"])} for g in adamw["param_groups"]]
        return {"adamw": adamw, "count": self.count, "mini_step": self.mini_step,
                "acc": list(self._acc) if self.mini_step else None}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` over the same ``params`` (in the same
        order), copied into this optimizer's own tensors (whatever device
        they were saved from).  The hyperparameters are this optimizer's,
        as optax keeps them out of its state."""
        acc = state["acc"]
        if acc is not None and (self._acc is None or [a.shape for a in acc] != [p.shape for p in self.params]):
            raise ValueError("the accumulation buffer does not match this optimizer's")
        for i, p in enumerate(self.params):
            own = self._adamw.state[p]
            for key, value in state["adamw"]["state"].get(i, {}).items():
                own[key].copy_(value)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        if acc is not None:
            for a, x in zip(self._acc, acc):
                a.copy_(x)


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
