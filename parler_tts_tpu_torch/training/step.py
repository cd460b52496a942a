"""The training step: forward, backward and optimizer update.

Port of ``parler_tts_tpu/training/step.py``.  The text encoder and the codec
stay frozen (the reference's ``freeze_encoders``): only the
``TRAINABLE_KEYS`` subtrees require grad and are updated.  Compute runs in
``dtype`` (bf16 by default) over the parameters' own dtype (fp32), as the
JAX step does.

Dropout randomness comes from a generator seeded per (``dropout_seed``,
step, data rank), so masks are fixed per step and differ across steps and
data ranks; torch's bits are not JAX's.

On a (data, model) mesh (``parallel/mesh.py``) each data rank takes its rows
of the global batch: the loss is the global batch's, from per-codebook sums
over counts summed over the data group, and the gradients are summed over
the data group; a model rank holds its shards, and the gradient norm sums
their squares over the model group.

Where a step runs (``core/graphs.capturable``): on a CUDA model in one
process (no mesh, or one without groups), the JAX package's jitted train
and eval steps become CUDA graphs (``core/graphs.capture``), one per
signature: the batch's shapes and dtypes, and for a train step remat,
dropout, whether the call updates or only accumulates, the optimizer and
the model's tensor addresses.  The first call of a signature runs its step
as the capture's warm-up (a capture runs nothing, so no update is applied
twice); later calls copy the batch into the static inputs and replay.  What
the host decides stays outside the graph: the dropout seeds and layerdrop
draws (seeded into generators made once per signature and registered with
the graph; layerdrop selects by a device mask over layers that all run),
the learning rate and the accumulation's divisor
(``Optimizer.stage``).  Loss and norm are 0-d copies of static outputs.  A
capture that fails raises: nothing falls back to the eager step.  A train
state keeps its graphs (``TrainState.graphs``), a model its eval graphs,
each within ``core/graphs.GRAPH_MEMORY_SHARE`` of the card's memory.  On the
CPU, and on a mesh whose data or model group sums over processes, steps run
eagerly.  Both routes draw the same masks and do the same arithmetic; the
captured step reports its whole time only (``timings["step_ms"]``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable

import numpy as np
import torch

from parler_tts_tpu_torch.core import graphs
from parler_tts_tpu_torch.core.config import ParlerTTSConfig
from parler_tts_tpu_torch.models.decoder import ReplayedRng, TrainRandom, train_draws
from parler_tts_tpu_torch.models.parler import TRAINABLE_KEYS, ParlerTTSModel, set_trainable
from parler_tts_tpu_torch.parallel.mesh import Mesh, composite_param_specs
from parler_tts_tpu_torch.training.optim import Optimizer, make_optimizer

BATCH_KEYS = ("input_ids", "attention_mask", "prompt_input_ids", "prompt_attention_mask", "labels",
              "decoder_attention_mask")


@dataclasses.dataclass
class TrainState:
    model: ParlerTTSModel
    optimizer: Optimizer
    step: int = 0
    #: the captured train steps over this state, by signature
    graphs: graphs.Programs = dataclasses.field(default_factory=graphs.Programs, repr=False, compare=False)


def trainable_names(model: ParlerTTSModel) -> list[str]:
    """The names of the ``TRAINABLE_KEYS`` subtrees' parameters, in the
    order of ``trainable_parameters``."""
    return [f"{key}.{name}" for key in TRAINABLE_KEYS if getattr(model, key) is not None
            for name, _ in getattr(model, key).named_parameters()]


def trainable_parameters(model: ParlerTTSModel) -> list[torch.nn.Parameter]:
    """The parameters of the ``TRAINABLE_KEYS`` subtrees, in a fixed order."""
    return [p for key in TRAINABLE_KEYS if getattr(model, key) is not None
            for p in getattr(model, key).parameters()]


def trainable_dims(model: ParlerTTSModel) -> list[int | None]:
    """For each trainable parameter, in order, the dimension it splits over
    the model axis (None: replicated)."""
    specs = composite_param_specs(model)
    return [specs[name] for name in trainable_names(model)]


def create_state(model: ParlerTTSModel, mesh: Mesh | None = None, **optimizer_kwargs) -> TrainState:
    """Mark the trainable subtrees and build their optimizer
    (``optimizer_kwargs`` go to ``make_optimizer``) over the model's shards
    when ``mesh`` splits it."""
    set_trainable(model)
    if mesh is not None and mesh.model > 1:
        optimizer_kwargs.update(split=[d is not None for d in trainable_dims(model)],
                                model_group=mesh.model_group)
    return TrainState(model, make_optimizer(trainable_parameters(model), **optimizer_kwargs))


def has_dropout(cfg: ParlerTTSConfig) -> bool:
    d = cfg.decoder
    return any(r > 0.0 for r in (d.dropout, d.attention_dropout, d.activation_dropout, d.layerdrop))


def dropout_generator(seed: int, step: int, data_rank: int = 0) -> torch.Generator:
    """A host generator seeded from (``seed``, ``step``, ``data_rank``); the
    model ranks of one data rank share it, so their masks on replicated
    activations agree."""
    mixed = np.random.SeedSequence([seed, step] + ([data_rank] if data_rank else [])).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def _host_tensors(batch: dict) -> dict[str, torch.Tensor]:
    """The batch's ``BATCH_KEYS`` as tensors, where they are."""
    return {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            for k, v in ((k, batch.get(k)) for k in BATCH_KEYS) if v is not None}


def _to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: t.to(device) for k, t in _host_tensors(batch).items()}


def _device(model: ParlerTTSModel) -> torch.device:
    return model.decoder.embed_tokens.embedding.device


def _sum_over(tensors: list[torch.Tensor], group) -> None:
    """All-reduce (sum) each tensor in place over ``group``, all in flight
    together."""
    for work in [torch.distributed.all_reduce(t, group=group, async_op=True) for t in tensors]:
        work.wait()


def _grads(loss: torch.Tensor, params: list[torch.Tensor]) -> list[torch.Tensor]:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    # a layer that layerdrop skipped has no grad: zero, as in JAX
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


class _Captured:
    """One signature's captured step: static inputs shaped as the batch,
    0-d static outputs, ``fn`` (set by the caller: the step over them), its
    program once captured, its bytes (pool and inputs) and, for a train
    step with dropout, its ``TrainRandom``."""

    def __init__(self, tensors: dict[str, torch.Tensor], device: torch.device, outputs: tuple[str, ...]):
        self.device = device
        self.inputs = {k: torch.empty(t.shape, dtype=t.dtype, device=device) for k, t in tensors.items()}
        self.outputs = {name: torch.zeros((), device=device) for name in outputs}
        self.fn: Callable[[], None] | None = None
        self.random: TrainRandom | None = None
        self.program: graphs.Program | None = None
        self.nbytes = 0

    def generators(self) -> list[torch.Generator]:
        r = self.random
        return [] if r is None else [g for rng in (*r.layers, r.embed) for g in rng.gens]

    def run(self, tensors: dict[str, torch.Tensor], programs: graphs.Programs, key: tuple) -> dict[str, torch.Tensor]:
        """``fn`` over ``tensors`` copied into the static inputs: captured at
        the signature's first run, whose warm-up is this run's step, and
        replayed after.  Returns copies of the outputs."""
        for k, t in tensors.items():
            self.inputs[k].copy_(t)
        if self.program is None:
            self.program = graphs.capture(self.fn, generators=self.generators())
            self.nbytes = self.program.nbytes + sum(x.numel() * x.element_size() for x in self.inputs.values())
            programs.add(key, self, self.program.seconds, graphs.budget(self.device))
        else:
            self.program.replay()
            programs.replays += 1
        return {name: out.clone() for name, out in self.outputs.items()}


def _signature(model: ParlerTTSModel, tensors: dict[str, torch.Tensor], *extra) -> tuple:
    """A captured step's key: its inputs' shapes and dtypes, ``extra``, and
    the addresses of the model's tensors, which its graph reads."""
    return (tuple((k, tuple(t.shape), t.dtype) for k, t in tensors.items()), *extra,
            tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers())))


def _replayed_random(layers: int, layerdrop: float, remat: bool, device: torch.device) -> TrainRandom:
    """A captured signature's ``TrainRandom``: generators made once, two per
    layer with remat (its forward's and its recomputation's), and with
    layerdrop a mask on the device."""
    def rng(n: int) -> ReplayedRng:
        return ReplayedRng([torch.Generator(device=device) for _ in range(n)])

    keep = torch.ones(layers, dtype=torch.bool, device=device) if layerdrop > 0.0 else None
    return TrainRandom([rng(2 if remat else 1) for _ in range(layers)], rng(1), keep)


def _seed(random: TrainRandom, generator: torch.Generator, layerdrop: float) -> None:
    """The eager step's draws from ``generator`` (``train_draws``), put where
    a captured step reads them: each rng's generators seeded with its seed
    and its count of uses reset, the layerdrop mask copied to the device."""
    rngs = (*random.layers, random.embed)
    seeds, keep = train_draws(generator, len(random.layers), layerdrop)
    for rng, seed in zip(rngs, seeds):
        rng.calls = 0
        for g in rng.gens:
            g.manual_seed(seed)
    if keep is not None:
        random.keep.copy_(torch.tensor(keep))


def make_train_step(cfg: ParlerTTSConfig, *, dtype: torch.dtype = torch.bfloat16,
                    dropout_seed: int | None = None, remat: bool = False,
                    mesh: Mesh | None = None) -> Callable[..., dict[str, Any]]:
    """Returns ``step(state, batch, timings=None) -> metrics``.

    ``batch`` holds numpy arrays or tensors: input_ids, attention_mask,
    prompt_input_ids, prompt_attention_mask, labels (B, K, T) and optionally
    decoder_attention_mask.  The step updates ``state`` in place and
    returns ``loss``, ``grad_norm`` (before clipping; 0-d tensors on the
    model's device) and ``step`` (the index this step ran at).  With a
    ``timings`` dict it synchronises the device and records the eager
    step's ``forward_ms``, ``backward_ms`` and ``optimizer_ms``, or the
    captured step's ``step_ms``, there.

    With a ``mesh``, ``batch`` is this data rank's rows of the global batch,
    and ``loss`` and the update are the global batch's.  The module
    docstring says which route a step takes."""
    use_dropout = dropout_seed is not None and has_dropout(cfg)
    data_group = None if mesh is None else mesh.data_group
    groups = () if mesh is None else (mesh.data_group, mesh.model_group)  # what a step sums over
    data_rank = 0 if mesh is None else mesh.data_index

    def eager(state: TrainState, batch: dict, timings: dict | None) -> dict[str, Any]:
        device = _device(state.model)
        clock = _Clock(device, timings)
        gen = dropout_generator(dropout_seed, state.step, data_rank) if use_dropout else None
        params = state.optimizer.params
        loss, _ = state.model.train_forward(**_to_device(batch, device), generator=gen, remat=remat,
                                            dtype=dtype, count_group=data_group)
        clock.mark("forward_ms")
        grads = _grads(loss, params)
        loss = loss.detach()
        if data_group is not None:  # this rank's share -> the global batch's
            _sum_over(grads + [loss], data_group)
        grad_norm = state.optimizer.norm(grads)
        clock.mark("backward_ms")
        state.optimizer.update(grads, grad_norm)
        clock.mark("optimizer_ms")
        return {"loss": loss, "grad_norm": grad_norm}

    def captured(state: TrainState, batch: dict, timings: dict | None) -> dict[str, Any]:
        model, opt = state.model, state.optimizer
        device, layerdrop = _device(model), model.decoder.cfg.layerdrop
        clock = _Clock(device, timings)
        tensors = _host_tensors(batch)
        updates = opt.stage()
        key = _signature(model, tensors, "train", dtype, remat, use_dropout, updates, id(opt))
        program = state.graphs.get(key)
        if program is None:
            program = _Captured(tensors, device, ("loss", "grad_norm"))
            if use_dropout:
                program.random = _replayed_random(len(model.decoder.layers), layerdrop, remat, device)

            def fn() -> None:
                loss, _ = model.train_forward(**program.inputs, train_random=program.random, remat=remat,
                                              dtype=dtype)
                grads = _grads(loss, opt.params)
                grad_norm = opt.norm(grads)
                opt.apply(grads, grad_norm, updates)
                program.outputs["loss"].copy_(loss.detach())
                program.outputs["grad_norm"].copy_(grad_norm)
            program.fn = fn
        if program.random is not None:
            _seed(program.random, dropout_generator(dropout_seed, state.step), layerdrop)
        out = program.run(tensors, state.graphs, key)
        opt.advance(updates)
        clock.mark("step_ms")
        return out

    def step(state: TrainState, batch: dict, timings: dict | None = None) -> dict[str, Any]:
        run = captured if graphs.capturable(_device(state.model), groups) else eager
        metrics = {**run(state, batch, timings), "step": state.step}
        state.step += 1
        return metrics

    return step


def _eval_graphs(model: ParlerTTSModel) -> graphs.Programs:
    return model.__dict__.setdefault("_eval_graphs", graphs.Programs())


def make_eval_step(cfg: ParlerTTSConfig, *, dtype: torch.dtype = torch.bfloat16, mesh: Mesh | None = None):
    """Loss-only eval pass: ``step(model, batch) -> {"loss"}``; with a
    ``mesh``, ``batch`` is this data rank's rows and the loss the global
    batch's.  On the captured route (module docstring) each batch shape's
    pass is a graph kept on the model."""
    del cfg  # the model carries its config; kept for the JAX signature
    data_group = None if mesh is None else mesh.data_group
    groups = () if mesh is None else (mesh.data_group, mesh.model_group)

    @torch.no_grad()
    def step(model: ParlerTTSModel, batch: dict) -> dict[str, torch.Tensor]:
        if graphs.capturable(_device(model), groups):
            tensors, programs = _host_tensors(batch), _eval_graphs(model)
            key = _signature(model, tensors, "eval", dtype)
            program = programs.get(key)
            if program is None:
                program = _Captured(tensors, _device(model), ("loss",))
                program.fn = lambda: program.outputs["loss"].copy_(
                    model.train_forward(**program.inputs, dtype=dtype)[0])
            return program.run(tensors, programs, key)
        loss, _ = model.train_forward(**_to_device(batch, _device(model)), dtype=dtype, count_group=data_group)
        if data_group is not None:
            torch.distributed.all_reduce(loss, group=data_group)
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
