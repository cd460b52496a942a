"""Several processes: joining the group, per-process data shards, barriers
and host-side gathers.

Port of ``parler_tts_tpu/parallel/distributed.py`` over ``torch.distributed``:

* ``initialize()``          joins the process group that
                            ``python -m torch.distributed.run`` describes
                            (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
                            ``MASTER_ADDR`` / ``MASTER_PORT``) and picks
                            this rank's device;
* ``process_shard(seq)``    this process's strided share of a dataset;
* ``barrier(tag)``          every process waits for the others;
* ``main_process_first()``  process 0 runs the body first;
* ``host_local_to_global``  this rank's rows, on its device;
* ``all_gather_metrics``, ``global_max`` / ``global_min`` /
  ``global_sum``, ``allgather_object``, ``gather_prepared``: host values
  gathered from every process.

In the port each process drives one card.  A data-parallel rank holds only
its rows of the global batch, and the train step sums the gradients over
the data group (``training/step.py``), where the JAX package assembles one
global array.  Without a process group every function gives the
single-process answer, so the same script runs everywhere; with one (of
one process too, as ``torch.distributed.run --nproc_per_node=1`` makes),
every gather and barrier goes through it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from parler_tts_tpu_torch.core.device import resolve_device


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def initialize(backend: str | None = None, *, device: str | torch.device = "cuda", init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None) -> torch.device:
    """Join the process group and return this rank's device.

    The group is joined from ``init_method`` / ``rank`` / ``world_size`` when
    given, else from torchrun's variables (a one-process torchrun run joins
    a group of one); it is a no-op when neither is there, and when a group
    already exists (as the JAX function is when a runtime exists).  ``backend`` defaults to ``nccl``
    for CUDA and ``gloo`` for the CPU.  A CUDA rank uses
    ``cuda:{LOCAL_RANK % device_count}`` (several ranks share a card when
    there are fewer cards than ranks; NCCL refuses that, gloo does not)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if is_initialized():
        return dev
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return dev
        world_size = int(os.environ["WORLD_SIZE"])
    rank = rank if rank is not None else int(os.environ["RANK"])
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    tdist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world_size)
    return dev


def process_index() -> int:
    return tdist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if is_initialized() else 1


_index, _count = process_index, process_count


def process_shard(items: Sequence, *, process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """This process's strided shard of a dataset."""
    pi = _index() if process_index is None else process_index
    pc = _count() if process_count is None else process_count
    return list(items[pi::pc])


def barrier(tag: str = "barrier") -> None:
    """Every process waits here for the others (``tag`` names the point in
    a traceback)."""
    del tag
    if is_initialized():
        tdist.barrier()


@contextlib.contextmanager
def main_process_first(tag: str = "main_first"):
    """Process 0 runs the body first (cache writes); the others wait, then
    run it.  Yields whether this is process 0."""
    if process_index() == 0:
        try:
            yield True
        finally:
            barrier(tag)
    else:
        barrier(tag)
        yield False


def host_local_to_global(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """This rank's rows of a global batch, as tensors on its device (the
    JAX function assembles one global array instead)."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(device) for k, v in batch.items()}


def allgather_object(obj: Any, group: tdist.ProcessGroup | None = None) -> list[Any]:
    """Every process's ``obj`` (picklable), in rank order; over ``group``
    when given, else over all processes."""
    if not is_initialized():
        return [obj]
    out: list[Any] = [None] * tdist.get_world_size(group)
    tdist.all_gather_object(out, obj, group=group)
    return out


def all_gather_metrics(metrics: dict, weight: float = 1.0) -> dict:
    """Weighted mean of scalar metrics over processes: ``weight`` is this
    process's sample count.  Processes may report different keys (an empty
    shard reports ``{}``); each key is averaged over the processes that
    reported it."""
    shards = allgather_object(({k: float(v) for k, v in metrics.items()}, float(weight)))
    out: dict[str, float] = {}
    for key in sorted({k for m, _ in shards for k in m}):
        num = sum(m[key] * w for m, w in shards if key in m)
        den = sum(w for m, w in shards if key in m)
        out[key] = float(num / max(den, 1e-9))
    return out


def _allreduce(values: Sequence[float], op) -> list[float]:
    gathered = np.asarray(allgather_object([float(v) for v in values]), np.float64)
    return op(gathered, axis=0).tolist()


def global_max(values: Sequence[float]) -> list[float]:
    """Element-wise max over processes (the collator's shapes agree)."""
    return _allreduce(values, np.max)


def global_min(values: Sequence[float]) -> list[float]:
    """Element-wise min over processes (lockstep loop bounds)."""
    return _allreduce(values, np.min)


def global_sum(values: Sequence[float]) -> list[float]:
    """Element-wise sum over processes."""
    return _allreduce(values, np.sum)


def gather_prepared(samples: list[dict], group: tdist.ProcessGroup | None = None) -> list[dict]:
    """The processes' prepared-sample shards merged into one list in source
    order (each sample's ``_idx``, its raw row index); every process of
    ``group`` (default: all) returns the same list."""
    merged = [s for shard in allgather_object(samples, group) for s in shard]
    merged.sort(key=lambda s: s.get("_idx", 0))
    return merged
