"""Tensor parallelism as explicit collectives: the Megatron pair and the
vocab gather.

GSPMD inserts these implicitly in the JAX package (``parler_tts_tpu/
parallel/mesh.py`` only names where each parameter lives).  Here a model
that ``parallel/mesh.shard_params`` sliced holds plain tensors with this
rank's shard, and its forward calls, around each split projection:

* :func:`copy` before a column-split projection (q, k, v, fc1, T5's wi, the
  LM heads): identity forward, all-reduce of the gradient backward, since
  each rank's shard adds only its part to the input's gradient;
* :func:`reduce` after a row-split projection (o, fc2, T5's wo): all-reduce
  of the partial sums forward, identity backward;
* :func:`gather` of vocab-split logits: all-gather forward; backward keeps
  this rank's slice of the gradient.

Every function is the identity when the group is None (one model rank).
Beside them, :func:`all_reduce_max` gives the int8 decode view the scales of
a row-split kernel (the max over the whole input dimension, as GSPMD's
``amax`` over a sharded axis is), and :func:`check_same` holds the model
ranks of a decode loop in lockstep.
The sums run in fp32 whatever the activations' dtype: a bf16 all-reduce
would round each partial sum once more than the unsplit product does, and
gloo (the CPU tests, and the one-card checks) may not take bf16.  Only
``all_reduce`` and ``all_gather`` are used: gloo has no ``reduce_scatter``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist


@dataclasses.dataclass(frozen=True, eq=False)
class ModelGroup:
    """The ranks that split one model replica's weights (``parallel/mesh``'s
    model axis): the process group, this rank's index in it and its size.
    A copied module keeps the same group (``copy.deepcopy`` of a model
    shares it instead of copying a process group)."""

    group: tdist.ProcessGroup
    index: int
    size: int

    def __deepcopy__(self, memo) -> "ModelGroup":
        return self


def _all_reduce(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    y = x.float().contiguous() if x.dtype != torch.float32 else x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(y, group=group.group)
    return y.to(x.dtype)


def all_reduce_max(x: torch.Tensor, group: ModelGroup | None) -> torch.Tensor:
    """The element-wise max of ``x`` over the group (exact in any dtype: a
    max rounds nothing); ``x`` itself without a group."""
    if group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(y, op=tdist.ReduceOp.MAX, group=group.group)
    return y


def check_same(x: torch.Tensor, group: ModelGroup | None, what: str) -> None:
    """Raise on every rank unless every rank of the group holds the same
    ``x`` (a small integer tensor: a loop position, a checksum).  A model
    rank whose decode loop left the others would leave them waiting in a
    collective; this check stops them all at once instead."""
    if group is None:
        return
    ranks = all_gather_cat(x.reshape(1, -1), 0, group)
    if not bool((ranks == ranks[:1]).all()):
        raise RuntimeError(f"the model ranks disagree on {what}: {ranks.tolist()} (rank order)")


def all_gather_cat(x: torch.Tensor, dim: int, group: ModelGroup) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim``, in rank
    order, in ``x``'s dtype (moved as fp32 when it is another float type)."""
    send = x.float().contiguous() if x.is_floating_point() and x.dtype != torch.float32 else x.contiguous()
    parts = [torch.empty_like(send) for _ in range(group.size)]
    tdist.all_gather(parts, send, group=group.group)
    return torch.cat(parts, dim=dim).to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.group.index * ctx.size, ctx.size).contiguous(), None, None


def copy(x: torch.Tensor, group: ModelGroup | None) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient backward (before a
    column-split projection)."""
    return x if group is None else _Copy.apply(x, group)


def reduce(x: torch.Tensor, group: ModelGroup | None) -> torch.Tensor:
    """All-reduce forward, identity backward (after a row-split
    projection)."""
    return x if group is None else _Reduce.apply(x, group)


def gather(x: torch.Tensor, dim: int, group: ModelGroup | None) -> torch.Tensor:
    """All-gather along ``dim`` forward; backward takes this rank's slice."""
    return x if group is None else _Gather.apply(x, dim, group)
