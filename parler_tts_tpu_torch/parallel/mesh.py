"""The (data, model) process layout and where each parameter lives.

Port of ``parler_tts_tpu/parallel/mesh.py``.  Two axes:

* ``data``: batch parallelism.  Each data rank takes its rows of the global
  batch; the train step sums the loss terms and the gradients over the data
  group (``training/step.py``).
* ``model``: tensor parallelism over attention heads, FFN columns and the
  vocabulary, for decoders that do not fit one card (``large_2b_config``).

The JAX package names each parameter's placement with a ``PartitionSpec``
tree and lets GSPMD insert the collectives.  Here the specs are a dict from
each parameter's name to the dimension split over ``model`` (None:
replicated), the same placement leaf for leaf: q, k, v and fc1 (T5: wi,
wi_0, wi_1) split their output features, o and fc2 (T5: wo) their input
features, the LM heads their vocabulary; everything else, the codec and
``enc_to_dec_proj`` included, is replicated.  ``shard_params`` slices each
split parameter to this rank's shard in place and hands the model its
``ModelGroup``, whose collectives the forward calls
(``parallel/tensor_parallel.py``); ``gather_params`` puts the full tensors
back together (Orbax does that for the JAX package), so checkpoints and the
artifact do not depend on the layout.

Ranks are laid out as JAX's ``make_mesh`` reshapes devices: ``(data,
model)``, model-contiguous, so rank ``r`` is data rank ``r // model`` and
model rank ``r % model``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as tdist
from torch import nn

from parler_tts_tpu_torch.parallel import distributed as dist
from parler_tts_tpu_torch.parallel.tensor_parallel import ModelGroup, all_gather_cat

DATA_AXIS = "data"
MODEL_AXIS = "model"

Specs = dict[str, "int | None"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a (data, model) layout of ``data * model``
    processes, and the groups it belongs to (None for an axis of one rank:
    nothing is summed or gathered over it)."""

    data: int
    model: int
    rank: int = 0
    data_group: tdist.ProcessGroup | None = None
    model_group: ModelGroup | None = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The (data, model) layout over every process; ``data`` None takes all
    of them.  Every process must call it, in the same order as the others
    (each creates every group).  Raises unless ``data * model`` is the
    number of processes."""
    n = dist.process_count()
    if data is None:
        if n % model:
            raise ValueError(f"{n} processes do not divide by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"a mesh of data={data} x model={model} needs {data * model} processes, there are {n}")
    rank = dist.process_index()
    data_group = model_group = None
    if model > 1:
        for d in range(data):
            ranks = [d * model + m for m in range(model)]
            group = dist.new_group(ranks)
            if rank in ranks:
                model_group = ModelGroup(group, rank % model, model)
    if data > 1:
        for m in range(model):
            ranks = [d * model + m for d in range(data)]
            group = dist.new_group(ranks)
            if rank in ranks:
                data_group = group
    return Mesh(data, model, rank, data_group, model_group)


def single_device_mesh() -> Mesh:
    return Mesh(1, 1)


# ---------------------------------------------------------------------------
# Parameter specs: the dimension each parameter splits over ``model``
# ---------------------------------------------------------------------------


def _attn(prefix: str) -> Specs:
    """q, k, v split output features (heads); o splits input features."""
    return {f"{prefix}.q.kernel": 1, f"{prefix}.k.kernel": 1, f"{prefix}.v.kernel": 1, f"{prefix}.o.kernel": 0}


def _replicated(module: nn.Module) -> Specs:
    return {name: None for name, _ in module.named_parameters()}


def decoder_param_specs(decoder: nn.Module) -> Specs:
    """Specs of a ``models/decoder.ParlerDecoder``'s parameters (names as
    ``decoder.named_parameters()`` gives them; JAX stacks the layers on a
    leading axis, so its split axis is one more)."""
    specs = _replicated(decoder)
    for i in range(len(decoder.layers)):
        specs |= _attn(f"layers.{i}.self_attn") | _attn(f"layers.{i}.cross_attn")
        specs |= {f"layers.{i}.fc1.kernel": 1, f"layers.{i}.fc2.kernel": 0}
    specs["lm_heads.kernel"] = 2
    return specs


def t5_param_specs(encoder: nn.Module) -> Specs:
    """Specs of a ``models/t5_encoder.T5Encoder``'s parameters.  The
    relative-position table is replicated; each rank reads its heads'
    columns (``T5Encoder.position_bias``)."""
    specs = _replicated(encoder)
    for i, layer in enumerate(encoder.layers):
        specs |= _attn(f"layers.{i}.attn")
        wi = ("wi_0", "wi_1") if layer.ffn.gated else ("wi",)
        specs |= {f"layers.{i}.ffn.{w}.kernel": 1 for w in wi} | {f"layers.{i}.ffn.wo.kernel": 0}
    return specs


def composite_param_specs(model: nn.Module) -> Specs:
    """Specs of a ``models/parler.ParlerTTSModel``'s parameters:
    ``text_encoder.*`` and ``decoder.*`` by the functions above;
    ``embed_prompts``, ``enc_to_dec_proj`` and the codec replicated."""
    specs = _replicated(model)
    for key, fn in (("text_encoder", t5_param_specs), ("decoder", decoder_param_specs)):
        specs |= {f"{key}.{name}": dim for name, dim in fn(getattr(model, key)).items()}
    return specs


def _check_covers(specs: Specs, module: nn.Module) -> None:
    names = {name for name, _ in module.named_parameters()}
    if set(specs) != names:
        raise ValueError(f"specs and parameters differ: missing {sorted(names - set(specs))}, "
                         f"extra {sorted(set(specs) - names)}")


def shard_tensor(t: torch.Tensor, dim: int | None, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of a full tensor along ``dim`` (None, or one
    model rank: ``t`` itself).  Raises when ``dim`` does not divide by
    ``model``."""
    if dim is None or mesh.model == 1:
        return t
    n = t.shape[dim]
    if n % mesh.model:
        raise ValueError(f"dimension {dim} of size {n} does not divide by model={mesh.model}")
    size = n // mesh.model
    return t.narrow(dim, mesh.model_index * size, size).contiguous()


def gather_tensor(t: torch.Tensor, dim: int | None, mesh: Mesh) -> torch.Tensor:
    """The full tensor from the model ranks' shards along ``dim`` (a
    collective over the model group; every model rank calls it)."""
    if dim is None or mesh.model == 1:
        return t
    return all_gather_cat(t, dim, mesh.model_group)


def _heads_divide(model: nn.Module, m: int) -> None:
    cfg = model.cfg
    for what, heads in (("decoder", cfg.decoder.num_attention_heads), ("text encoder", cfg.text_encoder.num_heads)):
        if heads % m:
            raise ValueError(f"the {what}'s {heads} heads do not divide by model={m}")


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh, specs: Specs | None = None) -> nn.Module:
    """Slice every split parameter of a ``ParlerTTSModel`` to this model
    rank's shard, in place (the ``Parameter`` objects stay, so build the
    optimizer after), and hand the decoder and the text encoder their
    ``ModelGroup`` (with one model rank there is nothing to do).  Raises
    when a split dimension, or a head count, does not divide by ``model``.
    Returns ``model``."""
    specs = composite_param_specs(model) if specs is None else specs
    _check_covers(specs, model)
    _heads_divide(model, mesh.model)
    if mesh.model_group is None:
        return model
    for name, p in model.named_parameters():
        p.data = shard_tensor(p.data, specs[name], mesh)
    for module in model.modules():
        if hasattr(module, "model_group"):
            module.model_group = mesh.model_group
    return model


@torch.no_grad()
def gather_params(model: nn.Module, mesh: Mesh, specs: Specs | None = None,
                  keep: Callable[[str], bool] = lambda name: True) -> dict[str, torch.Tensor]:
    """The model's state_dict with every split parameter gathered to its
    full tensor (a collective over the model group: every model rank calls
    it), restricted to the names ``keep`` accepts."""
    specs = composite_param_specs(model) if specs is None else specs
    return {name: gather_tensor(t, specs.get(name), mesh) for name, t in model.state_dict().items() if keep(name)}


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This data rank's rows of every array in a global batch (split on the
    leading axis)."""
    def rows(x):
        n = x.shape[0]
        if n % mesh.data:
            raise ValueError(f"a batch of {n} rows does not divide by data={mesh.data}")
        size = n // mesh.data
        return x[mesh.data_index * size:(mesh.data_index + 1) * size]

    return {k: rows(v) for k, v in batch.items()}
