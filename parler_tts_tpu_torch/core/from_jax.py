"""Carry the JAX package's parameters into the port's modules.

``tree`` is a JAX parameter pytree with numpy leaves (e.g.
``jax.tree.map(np.asarray, parler.init(key, cfg))``, built by the caller;
this module imports nothing of JAX).  The port's parameter names follow the
tree's keys, so most leaves copy as they are.  The layout changes:

* decoder layers are stacked on a leading ``L`` axis in the tree and are
  separate ``layers.{i}`` modules here;
* codec conv kernels (encoder and decoder) are WIO and become torch
  ``Conv1d`` weights, and the ``conv_up`` kernels, stored time-flipped and
  in/out-swapped, become ``ConvTranspose1d`` weights (``ops/conv.py`` holds
  both converters);
* an EnCodec LSTM layer's ``wi`` (C, 4H) and ``wh`` (H, 4H) become
  ``nn.LSTM``'s ``weight_ih_l{k}`` / ``weight_hh_l{k}`` (transposed), its
  folded ``bias`` becomes ``bias_ih_l{k}`` and ``bias_hh_l{k}`` is zero.

Every other leaf must match a parameter, and every parameter a leaf.

``to_jax_tree`` goes the other way for the subtrees training updates: the
port's parameters, or their gradients, become a numpy tree in the JAX
layout, so tests can hold them against ``jax.grad``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch import nn

from parler_tts_tpu_torch.models.dac import DAC
from parler_tts_tpu_torch.models.decoder import ParlerDecoder
from parler_tts_tpu_torch.models.encodec import Encodec
from parler_tts_tpu_torch.models.parler import TRAINABLE_KEYS, ParlerTTSModel
from parler_tts_tpu_torch.ops import conv as conv_ops

Entry = tuple[tuple[str, ...], torch.Tensor]


def _flatten(tree, prefix: tuple[str, ...] = ()) -> Iterator[Entry]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, prefix + (str(i),))
    else:
        yield prefix, torch.from_numpy(np.array(tree))


def _decoder_entries(tree) -> Iterator[Entry]:
    for path, t in _flatten(tree):
        if path[0] == "layers":
            for i in range(t.shape[0]):
                yield ("layers", str(i), *path[1:]), t[i]
        else:
            yield path, t


def _codec_entries(tree) -> Iterator[Entry]:
    for path, t in _flatten(tree):
        if path[0] in ("encoder", "decoder") and path[1] == "lstm":
            side, _, k, leaf = path
            if leaf == "bias":  # b_ih + b_hh folded: all of it in b_ih
                yield (side, "lstm", f"bias_ih_l{k}"), t
                yield (side, "lstm", f"bias_hh_l{k}"), torch.zeros_like(t)
            else:
                yield (side, "lstm", f"weight_{'ih' if leaf == 'wi' else 'hh'}_l{k}"), t.T
            continue
        if path[0] in ("encoder", "decoder") and path[-1] == "kernel":
            if path[-2] == "conv_up":
                t = conv_ops.torch_conv_transpose1d_weight(t)
            else:
                t = conv_ops.torch_conv1d_weight(t)
            path = (*path[:-1], "weight")
        yield path, t


def _entries(module: nn.Module | None, tree) -> Iterator[Entry]:
    if isinstance(module, ParlerTTSModel):
        for key, sub in tree.items():
            for path, t in _entries(getattr(module, key, None), sub):
                yield (key, *path), t
    elif isinstance(module, ParlerDecoder):
        yield from _decoder_entries(tree)
    elif isinstance(module, (DAC, Encodec)):
        yield from _codec_entries(tree)
    else:
        yield from _flatten(tree)


@torch.no_grad()
def load_jax_params(model: nn.Module, tree) -> None:
    """Copy ``tree`` into ``model`` (a ``ParlerTTSModel``, or one of its
    parts given that part's subtree), casting to the model's dtype.  Raises
    on a missing or extra leaf or a shape mismatch."""
    entries = {".".join(path): t for path, t in _entries(model, tree)}
    state = model.state_dict()
    missing, extra = sorted(set(state) - set(entries)), sorted(set(entries) - set(state))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, extra {extra}")
    for name, t in entries.items():
        if t.shape != state[name].shape:
            raise ValueError(f"{name}: JAX leaf {tuple(t.shape)} vs port {tuple(state[name].shape)}")
        state[name].copy_(t)


def _nest(flat: dict[tuple[str, ...], np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


@torch.no_grad()
def to_jax_tree(model: ParlerTTSModel, keys=TRAINABLE_KEYS, *, grads: bool = False) -> dict:
    """The ``keys`` subtrees of ``model`` as an fp32 numpy tree in the JAX
    layout (decoder layers stacked on a leading L axis): the parameters, or
    with ``grads`` their ``.grad`` (zeros where a parameter has none)."""
    tree = {}
    for key in keys:
        part = getattr(model, key, None)
        if part is None:
            continue
        flat, layers = {}, {}
        for name, p in part.named_parameters():
            t = p.grad if grads else p
            value = (torch.zeros_like(p) if t is None else t).float().cpu().numpy()
            path = tuple(name.split("."))
            if isinstance(part, ParlerDecoder) and path[0] == "layers":
                layers.setdefault(path[2:], {})[int(path[1])] = value
            else:
                flat[path] = value
        for path, per_layer in layers.items():
            flat[("layers", *path)] = np.stack([per_layer[i] for i in range(len(per_layer))])
        tree[key] = _nest(flat)
    return tree
