"""Checkpoints (save, load, rotate, resume) and the model artifact.

Port of ``parler_tts_tpu/core/checkpoint.py`` with torch storage in place of
Orbax:

* checkpoint directories are ``checkpoint-{step}-epoch-{epoch}``, found by
  the same regex, sorted by step and rotated to the newest
  ``save_total_limit``, as in the JAX package;
* a train-state checkpoint holds ``state.pt`` (``torch.save``; read back
  with ``weights_only=True``): ``params``, the trainable subtrees'
  state_dict, and ``opt_state``, ``training.optim.Optimizer.state_dict()``;
  beside it ``trainer_state.json`` with the JAX keys (``step``, ``epoch``,
  ``micro_in_epoch``);
* the model artifact holds ``config.json``, ``generation_config.json`` and
  ``preprocessor_config.json``, each byte for byte what the JAX
  ``save_model`` writes for the same config, and ``weights.pt``, the whole
  model's state_dict (loaded with ``strict=True``), and the tokenizer's
  files when ``save_model`` is given one (``utils/tokenizer.Tokenizer``:
  ``tokenizer.json`` and its two JSON companions); the converters copy a
  source directory's tokenizer and feature-extractor files beside the
  artifact (``carry_side_files``).

Tensors are copied to the CPU before they are written.  Both formats hold
full tensors whatever the process layout: a model split over a model group
(``parallel/mesh.py``) is gathered before it is written, and sliced after it
is read, so a checkpoint saved under one layout resumes under another.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import torch

from parler_tts_tpu_torch.core.config import GenerationConfig, ParlerTTSConfig
from parler_tts_tpu_torch.core.device import resolve_device
from parler_tts_tpu_torch.models.parler import TRAINABLE_KEYS, ParlerTTSModel
from parler_tts_tpu_torch.parallel.mesh import (Mesh, composite_param_specs, gather_params, shard_params, shard_tensor,
                                                single_device_mesh)

_CKPT_RE = re.compile(r"checkpoint-(\d+)-epoch-(\d+)")
STATE_FILE = "state.pt"
WEIGHTS_FILE = "weights.pt"


def checkpoint_name(step: int, epoch: int) -> str:
    return f"checkpoint-{step}-epoch-{epoch}"


def sorted_checkpoints(output_dir: str) -> list[str]:
    """Checkpoint directories in ``output_dir``, oldest step first."""
    if not os.path.isdir(output_dir):
        return []
    found = []
    for name in os.listdir(output_dir):
        m = _CKPT_RE.fullmatch(name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            found.append((int(m.group(1)), os.path.join(output_dir, name)))
    return [p for _, p in sorted(found)]


def latest_checkpoint(output_dir: str) -> str | None:
    ckpts = sorted_checkpoints(output_dir)
    return ckpts[-1] if ckpts else None


def parse_step_epoch(path: str) -> tuple[int, int]:
    m = _CKPT_RE.search(os.path.basename(os.path.normpath(path)))
    if not m:
        raise ValueError(f"not a checkpoint dir: {path}")
    return int(m.group(1)), int(m.group(2))


def rotate_checkpoints(output_dir: str, save_total_limit: int | None) -> None:
    """Delete the oldest checkpoints beyond ``save_total_limit``."""
    if not save_total_limit or save_total_limit <= 0:
        return
    ckpts = sorted_checkpoints(output_dir)
    for path in ckpts[: max(0, len(ckpts) - save_total_limit)]:
        shutil.rmtree(path, ignore_errors=True)


def _cpu(obj: Any) -> Any:
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _save(obj: Any, path: str) -> None:
    """``torch.save`` to a temporary name, then rename: a run killed while
    writing leaves no half-written file under the final name."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _trainable(name: str) -> bool:
    return name.split(".", 1)[0] in TRAINABLE_KEYS


def trainable_state_dict(model: ParlerTTSModel, mesh: Mesh | None = None) -> dict[str, torch.Tensor]:
    """The ``TRAINABLE_KEYS`` subtrees' entries of the model's state_dict;
    with a ``mesh`` that splits the model, gathered to full tensors (a
    collective: every model rank calls it)."""
    if mesh is not None and mesh.model > 1:
        return gather_params(model, mesh, keep=_trainable)
    return {k: v for k, v in model.state_dict().items() if _trainable(k)}


def restore_params(model: ParlerTTSModel, params: dict[str, torch.Tensor], mesh: Mesh | None = None) -> None:
    """Copy a checkpoint's ``params`` (full tensors) into ``model``'s
    trainable subtrees, each sliced to this rank's shard when ``mesh``
    splits the model; the names must be exactly theirs."""
    own = {k: v for k, v in model.state_dict().items() if _trainable(k)}
    missing, extra = sorted(set(own) - set(params)), sorted(set(params) - set(own))
    if missing or extra:
        raise ValueError(f"checkpoint parameters differ from the model's: missing {missing}, extra {extra}")
    specs, mesh = composite_param_specs(model), mesh or single_device_mesh()
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(shard_tensor(params[name], specs[name], mesh))


def save_train_state(path: str, *, params: dict[str, torch.Tensor], opt_state: dict | None = None,
                     step: int = 0, epoch: int = 0, extra: dict | None = None) -> None:
    """Write ``state.pt`` (``params`` and, when given, ``opt_state``) and
    ``trainer_state.json`` (``step``, ``epoch`` and ``extra``) under
    ``path``."""
    os.makedirs(path, exist_ok=True)
    payload = {"params": _cpu(params)}
    if opt_state is not None:
        payload["opt_state"] = _cpu(opt_state)
    _save(payload, os.path.join(path, STATE_FILE))
    meta = {"step": int(step), "epoch": int(epoch), **(extra or {})}
    with open(os.path.join(path, "trainer_state.json"), "w") as f:
        json.dump(meta, f)


def load_train_state(path: str) -> tuple[dict, dict]:
    """-> (payload {params[, opt_state]} with CPU tensors, meta {step,
    epoch, ...})."""
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    meta_path = os.path.join(path, "trainer_state.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return payload, meta


def save_model(path: str, model: ParlerTTSModel, cfg: ParlerTTSConfig, gen: GenerationConfig | None = None, *,
               tokenizer: Any = None, mesh: Mesh | None = None) -> None:
    """The model artifact: the three JSON files as the JAX ``save_model``
    writes them (``preprocessor_config.json`` is its EnCodec-feature-extractor
    record of the codec's audio contract), ``weights.pt``, and
    ``tokenizer.save_pretrained(path)`` when a tokenizer is given (the JAX package saves one, prompts and
    descriptions sharing it).  With a ``mesh``, every rank calls it: the
    split parameters are gathered, and rank 0 alone writes."""
    state = model.state_dict()
    if mesh is not None:
        if mesh.model > 1:
            state = gather_params(model, mesh)
        if mesh.rank != 0:
            return
    os.makedirs(path, exist_ok=True)
    cfg.save(os.path.join(path, "config.json"))
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump((gen or GenerationConfig()).to_dict(), f, indent=2)
    if tokenizer is not None:
        tokenizer.save_pretrained(path)
    acfg = cfg.audio_encoder
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({
            "feature_extractor_type": "EncodecFeatureExtractor",
            "feature_size": 1,
            "padding_side": "right",
            "padding_value": 0.0,
            "return_attention_mask": True,
            "sampling_rate": int(acfg.sampling_rate),
            "chunk_length_s": getattr(acfg, "chunk_length_s", None),
            "overlap": getattr(acfg, "overlap", None),
        }, f, indent=2)
    _save(_cpu(state), os.path.join(path, WEIGHTS_FILE))


#: tokenizer and feature-extractor files a model directory may hold beside its
#: weights (the JAX package's converter carries the same list)
SIDE_FILES = ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json", "spiece.model",
              "added_tokens.json", "vocab.json", "merges.txt", "preprocessor_config.json")


def carry_side_files(src: str, dst: str) -> list[str]:
    """Copy the ``SIDE_FILES`` that ``src`` holds into ``dst`` (the source's
    ``preprocessor_config.json`` replaces the one ``save_model`` wrote);
    returns their names."""
    carried = []
    for name in SIDE_FILES:
        if os.path.exists(os.path.join(src, name)):
            shutil.copy2(os.path.join(src, name), os.path.join(dst, name))
            carried.append(name)
    return carried


def load_model(path: str, *, device: str | torch.device = "cuda", dtype: torch.dtype | None = None,
               mesh: Mesh | None = None) -> tuple[ParlerTTSModel, ParlerTTSConfig, GenerationConfig]:
    """-> (model on ``device`` in ``dtype`` (None = fp32), eval mode and
    frozen, sliced to this rank's shards when ``mesh`` splits it; its
    config; its generation config)."""
    device = resolve_device(device)
    cfg = ParlerTTSConfig.load(os.path.join(path, "config.json"))
    gen_path = os.path.join(path, "generation_config.json")
    gen = GenerationConfig.load(gen_path) if os.path.exists(gen_path) else GenerationConfig()
    state = torch.load(os.path.join(path, WEIGHTS_FILE), map_location="cpu", weights_only=True)
    with torch.device(device):
        model = ParlerTTSModel(cfg)
    if dtype is not None:
        model = model.to(dtype)
    model.load_state_dict(state, strict=True)
    if mesh is not None:
        shard_params(model, mesh)
    return model.eval().requires_grad_(False), cfg, gen
