"""Training CLI argument dataclasses.

The port's own copy of ``parler_tts_tpu/training/args.py``: the three
dataclasses ``ModelArguments``, ``DataTrainingArguments`` and
``TrainingArguments`` with the same field names and defaults, parsed from
one JSON recipe (``helpers/training_configs/*.json``) or from ``--flag
value`` pairs, so that every recipe parses to the same values in both
packages.

Two fields only tune XLA and are kept so that recipes parse:
``scan_unroll`` (the port's layers are a Python loop; ``main`` prints that
it ignores it) and ``gradient_checkpointing_policy`` (``"dots"`` and
``"full"`` both mean the port's per-layer recompute, ``remat=True``).
``model_parallel_size`` is the model axis of the processes' mesh
(``parallel/mesh.py``); it must divide the number of processes.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, fields
from typing import Any


@dataclass
class ModelArguments:
    model_name_or_path: str = ""
    config_name: str | None = None
    feature_extractor_name: str | None = None
    description_tokenizer_name: str | None = None
    prompt_tokenizer_name: str | None = None
    freeze_text_encoder: bool = True
    do_sample: bool = True
    temperature: float = 1.0
    max_length: int = 2580  # 30 s x 86 Hz
    pad_token_id: int | None = None
    decoder_start_token_id: int | None = None
    asr_model_name_or_path: str = "distil-whisper/distil-large-v2"
    clap_model_name_or_path: str = "laion/larger_clap_music_and_speech"


@dataclass
class DataTrainingArguments:
    train_dataset_name: str = ""
    train_dataset_config_name: str = ""
    train_split_name: str = "train"
    train_metadata_dataset_name: str | None = None
    train_dataset_samples: str | None = None  # `+`-separated weights
    streaming: bool = False
    stopping_strategy: str = "first_exhausted"
    eval_dataset_name: str | None = None
    eval_dataset_config_name: str | None = None
    eval_split_name: str = "test"
    eval_metadata_dataset_name: str | None = None
    target_audio_column_name: str = "audio"
    description_column_name: str = "description"
    prompt_column_name: str = "text"
    max_duration_in_seconds: float = 30.0
    min_duration_in_seconds: float = 2.0
    max_text_length: int = 500
    max_prompt_token_length: int | None = None
    max_description_token_length: int | None = None
    pad_to_max_length: bool = False
    preprocessing_num_workers: int | None = None
    max_train_samples: int | None = None
    max_eval_samples: int | None = None
    save_to_disk: str | None = None
    temporary_save_to_disk: str | None = None
    preprocessing_only: bool = False
    audio_encoder_batch_size: int = 8


@dataclass
class TrainingArguments:
    output_dir: str = "./output"
    overwrite_output_dir: bool = False
    do_train: bool = True
    do_eval: bool = False
    per_device_train_batch_size: int = 2
    per_device_eval_batch_size: int = 2
    gradient_accumulation_steps: int = 1
    num_train_epochs: float = 1.0
    max_steps: int = -1
    learning_rate: float = 9.5e-4
    lr_scheduler_type: str = "constant_with_warmup"
    warmup_steps: int = 0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_epsilon: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    logging_steps: int = 10
    save_steps: int = 500
    eval_steps: int = 500
    save_total_limit: int | None = None
    group_by_length: bool = False
    # None = automatic (training/autotune.py); True / False always win
    gradient_checkpointing: bool | None = None
    gradient_checkpointing_policy: str = "auto"  # "auto" | "full" | "dots"
    scan_unroll: str = "auto"  # XLA only, ignored by the port
    seed: int = 42
    dtype: str = "bfloat16"
    resume_from_checkpoint: str | None = None
    report_to: str = "jsonl"  # "wandb" if installed, else jsonl
    model_parallel_size: int = 1
    generation_max_length: int | None = None
    push_to_hub: bool = False
    hub_model_id: str | None = None


def _coerce(tp: Any, v: str) -> Any:
    s = str(tp)
    if "bool" in s:
        return v.lower() in ("1", "true", "yes")
    if "int" in s:
        return int(v)
    if "float" in s:
        return float(v)
    return v


def parse_args(argv: list[str] | None = None) -> tuple[ModelArguments, DataTrainingArguments, TrainingArguments]:
    """One ``*.json`` recipe, or ``--flag value`` pairs (a flag without a
    value means true).  Unknown fields are reported on stderr and
    ignored."""
    argv = list(sys.argv[1:] if argv is None else argv)
    classes = (ModelArguments, DataTrainingArguments, TrainingArguments)

    values: dict[str, Any] = {}
    if len(argv) == 1 and argv[0].endswith(".json"):
        with open(argv[0]) as f:
            values = json.load(f)
    else:
        i = 0
        while i < len(argv):
            arg = argv[i]
            if not arg.startswith("--"):
                raise ValueError(f"unexpected argument {arg!r}")
            name = arg[2:].replace("-", "_")
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                values[name] = argv[i + 1]
                i += 2
            else:
                values[name] = "true"
                i += 1

    known = {f.name for cls in classes for f in fields(cls)}
    out = []
    for cls in classes:
        kwargs = {}
        for f in fields(cls):
            if f.name in values:
                v = values[f.name]
                kwargs[f.name] = _coerce(f.type, v) if isinstance(v, str) else v
        out.append(cls(**kwargs))
    unknown = set(values) - known
    if unknown:
        print(f"[args] ignoring unknown fields: {sorted(unknown)}", file=sys.stderr)
    return tuple(out)  # type: ignore[return-value]
