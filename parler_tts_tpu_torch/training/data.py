"""Training data: dataset specs, offline audio tokenization, the codes
cache, labels and static-shape batching.

The port's own copy of ``parse_dataset_spec``, ``load_multiple_datasets``,
``tokenize_audio_batches``, ``CodesCache``, ``build_labels``, ``Collator``
and ``batches`` from ``parler_tts_tpu/training/data.py``: HF datasets loaded
and merged as the JAX package merges them (``datasets`` is imported only
there); left-padded prompts, right-padded descriptions, delay-pattern labels
padded with -100; waveforms padded to a multiple of the hop,
``ceil(len / hop)`` frames of int16 codes per sample; the cache's part files
have the JAX names and keys, so each package reads the other's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from parler_tts_tpu_torch.core.config import DACConfig, EncodecConfig
from parler_tts_tpu_torch.models import codec as codec_mod
from parler_tts_tpu_torch.models.delay_pattern import build_delay_pattern_labels


@dataclass
class DatasetSpec:
    """One entry of a `+`-separated multi-dataset string."""

    name: str
    config: str | None = None
    split: str = "train"
    metadata_name: str | None = None
    samples: int | None = None


def parse_dataset_spec(names: str, configs: str | None = None, splits: str | None = None,
                       metadata_names: str | None = None, samples_counts: str | None = None) -> list[DatasetSpec]:
    """Split the `+`-separated fields and zip them; a single value applies
    to every dataset, other lengths must match."""

    def split_plus(s: str | None) -> list[str | None]:
        if not s:
            return []
        return [x if x else None for x in s.split("+")]

    name_list = split_plus(names)
    n = len(name_list)

    def norm(s, default=None):
        vals = split_plus(s)
        if not vals:
            return [default] * n
        if len(vals) == 1:
            return vals * n
        if len(vals) != n:
            raise ValueError(f"spec length mismatch: {s!r} vs {names!r}")
        return vals

    return [
        DatasetSpec(name=nm, config=cf, split=sp or "train", metadata_name=md, samples=int(sc) if sc else None)
        for nm, cf, sp, md, sc in zip(name_list, norm(configs), norm(splits, "train"), norm(metadata_names),
                                      norm(samples_counts))
    ]


def load_multiple_datasets(specs: Sequence[DatasetSpec], *, sampling_rate: int | None = None,
                           id_column: str = "id", streaming: bool = False,
                           stopping_strategy: str = "first_exhausted", seed: int | None = None):
    """Load and merge HF datasets as the JAX function does: each spec loaded
    (``load_from_disk`` for a local path, as an iterable dataset when
    ``streaming``; else ``load_dataset``), its ``audio`` column cast to
    ``sampling_rate``, its metadata side-dataset's columns added (map-style:
    rows aligned by ``id_column``, checked equal over all rows), ``samples``
    rows selected; then, for several specs, probability-weighted
    ``interleave_datasets`` (weights from ``samples``) when streaming, else
    ``concatenate_datasets``.  Needs the ``datasets`` package."""
    try:
        import datasets as hfds
    except ImportError as e:
        raise ImportError("load_multiple_datasets needs the `datasets` package, which this machine lacks; "
                          "prepare the data where it is installed (the save_to_disk cache), or train on "
                          "synthetic://N") from e

    probs = None
    if any(s.samples for s in specs):
        counts = np.asarray([float(s.samples or 1) for s in specs])
        probs = counts / counts.sum()

    def load(name: str, spec: DatasetSpec):
        if _is_local(name):
            ds = hfds.load_from_disk(name)
            if streaming and hasattr(ds, "to_iterable_dataset"):
                ds = ds.to_iterable_dataset()
        else:
            ds = hfds.load_dataset(name, spec.config, split=spec.split, streaming=streaming)
        if isinstance(ds, (hfds.DatasetDict, hfds.IterableDatasetDict)):
            ds = ds[spec.split]
        return ds

    parts = []
    for spec in specs:
        try:
            ds = load(spec.name, spec)
        except Exception as e:
            raise RuntimeError(f"failed to load dataset {spec.name!r}: {e}") from e
        if sampling_rate is not None and "audio" in (ds.column_names or ()):
            ds = ds.cast_column("audio", hfds.Audio(sampling_rate=sampling_rate))
        if spec.metadata_name:
            md = load(spec.metadata_name, spec)
            if streaming or not hasattr(ds, "__len__"):
                md = md.remove_columns([c for c in (md.column_names or ()) if c in (ds.column_names or ())])
                ds = hfds.concatenate_datasets([ds, md], axis=1)
            else:
                if id_column in ds.column_names and id_column in md.column_names:
                    if list(ds[id_column]) != list(md[id_column]):
                        raise ValueError(f"metadata id mismatch for {spec.name}")
                    md = md.remove_columns([id_column])
                for c in [c for c in md.column_names if c not in ds.column_names]:
                    ds = ds.add_column(c, md[c])
        if spec.samples and not streaming and hasattr(ds, "__len__"):
            ds = ds.select(range(min(int(spec.samples), len(ds))))
        parts.append(ds)

    if len(parts) == 1:
        return parts[0]
    if streaming:
        return hfds.interleave_datasets(parts, probabilities=probs, stopping_strategy=stopping_strategy, seed=seed)
    return hfds.concatenate_datasets(parts)


def _is_local(name: str) -> bool:
    return os.path.exists(name)


@torch.no_grad()
def tokenize_audio_batches(codec: codec_mod.Codec, codec_cfg: DACConfig | EncodecConfig,
                           audio_arrays: Sequence[np.ndarray], *, batch_size: int = 8,
                           pad_to_seconds: float | None = None) -> list[np.ndarray]:
    """Encode waveforms to codec codes with the frozen ``codec`` (DAC or
    EnCodec, through ``models/codec.encode``) on its device, ``batch_size``
    at a time, each batch zero-padded to its longest waveform (or to
    ``pad_to_seconds``) rounded up to a multiple of the hop.  Returns
    per-sample ``(K, ceil(len / hop))`` int16 codes."""
    hop = codec_cfg.hop_length
    device = next(codec.parameters()).device
    out: list[np.ndarray] = []
    for i in range(0, len(audio_arrays), batch_size):
        chunk = [np.asarray(a, np.float32) for a in audio_arrays[i : i + batch_size]]
        lens = [len(a) for a in chunk]
        pad_len = int(pad_to_seconds * codec_cfg.sampling_rate) if pad_to_seconds is not None else max(lens)
        pad_len = ((pad_len + hop - 1) // hop) * hop
        batch = np.zeros((len(chunk), pad_len), np.float32)
        for j, a in enumerate(chunk):
            batch[j, : len(a)] = a[:pad_len]
        codes = codec_mod.encode(codec, torch.from_numpy(batch).to(device)).cpu().numpy()
        for j, ln in enumerate(lens):
            t = min((ln + hop - 1) // hop, codes.shape[-1])
            out.append(codes[j, :, :t].astype(np.int16))
    return out


class CodesCache:
    """On-disk cache of codec codes keyed by global raw row index, appended
    in ``.npz`` part files ``{split}_codes/h{i}of{n}_part{k:06d}.npz`` with
    keys ``i{row}`` (int16), as the JAX package writes them.  Every part on
    disk is read, whichever process wrote it."""

    def __init__(self, root: str, *, split: str, process_index: int = 0, process_count: int = 1):
        self.dir = os.path.join(root, f"{split}_codes")
        os.makedirs(self.dir, exist_ok=True)
        self.prefix = f"h{process_index}of{process_count}"
        self._known: dict[int, np.ndarray] = {}
        self._part = 0
        for f in sorted(os.listdir(self.dir)):
            if not f.endswith(".npz"):
                continue
            if f.startswith(self.prefix + "_part"):
                self._part += 1
            with np.load(os.path.join(self.dir, f)) as z:
                for k in z.files:
                    self._known[int(k[1:])] = z[k]
        self._new: dict[int, np.ndarray] = {}

    def get(self, idx: int) -> np.ndarray | None:
        return self._known.get(idx)

    def put(self, idx: int, codes: np.ndarray) -> None:
        self._new[idx] = codes.astype(np.int16)

    def flush(self) -> None:
        if not self._new:
            return
        path = os.path.join(self.dir, f"{self.prefix}_part{self._part:06d}.npz")
        np.savez(path, **{f"i{k}": v for k, v in self._new.items()})
        self._known.update(self._new)
        self._new = {}
        self._part += 1


def build_labels(codes_list: Sequence[np.ndarray], *, bos_token_id: int, eos_token_id: int,
                 max_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample codes (K, T_i) -> batched (B, K, max_length) delay-pattern
    labels and the true lengths."""
    k = codes_list[0].shape[0]
    t_max = max(c.shape[1] for c in codes_list)
    codes = np.zeros((len(codes_list), k, t_max), np.int32)
    lengths = np.zeros((len(codes_list),), np.int32)
    for i, c in enumerate(codes_list):
        codes[i, :, : c.shape[1]] = c
        lengths[i] = c.shape[1]
    labels = build_delay_pattern_labels(torch.from_numpy(codes), torch.from_numpy(lengths),
                                        bos_token_id=bos_token_id, eos_token_id=eos_token_id,
                                        max_length=max_length)
    return labels.numpy(), lengths


@dataclass
class Collator:
    """Static-shape batch collator: left-padded prompts, right-padded
    descriptions, labels (already in the delay pattern) padded with -100."""

    description_pad_id: int
    prompt_pad_id: int
    max_description_len: int
    max_prompt_len: int
    label_len: int

    def __call__(self, samples: Sequence[dict]) -> dict[str, np.ndarray]:
        b = len(samples)
        k = samples[0]["labels"].shape[0]
        batch = {
            "input_ids": np.full((b, self.max_description_len), self.description_pad_id, np.int32),
            "attention_mask": np.zeros((b, self.max_description_len), np.int32),
            "prompt_input_ids": np.full((b, self.max_prompt_len), self.prompt_pad_id, np.int32),
            "prompt_attention_mask": np.zeros((b, self.max_prompt_len), np.int32),
            "labels": np.full((b, k, self.label_len), -100, np.int32),
        }
        for i, s in enumerate(samples):
            d = np.asarray(s["input_ids"], np.int32)[: self.max_description_len]
            batch["input_ids"][i, : len(d)] = d
            batch["attention_mask"][i, : len(d)] = 1
            p = np.asarray(s["prompt_input_ids"], np.int32)[: self.max_prompt_len]
            batch["prompt_input_ids"][i, self.max_prompt_len - len(p):] = p  # left pad
            batch["prompt_attention_mask"][i, self.max_prompt_len - len(p):] = 1
            lab = np.asarray(s["labels"], np.int32)[:, : self.label_len]
            batch["labels"][i, :, : lab.shape[1]] = lab
        return batch


def batches(dataset: Sequence[dict], collator: Collator, batch_size: int, *, seed: int = 0,
            shuffle: bool = True, drop_last: bool = True, group_by_length: bool = False,
            row_slice: tuple[int, int] | None = None) -> Iterator[dict]:
    """One epoch of collated batches, shuffled with ``seed``.

    ``group_by_length`` sorts by label length within mega-chunks of 50
    batches (then shuffles the batch order); ``row_slice=(lo, hi)`` collates
    only rows ``[lo, hi)`` of each global batch (one process's share)."""
    idx = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(idx)
    if group_by_length:
        lengths = np.asarray([int(np.sum(np.asarray(dataset[int(j)]["labels"])[0] != -100)) for j in idx])
        mega = batch_size * 50
        chunks = []
        for i in range(0, len(idx), mega):
            sl = idx[i : i + mega]
            chunks.append(sl[np.argsort(lengths[i : i + mega], kind="stable")[::-1]])
        idx = np.concatenate(chunks) if chunks else idx
    end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
    starts = list(range(0, end, batch_size))
    if group_by_length and shuffle:
        rng.shuffle(starts)
    for i in starts:
        take = idx[i : i + batch_size]
        if row_slice is not None:
            take = take[row_slice[0] : row_slice[1]]
        yield collator([dataset[int(j)] for j in take])
