"""Label construction and static-shape batching for training.

The port's own copy of ``build_labels``, ``Collator`` and ``batches`` from
``parler_tts_tpu/training/data.py`` (plain numpy): left-padded prompts,
right-padded descriptions, delay-pattern labels padded with -100.  Dataset
loading and offline codec tokenization are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from parler_tts_tpu_torch.models.delay_pattern import build_delay_pattern_labels


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
