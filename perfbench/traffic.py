"""The one traffic generator: requests drawn from a mix's data file and the
seed.

A mix gives length ranges in words (``prompt_words``, ``description_words``:
[low, high]).  The rows of one call take lengths spread evenly over each
range, shuffled by the seed, so every seed sends the same sizes in another
order and every call has the same padded shapes.  Words are ``w<number>``
with the number drawn from the seed; a word is one token.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

#: first id a word takes; ids below are the pad and special ids
FIRST_WORD_ID = 3
#: the padded lengths a batch of texts takes (the serving pipeline's buckets)
BUCKETS = (16, 32, 64, 128, 256)


@dataclasses.dataclass
class Call:
    descriptions: list[str]
    prompts: list[str]
    greedy: bool
    seed: int


def spread(low: int, high: int, n: int, rng: np.random.Generator) -> list[int]:
    """``n`` lengths spread evenly over [low, high] in a seeded order."""
    return [int(x) for x in rng.permutation(np.linspace(low, high, n).round().astype(int))]


def text(rng: np.random.Generator, words: int) -> str:
    return " ".join(f"w{n}" for n in rng.integers(0, 1_000_000, words))


def call(mix: dict, seed: int, index: int) -> Call:
    """Call ``index`` of a run seeded ``seed``: ``rows`` rows; greedy every
    ``greedy_every``-th call from the first, sampled otherwise."""
    rng = np.random.default_rng([seed, index])
    rows = mix["rows"]
    descs = [text(rng, n) for n in spread(*mix["description_words"], rows, rng)]
    prompts = [text(rng, n) for n in spread(*mix["prompt_words"], rows, rng)]
    return Call(descs, prompts, index % mix["greedy_every"] == 0, int(rng.integers(0, 2**62)))


def ids(texts: list[str], vocab_size: int, *, left: bool) -> tuple[np.ndarray, np.ndarray]:
    """The ids and mask of ``texts`` as the benchmark gives them to the
    reference, in the serving pipeline's layout: a word's id is its CRC-32
    over the vocabulary's word ids; each text is padded on the right to the
    longest (the tokenizer's padding), then the batch to the bucket of that
    length with masked columns, on the left for prompts and on the right for
    descriptions."""
    span = vocab_size - FIRST_WORD_ID
    rows = [[FIRST_WORD_ID + zlib.crc32(w.encode()) % span for w in t.split()] for t in texts]
    longest = max(len(r) for r in rows)
    width = next((b for b in BUCKETS if longest <= b), -(-longest // 64) * 64)
    first = width - longest if left else 0
    out = np.ones((len(rows), width), dtype=np.int64)
    mask = np.zeros((len(rows), width), dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, first:first + len(r)], mask[i, first:first + len(r)] = r, 1
    return out, mask
