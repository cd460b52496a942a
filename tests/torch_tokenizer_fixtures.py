"""Tokenizer fixtures for the port's ``tokenizer.json`` reader
(``parler_tts_tpu_torch/utils/tokenizer.py``), built here with
``tokenizers`` and ``transformers`` (no download):

* ``t5_unigram/``: a tokenizer in the shape of Flan-T5's: a Unigram model
  trained on ``CORPUS``, normalizer ``Precompiled`` (a character map built by
  ``double_array`` from ``unicodedata.normalize("NFKC", ...)`` over
  ``charsmap_entries()``, since no sentencepiece model is at hand) followed by
  ``Replace(" {2,}", " ")``, pre-tokenizer ``Metaspace``, post-processor
  ``$A </s>``, special tokens ``<pad>`` 0, ``</s>`` 1, ``<unk>`` 2;
* ``toy_wordpiece/``: the JAX package's toy WordPiece
  (``build_toy_tokenizer``);
* ``expected_ids.json``: each fixture's ids, from ``tokenizers``, for
  ``SMOKE_DESCRIPTIONS`` and ``SMOKE_PROMPTS`` (what ``chip_smoke.py``
  tokenizes on the card) and ``TRICKY``.

Rewrite them with ``python -m tests.torch_tokenizer_fixtures`` from the
repository's root.
"""

from __future__ import annotations

import json
import os
import struct
import unicodedata

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_tokenizers")

SMOKE_DESCRIPTIONS = (
    "a female speaker with a low pitched voice speaks very fast",
    "a male speaker delivers a slightly expressive and animated speech with a moderate speed",
    "very clear audio",
    "a calm narrator with a deep voice reads slowly in a quiet room with almost no noise",
    "A warm, friendly voice speaks at a natural pace; the recording is close-up and clean.",
    "Jenny speaks quite fast, in a very confined sounding environment with clear audio quality.",
)
SMOKE_PROMPTS = (
    "Hey, how are you doing today?",
    "The weather is fine and we will walk to the river before dinner.",
    "Then we read a book.",
    "Parler-TTS turns a description and a prompt into speech!",
    "It costs 12.50 euros, not 13.",
    "Café déjà vu: naïve résumés.",
)
TRICKY = (
    "",
    "café",  # composed
    "café",  # e + combining acute
    "ｆｕｌｌ ｗｉｄｔｈ ＡＢＣ！",  # full width
    "the ﬁrst ﬁ́ve",  # a ligature; a ligature carrying a mark
    "no break  space",
    "runs   of    spaces",
    "  leading and trailing  ",
    "family \U0001F468‍\U0001F469‍\U0001F467 and a \U0001F44D\U0001F3FD",  # ZWJ, skin tone
    "flags \U0001F1EB\U0001F1F7\U0001F1E9\U0001F1EA",
    "a </s> inside and <pad> too",
    "</s>",
    "<unk> is a token",
    "tab\tnew\nline\r\nend",
    "soft­hyphen zero​width",
    "각 각 한국어",  # Hangul jamo L V T, a syllable, words
    "½ ⅓ x² H₂O",
)
CORPUS = SMOKE_DESCRIPTIONS + SMOKE_PROMPTS + (
    "a female speaker with a low pitched voice speaks very fast",
    "hey how are you doing today",
    "clear audio quality speaks fast",
    "a male speaker with a deep voice hey there",
    "the quick brown fox jumps over the lazy dog",
    "she sells sea shells by the sea shore on a sunny morning",
    "numbers like one two three four five six seven eight nine ten",
    "the first five fine files were filed",
    "cafe menu with fresh bread coffee and tea",
)
T5_SPECIALS = ("<pad>", "</s>", "<unk>")


def charsmap_entries() -> dict[str, str]:
    """The character map: every character of the chosen ranges whose NFKC
    form differs, base letters with a combining mark that NFKC composes,
    control characters but NUL removed, tab and line breaks to a space, the soft
    hyphen and zero-width space removed."""
    chars = [*range(0xA0, 0x180), *range(0x2000, 0x200B), *range(0x2070, 0x20A0), *range(0x2150, 0x2190),
             *range(0xFB00, 0xFB07), *range(0xFF01, 0xFF5F), 0x3000]
    out = {}
    for cp in chars:
        c = chr(cp)
        n = unicodedata.normalize("NFKC", c)
        if n != c:
            out[c] = n
    for base in "AEIOUaeiouNnCcYy":
        for mark in (0x300, 0x301, 0x302, 0x303, 0x308, 0x30A, 0x327):
            seq = base + chr(mark)
            n = unicodedata.normalize("NFKC", seq)
            if len(n) == 1:
                out[seq] = n
    for cp in [*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F, 0xAD, 0x200B]:
        out[chr(cp)] = ""
    out.update({"\t": " ", "\n": " ", "\r": " "})
    return out


def double_array(mapping: dict[str, str]) -> bytes:
    """sentencepiece's precompiled character map for ``mapping``: a u32 byte
    size, a darts-clone double array over the keys' UTF-8 bytes (each unit:
    label in bits 0-7, has-leaf bit 8, offset to the children's base in bits
    10-30; a leaf unit: bit 31 and the value), then the NUL-terminated
    replacements, each stored once, which the leaves' values index."""
    strings, where = bytearray(), {}
    for rep in sorted(set(mapping.values())):
        where[rep] = len(strings)
        strings += rep.encode() + b"\0"
    root: dict = {}
    for key, rep in mapping.items():
        node = root
        for byte in key.encode():
            node = node.setdefault(byte, {})
        node[0] = where[rep]  # label 0 holds the leaf
    units, used, bases = [0] * 256, [True] + [False] * 255, set()
    todo = [(0, root)]
    while todo:
        pos, node = todo.pop(0)
        labels = sorted(node)
        base = 1
        while True:
            while max(base ^ c for c in labels) >= len(units):
                units += [0] * 256  # whole blocks: base ^ byte stays inside the array
                used += [False] * 256
            if base not in bases and pos ^ base < 1 << 21 and not any(used[base ^ c] for c in labels):
                break
            base += 1
        bases.add(base)  # a shared base would let one node read another's children
        units[pos] |= (pos ^ base) << 10
        for c in labels:
            used[base ^ c] = True
            if c == 0:
                units[pos] |= 1 << 8
                units[base] = (1 << 31) | node[0]
            else:
                units[base ^ c] = c
                todo.append((base ^ c, node[c]))
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + bytes(strings)


def t5_backend(vocab_size: int = 400):
    """The T5-shaped ``tokenizers.Tokenizer``, trained on ``CORPUS``."""
    from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, processors, trainers

    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.Sequence([normalizers.Precompiled(double_array(charsmap_entries())),
                                           normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.train_from_iterator(list(CORPUS), trainers.UnigramTrainer(
        vocab_size=vocab_size, special_tokens=list(T5_SPECIALS), unk_token="<unk>", shrinking_factor=0.75))
    tok.post_processor = processors.TemplateProcessing(single="$A </s>", pair="$A </s> $B </s>",
                                                       special_tokens=[("</s>", 1)])
    return tok


def build_t5_unigram(save_dir: str) -> None:
    from transformers import PreTrainedTokenizerFast

    fast = PreTrainedTokenizerFast(tokenizer_object=t5_backend(), pad_token="<pad>", eos_token="</s>",
                                   unk_token="<unk>")
    fast.save_pretrained(save_dir)


def build_toy_wordpiece(save_dir: str) -> None:
    from parler_tts_tpu.utils.toy_tokenizer import build_toy_tokenizer

    build_toy_tokenizer(save_dir)


FIXTURE_MAKERS = {"t5_unigram": build_t5_unigram, "toy_wordpiece": build_toy_wordpiece}
SMOKE_TEXTS = SMOKE_DESCRIPTIONS + SMOKE_PROMPTS


def record_ids(root: str = FIXTURES) -> dict[str, dict[str, list[int]]]:
    """Each fixture's ids from ``tokenizers`` (special tokens added)."""
    from tokenizers import Tokenizer

    out = {}
    for name in FIXTURE_MAKERS:
        tok = Tokenizer.from_file(os.path.join(root, name, "tokenizer.json"))
        out[name] = {t: tok.encode(t).ids for t in SMOKE_TEXTS + TRICKY}
    return out


def main(root: str = FIXTURES) -> None:
    for name, build in FIXTURE_MAKERS.items():
        build(os.path.join(root, name))
    with open(os.path.join(root, "expected_ids.json"), "w") as f:
        json.dump({"smoke_descriptions": SMOKE_DESCRIPTIONS, "smoke_prompts": SMOKE_PROMPTS,
                   "ids": record_ids(root)}, f, indent=1, ensure_ascii=False)
        f.write("\n")


if __name__ == "__main__":
    main()
