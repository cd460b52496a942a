"""A reader of saved HF tokenizers, in pure Python: text in, ids out.

``Tokenizer.from_pretrained(dir)`` reads ``tokenizer.json`` (the file a fast
tokenizer's ``save_pretrained`` writes), and ``tokenizer_config.json`` and
``special_tokens_map.json`` where present, and gives the ids that
``transformers.AutoTokenizer`` gives for the same directory, with HF's call
shape::

    tok(text).input_ids                                    # a list of ids
    tok(texts, padding=True, return_tensors="np")          # int64 input_ids, attention_mask

It needs neither ``tokenizers`` nor ``transformers``, which the card's
machine lacks.  It implements exactly what the tokenizers of Parler-TTS
(Flan-T5's Unigram) and of this repository's tests (WordPiece) use:

* models ``Unigram`` (Viterbi over the pieces' scores), ``WordPiece``
  (greedy longest match) and ``WordLevel``;
* normalizers ``Precompiled`` (sentencepiece's character map), ``Replace``,
  ``NFC``, ``NFD``, ``NFKC``, ``NFKD``, ``Lowercase``, ``Strip``, ``Sequence``;
* pre-tokenizers ``Metaspace``, ``WhitespaceSplit``, ``Whitespace``,
  ``Sequence``;
* the post-processor ``TemplateProcessing`` (single sequences);
* ``added_tokens``, matched before normalization, with their ``special``,
  ``normalized``, ``lstrip`` and ``rstrip`` flags.

Any other type, or an option the reader cannot follow, raises
``NotImplementedError`` naming it.  Nothing truncates: the callers never
ask for it.
"""

from __future__ import annotations

import base64
import bisect
import json
import os
import re
import struct
import unicodedata
from typing import Any, Callable, Iterable

import numpy as np

FILES = ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json")
_CACHE_LIMIT = 1 << 16  # entries of each per-instance memo (cleared when full)

# --- Unicode properties that `unicodedata` lacks ----------------------------------------------------
# Rust's `char::is_whitespace` and regex `\s`: the White_Space property.
_WHITE_SPACE = frozenset(map(chr, [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B), 0x2028,
                                    0x2029, 0x202F, 0x205F, 0x3000]))
# Other_Alphabetic code points outside the letter and mark categories (circled
# and squared Latin letters): Rust regex `\w` counts them as letters
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))
# UAX #29 classes (Unicode 15) that the general category does not give
_OTHER_GRAPHEME_EXTEND = frozenset([0x09BE, 0x09D7, 0x0B3E, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5, 0x0CD6,
                                    0x0D3E, 0x0D57, 0x0DCF, 0x0DDF, 0x1B35, 0x200C, 0x302E, 0x302F, 0xFF9E,
                                    0xFF9F, 0x1133E, 0x11357, 0x114B0, 0x114BD, 0x115AF, 0x11930, 0x1D165,
                                    0x1D16E, 0x1D16F, 0x1D170, 0x1D171, 0x1D172])
_PREPEND = frozenset([0x0600, 0x0601, 0x0602, 0x0603, 0x0604, 0x0605, 0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2,
                      0x0D4E, 0x110BD, 0x110CD, 0x111C2, 0x111C3, 0x1193F, 0x11941, 0x11A3A, 0x11A84, 0x11A85,
                      0x11A86, 0x11A87, 0x11A88, 0x11A89, 0x11D46, 0x11F02])
# spacing marks that are not SpacingMark (Grapheme_Cluster_Break=Other)
_NOT_SPACING_MARK = frozenset([0x102B, 0x102C, 0x1038, 0x1062, 0x1063, 0x1064, 0x1067, 0x1068, 0x1069, 0x106A,
                               0x106B, 0x106C, 0x106D, 0x1083, 0x1087, 0x1088, 0x1089, 0x108A, 0x108B, 0x108C,
                               0x108F, 0x109A, 0x109B, 0x109C, 0x1A61, 0x1A63, 0x1A64, 0xAA7B, 0xAA7D, 0x11720,
                               0x11721])
# Extended_Pictographic (emoji-data.txt), as sorted inclusive ranges
_EXT_PICT = (
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122), (0x2139, 0x2139),
    (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0),
    (0x25FB, 0x25FE), (0x2600, 0x2605), (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721), (0x2728, 0x2728), (0x2733, 0x2734),
    (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0), (0x27BF, 0x27BF), (0x2934, 0x2935),
    (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F),
    (0x1F16C, 0x1F171), (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5),
    (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A), (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F), (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F),
    (0x1F7D5, 0x1F7FF), (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F),
    (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD),
)
_EXT_PICT_STARTS = [lo for lo, _ in _EXT_PICT]


def _is_ext_pict(cp: int) -> bool:
    i = bisect.bisect_right(_EXT_PICT_STARTS, cp) - 1
    return i >= 0 and cp <= _EXT_PICT[i][1]


def _is_word(c: str) -> bool:
    """Rust regex's Unicode ``\\w``: Alphabetic, marks, decimal digits,
    connector punctuation and the join controls."""
    cat = unicodedata.category(c)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc"):
        return True
    cp = ord(c)
    return cp in (0x200C, 0x200D) or any(lo <= cp <= hi for lo, hi in _ALPHABETIC_SYMBOLS)


def _grapheme_class(c: str) -> str:
    """The UAX #29 Grapheme_Cluster_Break value of ``c`` that the rules
    below use ("XX" for Any)."""
    cp = ord(c)
    if cp < 0x80:  # ASCII: CR, LF, controls, everything else Any
        return "CR" if c == "\r" else "LF" if c == "\n" else "Control" if cp < 0x20 or cp == 0x7F else "XX"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    if cp in _PREPEND:
        return "Prepend"
    cat = unicodedata.category(c)
    if (cat in ("Mn", "Me") or cp in _OTHER_GRAPHEME_EXTEND or 0x1F3FB <= cp <= 0x1F3FF
            or 0xE0020 <= cp <= 0xE007F):
        return "Extend"
    if (cat == "Mc" and cp not in _NOT_SPACING_MARK) or cp in (0x0E33, 0x0EB3):
        return "SpacingMark"
    if cat in ("Cc", "Zl", "Zp", "Cf") or (cat == "Cn" and (cp == 0x2065 or 0xFFF0 <= cp <= 0xFFF8
                                                          or 0xE0000 <= cp <= 0xE0FFF)):
        return "Control"
    if _is_ext_pict(cp):
        return "ExtPict"
    return "XX"


def graphemes(text: str) -> list[str]:
    """Extended grapheme clusters (UAX #29): rules GB3-GB9b, GB11-GB13 and
    GB999.  GB9c (Indic conjunct clusters, Unicode 15.1) is left out."""
    if not text:
        return []
    out, start = [], 0
    prev = _grapheme_class(text[0])
    ri_run = 1 if prev == "RI" else 0
    pict_zwj = False  # GB11: ExtPict Extend* ZWJ just before
    pict_seen = prev == "ExtPict"  # an ExtPict followed only by Extend so far
    for i in range(1, len(text)):
        cur = _grapheme_class(text[i])
        if prev == "CR" and cur == "LF":
            join = True
        elif prev in ("Control", "CR", "LF") or cur in ("Control", "CR", "LF"):
            join = False
        elif prev == "L" and cur in ("L", "V", "LV", "LVT"):
            join = True
        elif prev in ("LV", "V") and cur in ("V", "T"):
            join = True
        elif prev in ("LVT", "T") and cur == "T":
            join = True
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            join = True
        elif cur == "ExtPict" and pict_zwj:
            join = True
        elif prev == "RI" and cur == "RI":
            join = ri_run % 2 == 1
        else:
            join = False
        if not join:
            out.append(text[start:i])
            start = i
        pict_zwj = cur == "ZWJ" and pict_seen
        pict_seen = cur == "ExtPict" or (pict_seen and cur == "Extend")
        ri_run = ri_run + 1 if cur == "RI" else 0
        prev = cur
    out.append(text[start:])
    return out


# --- normalizers --------------------------------------------------------------------------------------


class _Charsmap:
    """sentencepiece's precompiled character map: a u32 byte size, a
    darts-clone double array of u32 units over UTF-8 bytes, then the
    NUL-terminated replacements.  ``lookup`` returns the replacement of the
    SHORTEST key that is a prefix of ``chunk`` (the first result of the
    common-prefix search, as ``tokenizers`` takes it), else None."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob)
        if size % 4 or 4 + size > len(blob):
            raise ValueError("precompiled_charsmap: bad trie size")
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.strings = blob[4 + size:]
        self._memo: dict[str, str | None] = {}

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def lookup(self, chunk: str) -> str | None:
        memo = self._memo
        if chunk in memo:
            return memo[chunk]
        units = self.units
        pos = self._offset(units[0])
        found = None
        for byte in chunk.encode():
            if byte == 0:
                break
            pos ^= byte
            if pos >= len(units) or units[pos] & 0x800000FF != byte:
                break
            unit = units[pos]
            pos ^= self._offset(unit)
            if unit & (1 << 8):
                start = units[pos] & 0x7FFFFFFF
                end = self.strings.find(b"\0", start)
                found = self.strings[start: end if end >= 0 else len(self.strings)].decode()
                break
        if len(memo) >= _CACHE_LIMIT:
            memo.clear()
        memo[chunk] = found
        return found

    def __call__(self, text: str) -> str:
        """Map each grapheme cluster under 6 UTF-8 bytes whole, where a key
        prefixes it; else each of its characters."""
        out = []
        for cluster in graphemes(text):
            if len(cluster.encode()) < 6:
                rep = self.lookup(cluster)
                if rep is not None:
                    out.append(rep)
                    continue
            for c in cluster:
                rep = self.lookup(c)
                out.append(c if rep is None else rep)
        return "".join(out)


def _strip(left: bool, right: bool) -> Callable[[str], str]:
    def strip(text: str) -> str:
        lo, hi = 0, len(text)
        while left and lo < hi and text[lo] in _WHITE_SPACE:
            lo += 1
        while right and hi > lo and text[hi - 1] in _WHITE_SPACE:
            hi -= 1
        return text[lo:hi]
    return strip


def _replace_pattern(spec: dict) -> re.Pattern:
    """A ``Replace`` normalizer's ``{"String": s}`` or ``{"Regex": r}``.
    ``tokenizers`` runs the regex in Oniguruma; Python's ``re`` matches it
    alike unless it uses a class escape (``\\w``, ``\\s``, ...), whose
    Unicode sets differ, so those raise."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec and not re.search(r"\\[wWsSdDbBpPhHRX]", spec["Regex"]):
        return re.compile(spec["Regex"])
    raise NotImplementedError(f"normalizer Replace pattern {spec}")


def _normalizer(spec: dict | None) -> Callable[[str], str]:
    if spec is None:
        return lambda text: text
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def sequence(text: str) -> str:
            for step in steps:
                text = step(text)
            return text
        return sequence
    if kind == "Precompiled":
        if not spec.get("precompiled_charsmap"):
            raise NotImplementedError("normalizer Precompiled with an empty precompiled_charsmap")
        return _Charsmap(base64.b64decode(spec["precompiled_charsmap"]))
    if kind == "Replace":
        pattern, content = _replace_pattern(spec["pattern"]), spec["content"]
        return lambda text: pattern.sub(lambda _: content, text)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda text: unicodedata.normalize(kind, text)
    if kind == "Lowercase":
        return lambda text: "".join(c.lower() for c in text)  # per character: no final-sigma rule
    if kind == "Strip":
        return _strip(spec.get("strip_left", True), spec.get("strip_right", True))
    raise NotImplementedError(f"normalizer {kind}")


# --- pre-tokenizers: (piece, starts the input) -> pieces ----------------------------------------------

Piece = tuple[str, bool]


def _split_runs(text: str, first: bool, keep: Callable[[str], str | None]) -> list[Piece]:
    """Maximal runs of characters of one class, where ``keep(c)`` names the
    class and None drops the character."""
    out, start, cls = [], 0, None
    for i, c in enumerate(text):
        k = keep(c)
        if k != cls:
            if cls is not None:
                out.append((text[start:i], first and start == 0))
            start, cls = i, k
    if cls is not None:
        out.append((text[start:], first and start == 0))
    return out


def _metaspace(spec: dict) -> Callable[[str, bool], list[Piece]]:
    rep = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme", "always")
    if scheme not in ("always", "first", "never"):
        raise NotImplementedError(f"pre-tokenizer Metaspace prepend_scheme {scheme!r}")
    if "add_prefix_space" in spec and spec["add_prefix_space"] != (scheme != "never"):
        raise ValueError("Metaspace: add_prefix_space does not match prepend_scheme")  # as tokenizers refuses it
    split = spec.get("split", True)

    def metaspace(text: str, first: bool) -> list[Piece]:
        text = text.replace(" ", rep)
        if text and not text.startswith(rep) and (scheme == "always" or (scheme == "first" and first)):
            text = rep + text
        if not split:
            return [(text, first)] if text else []
        # each replacement character merges with the text after it, unless
        # another replacement character follows it
        out: list[str] = []
        follows_rep = False
        i = len(text)
        while i > 0:
            j = i - 1
            if text[j] == rep:
                if not follows_rep and out:
                    out[-1] = rep + out[-1]
                else:
                    out.append(rep)
                follows_rep = True
            else:
                while j > 0 and text[j - 1] != rep:
                    j -= 1
                out.append(text[j:i])
                follows_rep = False
            i = j
        out.reverse()
        return [(p, first and k == 0) for k, p in enumerate(out)]
    return metaspace


def _pre_tokenizer(spec: dict | None, *, leading: bool = True) -> Callable[[str, bool], list[Piece]]:
    """``leading``: no splitting pre-tokenizer runs before this one."""
    if spec is None:
        return lambda text, first: [(text, first)]
    kind = spec.get("type")
    if kind == "Sequence":
        steps = []
        for k, s in enumerate(spec["pretokenizers"]):
            steps.append(_pre_tokenizer(s, leading=leading and k == 0))

        def sequence(text: str, first: bool) -> list[Piece]:
            pieces = [(text, first)]
            for step in steps:
                pieces = [q for p in pieces for q in step(*p)]
            return pieces
        return sequence
    if kind == "Metaspace":
        if spec.get("prepend_scheme") == "first" and not leading:
            # tokenizers asks whether the piece starts at original offset 0,
            # which needs the normalizer's alignments
            raise NotImplementedError("pre-tokenizer Metaspace prepend_scheme 'first' after another pre-tokenizer")
        return _metaspace(spec)
    if kind == "WhitespaceSplit":
        return lambda text, first: _split_runs(text, first, lambda c: None if c in _WHITE_SPACE else "w")
    if kind == "Whitespace":  # \w+|[^\w\s]+
        return lambda text, first: _split_runs(
            text, first, lambda c: "w" if _is_word(c) else None if c in _WHITE_SPACE else "p")
    raise NotImplementedError(f"pre-tokenizer {kind}")


# --- models ---------------------------------------------------------------------------------------------


class _Unigram:
    """Viterbi over the pieces' log-probabilities, as ``tokenizers``'s
    optimized encode walks it: starts in order, candidates at each start by
    increasing length, a later candidate taking a position only with a
    strictly higher score; a character no piece starts with is the unknown
    piece, scored at the vocabulary's minimum less 10; runs of unknown
    pieces fuse into one."""

    def __init__(self, spec: dict):
        if spec.get("byte_fallback"):
            raise NotImplementedError("model Unigram with byte_fallback")
        self.pieces = {}
        for i, (piece, score) in enumerate(spec["vocab"]):
            self.pieces[piece] = (i, float(score))  # a repeated piece: the last wins
        self.unk_id = spec.get("unk_id")
        self.unk_score = min((s for _, s in spec["vocab"]), default=0.0) - 10.0
        self.max_len = max((len(p) for p in self.pieces), default=1)

    def token_to_id(self, token: str) -> int | None:
        return self.pieces[token][0] if token in self.pieces else None

    def __call__(self, text: str) -> list[int]:
        n = len(text)
        score = [0.0] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)  # (start, id)
        pieces = self.pieces
        for start in range(n):
            here = score[start]
            single = False
            for end in range(start + 1, min(n, start + self.max_len) + 1):
                hit = pieces.get(text[start:end])
                if hit is None:
                    continue
                cand = here + hit[1]
                if back[end] is None or cand > score[end]:
                    score[end], back[end] = cand, (start, hit[0])
                single = single or end == start + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram: a character is not in the vocabulary and there is no unk_id")
                cand = here + self.unk_score
                if back[start + 1] is None or cand > score[start + 1]:
                    score[start + 1], back[start + 1] = cand, (start, self.unk_id)
        path, end = [], n
        while end > 0:
            start, pid = back[end]
            path.append((start, pid))
            end = start
        return self._fuse(text, path[::-1])

    def _fuse(self, text: str, path: list[tuple[int, int]]) -> list[int]:
        out: list[int] = []
        run_start = None
        for k, (start, pid) in enumerate(path):
            if pid == self.unk_id:
                if run_start is None:
                    run_start = start
                nxt = path[k + 1] if k + 1 < len(path) else None
                if nxt is None or nxt[1] != self.unk_id:
                    end = nxt[0] if nxt is not None else len(text)
                    out.append(self.pieces.get(text[run_start:end], (self.unk_id,))[0])
                    run_start = None
            else:
                out.append(pid)
        return out


class _WordPiece:
    def __init__(self, spec: dict):
        self.vocab = spec["vocab"]
        self.unk = spec["unk_token"]
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)

    def token_to_id(self, token: str) -> int | None:
        return self.vocab.get(token)

    def _unk(self) -> list[int]:
        if self.unk not in self.vocab:
            raise ValueError(f"WordPiece: unk_token {self.unk!r} is not in the vocabulary")
        return [self.vocab[self.unk]]

    def __call__(self, text: str) -> list[int]:
        if len(text) > self.max_chars:
            return self._unk()
        ids, start = [], 0
        while start < len(text):
            end = len(text)
            while end > start:
                sub = text[start:end] if start == 0 else self.prefix + text[start:end]
                if sub in self.vocab:
                    ids.append(self.vocab[sub])
                    break
                end -= 1
            if end == start:
                return self._unk()
            start = end
        return ids


class _WordLevel:
    def __init__(self, spec: dict):
        self.vocab, self.unk = spec["vocab"], spec.get("unk_token")

    def token_to_id(self, token: str) -> int | None:
        return self.vocab.get(token)

    def __call__(self, text: str) -> list[int]:
        if text in self.vocab:
            return [self.vocab[text]]
        if self.unk not in self.vocab:
            raise ValueError(f"WordLevel: {text!r} and the unk_token {self.unk!r} are not in the vocabulary")
        return [self.vocab[self.unk]]


_MODELS = {"Unigram": _Unigram, "WordPiece": _WordPiece, "WordLevel": _WordLevel}


def _post_processor(spec: dict | None) -> Callable[[list[int]], list[int]]:
    if spec is None:
        return lambda ids: ids
    if spec.get("type") != "TemplateProcessing":
        raise NotImplementedError(f"post-processor {spec.get('type')}")
    specials = spec.get("special_tokens", {})
    parts: list[list[int] | None] = []  # None stands for the sequence
    for item in spec["single"]:
        if "Sequence" in item:
            if item["Sequence"]["id"] != "A":
                raise NotImplementedError(f"TemplateProcessing single item {item}")
            parts.append(None)
        else:
            parts.append(list(specials[item["SpecialToken"]["id"]]["ids"]))
    return lambda ids: [i for part in parts for i in (ids if part is None else part)]


# --- added tokens ------------------------------------------------------------------------------------------


class _AddedTokens:
    """Added tokens of one kind (``normalized`` or not), found leftmost and
    longest first, as ``tokenizers``'s Aho-Corasick split finds them."""

    def __init__(self, tokens: list[tuple[str, dict]]):
        self.by_first: dict[str, list[tuple[str, dict]]] = {}
        for content, tok in sorted(tokens, key=lambda t: -len(t[0])):
            if content:
                self.by_first.setdefault(content[0], []).append((content, tok))

    def split(self, text: str) -> list[tuple[str, int | None]]:
        """-> [(text, None) | (matched text, id)] in order; spaces that an
        ``lstrip`` / ``rstrip`` token takes go with it."""
        if not self.by_first:
            return [(text, None)]
        out, done, i = [], 0, 0
        while i < len(text):
            for content, tok in self.by_first.get(text[i], ()):
                if text.startswith(content, i):
                    start, stop = i, i + len(content)
                    if tok.get("lstrip"):
                        while start > done and text[start - 1] in _WHITE_SPACE:
                            start -= 1
                    if tok.get("rstrip"):
                        while stop < len(text) and text[stop] in _WHITE_SPACE:
                            stop += 1
                    if done < start:
                        out.append((text[done:start], None))
                    out.append((text[start:stop], tok["id"]))
                    done = i = stop
                    break
            else:
                i += 1
        if done < len(text):
            out.append((text[done:], None))
        return out


# --- the tokenizer -------------------------------------------------------------------------------------------


class Encoding(dict):
    """``input_ids`` and ``attention_mask``, by key or by attribute (the
    shape of HF's ``BatchEncoding`` that callers read)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def _token_content(value) -> str | None:
    return value.get("content") if isinstance(value, dict) else value


class Tokenizer:
    """A saved HF tokenizer directory's ``tokenizer.json``, read."""

    def __init__(self, files: dict[str, bytes]):
        self.files = dict(files)
        spec = json.loads(files["tokenizer.json"])
        config = json.loads(files.get("tokenizer_config.json", b"{}"))
        special_map = json.loads(files.get("special_tokens_map.json", b"{}"))
        kind = (spec.get("model") or {}).get("type")
        if kind not in _MODELS:
            raise NotImplementedError(f"model {kind}")
        self.model = _MODELS[kind](spec["model"])
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.post_process = _post_processor(spec.get("post_processor"))
        plain, normed = [], []
        self.token_ids: dict[str, int] = {}
        for tok in spec.get("added_tokens", []):
            if tok.get("single_word"):
                raise NotImplementedError(f"added token {tok['content']!r} with single_word")
            self.token_ids[tok["content"]] = tok["id"]
            if tok.get("normalized", not tok.get("special", False)):
                normed.append((self.normalize(tok["content"]), tok))
            else:
                plain.append((tok["content"], tok))
        self.plain_tokens, self.normalized_tokens = _AddedTokens(plain), _AddedTokens(normed)
        self.padding_side = config.get("padding_side", "right")
        if self.padding_side not in ("right", "left"):
            raise ValueError(f"padding_side {self.padding_side!r}")
        pad = _token_content(config.get("pad_token", special_map.get("pad_token")))
        self.pad_token_id = None if pad is None else self.token_to_id(pad)
        self._memo: dict[str, list[int]] = {}

    @classmethod
    def from_pretrained(cls, path: str) -> "Tokenizer":
        """Read ``path``'s ``tokenizer.json`` and, where present, its
        ``tokenizer_config.json`` and ``special_tokens_map.json``."""
        if not os.path.isfile(os.path.join(path, "tokenizer.json")):
            held = sorted(f for f in ("spiece.model", "tokenizer_config.json", "vocab.txt", "vocab.json")
                          if os.path.exists(os.path.join(path, f)))
            raise FileNotFoundError(
                f"{path} has no tokenizer.json{' (it holds ' + ', '.join(held) + ')' if held else ''}: the port "
                f"reads a tokenizer only from tokenizer.json, the file a fast tokenizer's save_pretrained writes")
        files = {}
        for name in FILES:
            if os.path.isfile(os.path.join(path, name)):
                with open(os.path.join(path, name), "rb") as f:
                    files[name] = f.read()
        return cls(files)

    def save_pretrained(self, path: str) -> list[str]:
        """Write the files that were read, byte for byte; returns their paths."""
        os.makedirs(path, exist_ok=True)
        written = []
        for name, data in self.files.items():
            with open(os.path.join(path, name), "wb") as f:
                f.write(data)
            written.append(os.path.join(path, name))
        return written

    def token_to_id(self, token: str) -> int:
        found = self.token_ids.get(token, self.model.token_to_id(token))
        if found is None:
            raise ValueError(f"token {token!r} is neither an added token nor in the vocabulary")
        return found

    def _word(self, text: str) -> list[int]:
        ids = self._memo.get(text)
        if ids is None:
            ids = self.model(text)
            if len(self._memo) >= _CACHE_LIMIT:
                self._memo.clear()
            self._memo[text] = ids
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        at_start = True
        for raw, tok_id in self.plain_tokens.split(text):
            if tok_id is not None:
                ids.append(tok_id)
            else:
                for part, part_id in self.normalized_tokens.split(self.normalize(raw)):
                    if part_id is not None:
                        ids.append(part_id)
                    elif part:
                        for piece, _ in self.pre_tokenize(part, at_start):
                            if piece:
                                ids.extend(self._word(piece))
                    at_start = False
            at_start = False
        return self.post_process(ids) if add_special_tokens else ids

    def __call__(self, text: str | Iterable[str], padding: bool | str = False, return_tensors: str | None = None,
                 add_special_tokens: bool = True) -> Encoding:
        """HF's call: one text gives lists of ids, a list of texts lists of
        lists; ``padding=True`` ("longest") pads to the longest with the
        pad token on ``padding_side``; ``return_tensors="np"`` gives int64
        arrays with a batch axis."""
        if padding not in (False, True, "longest", "do_not_pad"):
            raise NotImplementedError(f"padding={padding!r}")
        if return_tensors not in (None, "np"):
            raise NotImplementedError(f"return_tensors={return_tensors!r}")
        single = isinstance(text, str)
        rows = [self.encode(t, add_special_tokens) for t in ([text] if single else text)]
        masks = [[1] * len(r) for r in rows]
        width = max((len(r) for r in rows), default=0)
        if padding in (True, "longest") and any(len(r) < width for r in rows):
            if self.pad_token_id is None:
                raise ValueError("padding needs a pad token, and the tokenizer has none")
            for r, m in zip(rows, masks):
                fill = width - len(r)
                if self.padding_side == "right":
                    r.extend([self.pad_token_id] * fill)
                    m.extend([0] * fill)
                else:
                    r[:0], m[:0] = [self.pad_token_id] * fill, [0] * fill
        if return_tensors == "np":
            if any(len(r) != width for r in rows):
                raise ValueError("rows of unequal length cannot form an array; pass padding=True")
            return Encoding(input_ids=np.asarray(rows, np.int64).reshape(len(rows), width),
                            attention_mask=np.asarray(masks, np.int64).reshape(len(rows), width))
        if single:
            return Encoding(input_ids=rows[0], attention_mask=masks[0])
        return Encoding(input_ids=rows, attention_mask=masks)
