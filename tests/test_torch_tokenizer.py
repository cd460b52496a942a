"""The port's ``tokenizer.json`` reader (``utils/tokenizer.py``) against
``tokenizers`` and ``transformers``, id for id: the fixtures of
``tests/fixtures/torch_tokenizers`` (a T5-shaped Unigram, the JAX package's
toy WordPiece) and a fresh ``build_toy_tokenizer`` directory on fixed strings
and on a ``hypothesis`` property over ``ALPHABET``; tokenizers of the other
supported types; Unigram ties; batched calls with padding; the files
``save_pretrained`` writes; and the refusals."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import AddedToken, Regex, Tokenizer, models, normalizers, pre_tokenizers, trainers
from transformers import AutoTokenizer, PreTrainedTokenizerFast

from parler_tts_tpu.utils.toy_tokenizer import build_toy_tokenizer
from parler_tts_tpu_torch.utils import tokenizer as ptok
from tests import torch_tokenizer_fixtures as fx

EXPECTED = json.load(open(os.path.join(fx.FIXTURES, "expected_ids.json"), encoding="utf-8"))
TEXTS = fx.SMOKE_TEXTS + fx.TRICKY
# characters of Unicode 15.0 (the reader's tables are Python's unicodedata;
# see ROADMAP.md §3 for characters added later): ASCII, spaces and breaks,
# the soft hyphen and zero-width space, composed and decomposed accents,
# full-width forms, a ligature, fractions and superscripts, emoji with ZWJ,
# a variation selector, a keycap and a skin tone, regional indicators,
# Hangul jamo and syllables, CJK, Greek, Cyrillic, a circled letter,
# Devanagari with a virama, Thai, Arabic, a Roman numeral, connector
# punctuation and the join controls
ALPHABET = (list("abcdefghijklmnopqrstuvwxyzABCXYZ0123456789 .,;:!?'-_()<>/#")
            + [" ", "\t", "\n", "\r", "\xa0", "\xad", "​", "　", "\xe9", "\xc5", "̀", "́",
               "̈", "̧", "̊", "Ａ", "ａ", "ﬁ", "\xbd", "\xb2", "₂",
               "\U0001F468", "\U0001F469", "\U0001F44D", "\U0001F3FD", "‍", "️", "⃣",
               "\U0001F1EB", "\U0001F1F7", "ᄀ", "ᅡ", "ᆨ", "각", "가", "中", "Σ",
               "ж", "Ⓐ", "क", "्", "ष", "ำ", "ก", "؀", "١",
               "Ⅷ", "‿", "‌", "Ω", "Å"])
SPECIAL_STRINGS = ["</s>", "<pad>", "<unk>", "[UNK]", "[PAD]", " </s> "]


def random_texts(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    pool = ALPHABET + SPECIAL_STRINGS
    return ["".join(pool[i] for i in rng.integers(0, len(pool), rng.integers(0, 30))) for _ in range(n)]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory) -> dict[str, str]:
    fresh = str(tmp_path_factory.mktemp("fresh_toy"))
    build_toy_tokenizer(fresh)
    return {"t5_unigram": os.path.join(fx.FIXTURES, "t5_unigram"),
            "toy_wordpiece": os.path.join(fx.FIXTURES, "toy_wordpiece"), "fresh_toy": fresh}


@pytest.fixture(scope="module")
def pairs(dirs) -> dict[str, tuple[Tokenizer, ptok.Tokenizer]]:
    return {name: (Tokenizer.from_file(os.path.join(d, "tokenizer.json")), ptok.Tokenizer.from_pretrained(d))
            for name, d in dirs.items()}


def assert_same_ids(ref: Tokenizer, got: ptok.Tokenizer, texts) -> None:
    for t in texts:
        assert got(t).input_ids == ref.encode(t).ids, (ascii(t), ref.encode(t).tokens)


# --- the fixtures ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["t5_unigram", "toy_wordpiece", "fresh_toy"])
def test_fixed_strings_give_the_ids_of_tokenizers(pairs, name):
    ref, got = pairs[name]
    assert_same_ids(ref, got, TEXTS)
    if name in EXPECTED["ids"]:
        assert {t: got(t).input_ids for t in TEXTS} == EXPECTED["ids"][name]


def test_recorded_ids_are_tokenizers_own_and_the_smoke_reads_them():
    """``expected_ids.json`` is what ``tokenizers`` gives for the fixtures as
    they are, and holds the strings ``chip_smoke.py`` tokenizes."""
    assert EXPECTED["ids"] == fx.record_ids()
    assert tuple(EXPECTED["smoke_descriptions"]) == fx.SMOKE_DESCRIPTIONS
    assert tuple(EXPECTED["smoke_prompts"]) == fx.SMOKE_PROMPTS
    assert all(len(ids) > 1 and ids[-1] == 1 for t, ids in EXPECTED["ids"]["t5_unigram"].items() if t)


def test_fixture_files_stay_small_and_t5_shaped():
    spec = json.load(open(os.path.join(fx.FIXTURES, "t5_unigram", "tokenizer.json"), encoding="utf-8"))
    assert spec["model"]["type"] == "Unigram" and spec["model"]["unk_id"] == 2
    assert [n["type"] for n in spec["normalizer"]["normalizers"]] == ["Precompiled", "Replace"]
    assert spec["pre_tokenizer"]["type"] == "Metaspace" and spec["post_processor"]["type"] == "TemplateProcessing"
    assert [(t["id"], t["content"]) for t in spec["added_tokens"]] == [(0, "<pad>"), (1, "</s>"), (2, "<unk>")]
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(fx.FIXTURES) for f in fs)
    assert size < 64_000


@pytest.mark.parametrize("name", ["t5_unigram", "toy_wordpiece", "fresh_toy"])
@settings(max_examples=150, deadline=None)
@given(parts=st.lists(st.one_of(st.text(alphabet=ALPHABET, max_size=12), st.sampled_from(SPECIAL_STRINGS)),
                      max_size=6))
def test_any_text_over_the_alphabet_gives_the_ids_of_tokenizers(pairs, name, parts):
    ref, got = pairs[name]
    text = "".join(parts)
    assert got(text).input_ids == ref.encode(text).ids, (ascii(text), ref.encode(text).tokens)


# --- the charsmap and graphemes ---------------------------------------------------------------------------


def test_the_double_array_maps_every_key():
    """The test side's darts-clone writer against the reader's lookup, and
    ``tokenizers`` reads the same map."""
    entries = fx.charsmap_entries()
    blob = fx.double_array(entries)
    cmap = ptok._Charsmap(blob)
    assert all(cmap.lookup(k) == v for k, v in entries.items())
    assert cmap.lookup("q") is None and cmap.lookup("") is None
    ref = normalizers.Precompiled(blob)
    for text in TEXTS + tuple(random_texts(200, 1)):
        assert cmap(text) == ref.normalize_str(text), ascii(text)


def test_a_cluster_under_six_bytes_takes_its_shortest_keys_replacement():
    """``tokenizers`` replaces a whole grapheme cluster of under 6 bytes by
    the replacement of the first (shortest) key prefixing it, and maps
    longer clusters character by character."""
    blob = fx.double_array({"a": "X", "á": "Y", "b": "BB"})
    ref, got = normalizers.Precompiled(blob), ptok._Charsmap(blob)
    for text, want in [("á", "X"), ("xáy", "xXy"), ("b́̂", "BB"),
                       ("b́̂̃", "BB́̂̃"), ("ﬁ", "ﬁ")]:
        assert got(text) == ref.normalize_str(text) == want


@pytest.mark.parametrize("text,clusters", [
    ("éa", ["é", "a"]), ("\r\n\n", ["\r\n", "\n"]),
    ("\U0001F468‍\U0001F469‍\U0001F467!", ["\U0001F468‍\U0001F469‍\U0001F467", "!"]),
    ("\U0001F1EB\U0001F1F7\U0001F1E9\U0001F1EA\U0001F1FA", ["\U0001F1EB\U0001F1F7", "\U0001F1E9\U0001F1EA",
                                                           "\U0001F1FA"]),
    ("각각각", ["각", "각", "각"]),
    ("#️⃣x", ["#️⃣", "x"]), ("؀a", ["؀a"]), ("a​b", ["a", "​", "b"]),
    ("", []),
])
def test_grapheme_clusters(text, clusters):
    assert ptok.graphemes(text) == clusters


def test_left_out_grapheme_rules_change_no_ids():
    """ROADMAP.md §3: GB9c (an Indic conjunct, one cluster since Unicode
    15.1) is left out, so the reader splits it; such a cluster is 6 bytes or
    more and ``tokenizers`` maps it character by character too, so the
    normalized text and the ids agree.  Characters new in Unicode 16 (the
    reader's tables are Python's 15.0) are where the two part: U+0897
    extends a cluster for ``tokenizers`` only."""
    conjunct = "क्ष"
    assert ptok.graphemes(conjunct) == ["क्", "ष"]
    blob = fx.double_array({"क": "K", "a": "A"})
    ref, got = normalizers.Precompiled(blob), ptok._Charsmap(blob)
    assert got(conjunct) == ref.normalize_str(conjunct) == "K्ष"
    assert ref.normalize_str("aࢗ") == "A" and got("aࢗ") == "Aࢗ"


# --- other tokenizers the reader supports -------------------------------------------------------------------


def _saved(tmp_path, tok: Tokenizer, **specials) -> str:
    d = str(tmp_path / "tok")
    PreTrainedTokenizerFast(tokenizer_object=tok, **specials).save_pretrained(d)
    return d


def _wordpiece(normalizer, pre_tokenizer) -> Tokenizer:
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]", max_input_chars_per_word=12))
    tok.normalizer, tok.pre_tokenizer = normalizer, pre_tokenizer
    tok.train_from_iterator(list(fx.CORPUS), trainers.WordPieceTrainer(vocab_size=150,
                                                                        special_tokens=["[UNK]", "[PAD]"]))
    return tok


def _wordlevel() -> Tokenizer:
    tok = Tokenizer(models.WordLevel(unk_token="[UNK]"))
    tok.normalizer, tok.pre_tokenizer = normalizers.NFKD(), pre_tokenizers.Whitespace()
    tok.train_from_iterator(list(fx.CORPUS), trainers.WordLevelTrainer(special_tokens=["[UNK]", "[PAD]"]))
    return tok


def _t5(pre_tokenizer=None, added=()) -> Tokenizer:
    tok = fx.t5_backend()
    if pre_tokenizer is not None:
        tok.pre_tokenizer = pre_tokenizer
    tok.add_tokens(list(added))
    return tok


VARIANTS = {
    "wordpiece nfkc lowercase strip whitespacesplit": lambda: _wordpiece(
        normalizers.Sequence([normalizers.NFKC(), normalizers.Lowercase(), normalizers.Strip()]),
        pre_tokenizers.WhitespaceSplit()),
    "wordpiece nfd sequence": lambda: _wordpiece(
        normalizers.NFD(), pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Whitespace()])),
    "wordpiece nfc left strip replace": lambda: _wordpiece(
        normalizers.Sequence([normalizers.NFC(), normalizers.Strip(left=True, right=False),
                              normalizers.Replace("a", "A"), normalizers.Replace(Regex("[0-9]+"), "#")]),
        pre_tokenizers.Whitespace()),
    "wordlevel nfkd": _wordlevel,
    "metaspace first": lambda: _t5(pre_tokenizers.Metaspace(prepend_scheme="first")),
    "metaspace never": lambda: _t5(pre_tokenizers.Metaspace(prepend_scheme="never")),
    "metaspace always unsplit": lambda: _t5(pre_tokenizers.Metaspace(prepend_scheme="always", split=False)),
    "metaspace first unsplit": lambda: _t5(pre_tokenizers.Metaspace(prepend_scheme="first", split=False)),
    "added tokens": lambda: _t5(added=[AddedToken("<x>", lstrip=True), AddedToken("<y>", rstrip=True),
                                       AddedToken("ABC", normalized=True), AddedToken("\xe9", normalized=True),
                                       AddedToken("ab", normalized=False, special=False)]),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_other_supported_tokenizers_give_the_ids_of_tokenizers(tmp_path, variant):
    d = _saved(tmp_path, VARIANTS[variant](), pad_token="[PAD]" if "word" in variant else "<pad>")
    ref, got = Tokenizer.from_file(os.path.join(d, "tokenizer.json")), ptok.Tokenizer.from_pretrained(d)
    extra = ("<x>  ab <y>  ABC é café", " a<x>b<y>c ", "ab" * 20, "supercalifragilistic words")
    assert_same_ids(ref, got, TEXTS + extra + tuple(random_texts(300, 7)))


@pytest.mark.parametrize("legacy", [{"add_prefix_space": True}, {"add_prefix_space": False},
                                    {"add_prefix_space": False, "prepend_scheme": "never"}])
def test_metaspace_in_its_older_spelling(tmp_path, legacy):
    """``add_prefix_space`` (tokenizers before 0.14), read as tokenizers
    reads it: with ``prepend_scheme`` absent it must be true."""
    d = os.path.join(fx.FIXTURES, "t5_unigram")
    spec = json.load(open(os.path.join(d, "tokenizer.json"), encoding="utf-8"))
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", **legacy}
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec), encoding="utf-8")
    if legacy == {"add_prefix_space": False}:
        with pytest.raises(Exception, match="add_prefix_space does not match"):
            Tokenizer.from_file(str(path))
        with pytest.raises(ValueError, match="add_prefix_space does not match"):
            ptok.Tokenizer.from_pretrained(str(tmp_path))
        return
    ref, got = Tokenizer.from_file(str(path)), ptok.Tokenizer.from_pretrained(str(tmp_path))
    assert_same_ids(ref, got, TEXTS + tuple(random_texts(200, 3)))


def test_unigram_ties_break_as_tokenizers_breaks_them(tmp_path):
    """Pieces of equal scores, so that several segmentations tie; unknown
    characters (scored at the minimum less 10) fuse into one piece."""
    vocab = [("<unk>", 0.0), ("a", -1.0), ("b", -1.0), ("ab", -2.0), ("c", -1.0), ("bc", -2.0), ("abc", -3.0),
             ("ca", -2.0), ("▁", -1.0), ("▁a", -2.0), ("bca", -3.0), ("xy", -50.0)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=0))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    d = _saved(tmp_path, tok, unk_token="<unk>")
    ref, got = Tokenizer.from_file(os.path.join(d, "tokenizer.json")), ptok.Tokenizer.from_pretrained(d)
    rng = np.random.default_rng(0)
    texts = ["".join("abcxy "[i] for i in rng.integers(0, 6, rng.integers(0, 12))) for _ in range(400)]
    assert_same_ids(ref, got, ["abc", "abca", "bcab", "xxa", "axyb", "zzz", "a b c"] + texts)


# --- the call shape, save_pretrained ----------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("name", ["t5_unigram", "toy_wordpiece"])
def test_batched_calls_pad_as_transformers_does(tmp_path, name, side):
    d = str(tmp_path / name)
    shutil.copytree(os.path.join(fx.FIXTURES, name), d)
    config_path = os.path.join(d, "tokenizer_config.json")
    config = json.load(open(config_path))
    config["padding_side"] = side
    json.dump(config, open(config_path, "w"))
    ref, got = AutoTokenizer.from_pretrained(d), ptok.Tokenizer.from_pretrained(d)
    texts = list(TEXTS[:8]) + ["", "x"]
    a, b = ref(texts, padding=True, return_tensors="np"), got(texts, padding=True, return_tensors="np")
    for key in ("input_ids", "attention_mask"):
        assert b[key].dtype == np.int64 and getattr(b, key).shape == a[key].shape
        np.testing.assert_array_equal(b[key], a[key])
    assert got.pad_token_id == ref.pad_token_id
    for t in texts:
        assert got(t).input_ids == ref(t).input_ids and got(t).attention_mask == ref(t).attention_mask
    assert got(texts).input_ids == ref(texts).input_ids
    one = got("hey", padding=True, return_tensors="np")
    np.testing.assert_array_equal(one.input_ids, ref("hey", padding=True, return_tensors="np").input_ids)
    with pytest.raises(ValueError, match="padding=True"):
        got(["a", "a b c d"], return_tensors="np")


@pytest.mark.parametrize("name", ["t5_unigram", "toy_wordpiece"])
def test_save_pretrained_loads_in_auto_tokenizer_with_the_same_ids(tmp_path, name):
    tok = ptok.Tokenizer.from_pretrained(os.path.join(fx.FIXTURES, name))
    written = tok.save_pretrained(str(tmp_path / "out"))
    assert sorted(os.path.basename(p) for p in written) == sorted(ptok.FILES)
    for f in ptok.FILES:
        assert (tmp_path / "out" / f).read_bytes() == open(os.path.join(fx.FIXTURES, name, f), "rb").read()
    ref, again = AutoTokenizer.from_pretrained(str(tmp_path / "out")), ptok.Tokenizer.from_pretrained(
        str(tmp_path / "out"))
    for t in TEXTS:
        assert ref(t).input_ids == tok(t).input_ids == again(t).input_ids


# --- refusals ------------------------------------------------------------------------------------------------------


def _edited(tmp_path, edit) -> str:
    spec = json.load(open(os.path.join(fx.FIXTURES, "t5_unigram", "tokenizer.json"), encoding="utf-8"))
    edit(spec)
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    return str(tmp_path)


@pytest.mark.parametrize("edit,name", [
    (lambda s: s["model"].update(type="BPE"), "model BPE"),
    (lambda s: s["model"].update(byte_fallback=True), "byte_fallback"),
    (lambda s: s.update(normalizer={"type": "BertNormalizer"}), "normalizer BertNormalizer"),
    (lambda s: s["normalizer"]["normalizers"].append({"type": "Prepend", "prepend": "x"}), "normalizer Prepend"),
    (lambda s: s["normalizer"]["normalizers"].append({"type": "Replace", "pattern": {"Regex": r"\s+"},
                                                      "content": " "}), "normalizer Replace pattern"),
    (lambda s: s.update(pre_tokenizer={"type": "ByteLevel"}), "pre-tokenizer ByteLevel"),
    (lambda s: s.update(pre_tokenizer={"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"}, {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first"}]}),
     "Metaspace prepend_scheme 'first' after"),
    (lambda s: s.update(post_processor={"type": "RobertaProcessing"}), "post-processor RobertaProcessing"),
    (lambda s: s["added_tokens"].append({"id": 9, "content": "<z>", "single_word": True, "lstrip": False,
                                          "rstrip": False, "normalized": False, "special": True}), "single_word"),
])
def test_what_the_reader_does_not_support_raises(tmp_path, edit, name):
    with pytest.raises(NotImplementedError, match=name):
        ptok.Tokenizer.from_pretrained(_edited(tmp_path, edit))


def test_a_directory_without_tokenizer_json_raises_naming_it(tmp_path):
    (tmp_path / "spiece.model").write_bytes(b"sentencepiece")
    with pytest.raises(FileNotFoundError, match=r"no tokenizer\.json \(it holds spiece\.model\)"):
        ptok.Tokenizer.from_pretrained(str(tmp_path))
    tok = ptok.Tokenizer.from_pretrained(os.path.join(fx.FIXTURES, "t5_unigram"))
    with pytest.raises(NotImplementedError, match="max_length"):
        tok(["a"], padding="max_length")
    with pytest.raises(NotImplementedError, match="pt"):
        tok(["a"], return_tensors="pt")
