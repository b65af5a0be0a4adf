"""The port's offline WordPiece (``data/tokenizer.py``) and the ingest
tokenizer factory against the JAX package's, on a vocab built in the test
(no ``bert-base-uncased`` vocab is vendored): tokens and ids equal, case
for case, with accents, CJK, punctuation, control characters, ``[UNK]``
words and truncation to 100; a seeded fuzz; the ``$MDT_BERT_VOCAB``
lookup; the loud failure without a vocab. Exact equality throughout."""

import random

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.data import tokenizer as jtok
from multimodaldiscussiontransformer_tpu.experiments.hateful_discussions import ingest as jingest
from multimodaldiscussiontransformer_tpu_torch.data import tokenizer as ptok
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import ingest as pingest

torch.set_num_threads(2)

VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "quick", "brown", "fox", "jump", "##ed", "##s", "##ing",
    "over", "lazy", "dog", "!", ",", ".", "'", "un", "##aff", "##able",
    "##ord", "hello", "world", "re", "##ddit", "na", "##ive", "$", "1",
    "##0", "中", "国", "resume", "[", "]", "(", ")", "link", "##1", "##2",
]

CASES = [
    "The quick brown fox jumped over the lazy dog!",
    "unaffable unaffordable",
    "hello,world. [LINK1] the link [LINK2]",
    "Naïve RÉSUMÉ résumé",
    "hello   \t\n world\r\x0b",
    "zzzqqq unknownword 12345",
    "$10 jumps, (jumping) & jumped!",
    "中国 hello 日本語 한국",
    "con\x00trol\x07 chars � here",
    "",
    "the " * 300,
    "[UNK] [CLS] the [SEP] [MASK]",
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(p)


@pytest.fixture(scope="module")
def toks(vocab_file):
    return ptok.BertWordPieceTokenizer(vocab_file), jtok.BertWordPieceTokenizer(vocab_file)


def test_vocab_and_ids_match_jax(toks, vocab_file):
    port, jax_tok = toks
    assert ptok.load_vocab(vocab_file) == jtok.load_vocab(vocab_file)
    assert (port.pad_id, port.cls_id, port.sep_id, port.vocab_size) == (
        jax_tok.pad_id, jax_tok.cls_id, jax_tok.sep_id, jax_tok.vocab_size)
    for text in CASES:
        assert port.tokenize(text) == jax_tok.tokenize(text), repr(text)
    got, want = port(CASES, max_length=100), jax_tok(CASES, max_length=100)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the 300-word text is cut to [CLS] + 98 words + [SEP]
    assert got["attention_mask"][10].sum() == 100 and got["input_ids"][10, 99] == port.sep_id


def test_pieces_match_jax(toks):
    port, jax_tok = toks
    words = ["unaffable", "naive", "reddit", "jumping", "x" * 101, "resume"]
    for word in words:
        assert port.wordpiece.tokenize(word) == jax_tok.wordpiece.tokenize(word), word
    basic_p, basic_j = ptok.BasicTokenizer(do_lower_case=False), jtok.BasicTokenizer(do_lower_case=False)
    for text in CASES:
        assert basic_p.tokenize(text) == basic_j.tokenize(text), repr(text)


def test_fuzz_matches_jax(toks):
    port, jax_tok = toks
    rng = random.Random(0)
    alphabet = (
        list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJ") + list("0123456789")
        + list(".,!?;:'\"()[]{}$%&/\\-_+=<>@#~^|") + list(" \t\n\r\x0b  ")
        + list("àéîöůñçßÆŒ") + list("中国日本語한국") + ["́", "̈"] + ["\x00", "�", "\x07"]
    )
    texts = ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 60))) for _ in range(300)]
    for text in texts:
        assert port.tokenize(text) == jax_tok.tokenize(text), repr(text)
    for k, v in jax_tok(texts, max_length=24).items():
        np.testing.assert_array_equal(port(texts, max_length=24)[k], v, err_msg=k)


def test_vocab_lookup_and_the_ingest_factory(vocab_file, monkeypatch, tmp_path):
    """``$MDT_BERT_VOCAB`` drives both packages' ``find_vocab`` and
    ``make_tokenizer``; without a vocab, no HF cache and no opt-in the
    factory raises; ``__offline__`` and the opt-in give the hash
    tokenizer, equal to JAX's."""
    import transformers

    monkeypatch.setenv("MDT_BERT_VOCAB", vocab_file)
    assert ptok.find_vocab() == jtok.find_vocab() == vocab_file
    assert isinstance(pingest.make_tokenizer("bert-base-uncased"), ptok.BertWordPieceTokenizer)
    monkeypatch.setenv("MDT_BERT_VOCAB", str(tmp_path / "missing.txt"))
    assert ptok.find_vocab() is None and jtok.find_vocab() is None
    monkeypatch.delenv("MDT_BERT_VOCAB")
    with pytest.raises(FileNotFoundError, match="MDT_BERT_VOCAB"):
        ptok.BertWordPieceTokenizer()
    bad = tmp_path / "bad.txt"
    bad.write_text("the\nfox\n")
    with pytest.raises(ValueError, match="lacks"):
        ptok.BertWordPieceTokenizer(str(bad))

    def no_cache(*a, **k):
        raise OSError("no local cache")

    monkeypatch.delenv("MDT_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", no_cache)
    with pytest.raises(RuntimeError, match="HashTokenizer"):
        pingest.make_tokenizer("bert-base-uncased")
    for name, kw in (("bert-base-uncased", {"allow_hash_fallback": True}), ("__offline__", {})):
        got = pingest.make_tokenizer(name, vocab_size=500, **kw)
        want = jingest.make_tokenizer(name, vocab_size=500, **kw)
        assert isinstance(got, pingest.HashTokenizer)
        for k, v in want(CASES, max_length=100).items():
            np.testing.assert_array_equal(got(CASES, max_length=100)[k], v, err_msg=k)
