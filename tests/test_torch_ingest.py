"""The port's HatefulDiscussions ingestion (``experiments/hateful_discussions/
ingest.py``) against the JAX package's, on the CPU: the same seeded raw
corpus (``data_prep/synthetic.py``: URLs, markdown links, "[deleted]"
bodies with a later duplicate id, bot text, unknown words, images on a
quarter of the comments and a few missing, one discussion of 60-70
comments) and the same WordPiece vocab built from it go through JAX
``process`` and the port's ``process``. Every npz array is equal, the idx
and tree-map files are byte-equal, and the ``IngestStats`` counts are
equal; the numpy path equals the C++ helper's; ``.npy`` images (no PIL)
equal the same images as PNG; ``workers=2`` equals ``workers=0``; the
functions one by one; no vocab fails loudly; the port's dataset reads the
output."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.experiments.hateful_discussions import ingest as jingest
from multimodaldiscussiontransformer_tpu_torch.data.collator import collate
from multimodaldiscussiontransformer_tpu_torch.data_prep.synthetic import build_vocab, synthetic_raw_corpus
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import ingest as pingest
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset import create_hatespeech_dataset

torch.set_num_threads(2)

CORPUS = dict(num_trees=10, comments=(3, 12), big_trees=1, big_comments=(60, 70), big_label_prob=0.1, seed=1)
COUNTS = ("trees", "nodes", "labelled_nodes", "graph_copies", "images_attempted", "images_loaded", "images_dropped")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The raw corpus with PNG images, its vocab and its split files."""
    d = tmp_path_factory.mktemp("corpus")
    made = synthetic_raw_corpus(str(d / "raw.json"), str(d), image_format="png", **CORPUS)
    assert made["images"] > 10 and made["missing_images"] >= 1 and made["duplicated_ids"] >= 1
    build_vocab(str(d / "raw.json"), str(d / "vocab.txt"))
    (d / "train.txt").write_text("".join(f"{i}\n" for i in range(8)))
    (d / "test.txt").write_text("8\n9\n10\n")
    return d


def _process(mod, corpus, out, monkeypatch, json_name="raw.json", **kw):
    monkeypatch.setenv("MDT_BERT_VOCAB", str(corpus / "vocab.txt"))
    stats = mod.IngestStats()
    k = mod.process(str(corpus / json_name), str(out), train_idx_file=str(corpus / "train.txt"),
                    test_idx_file=str(corpus / "test.txt"), image_root=str(corpus), log_every=0, stats_sink=stats, **kw)
    return k, stats


def _assert_same_output(a, b):
    for name in ("train-idx-many.txt", "test-idx-many.txt", "tree-map.txt"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    files = sorted(os.listdir(a / "processed"))
    assert files == sorted(os.listdir(b / "processed"))
    for f in files:
        with np.load(a / "processed" / f) as x, np.load(b / "processed" / f) as y:
            assert sorted(x.files) == sorted(y.files), f
            for key in x.files:
                assert x[key].dtype == y[key].dtype, (f, key)
                np.testing.assert_array_equal(x[key], y[key], err_msg=f"{f}:{key}")


@pytest.fixture(scope="module")
def port_run(corpus, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        out = tmp_path_factory.mktemp("port")
        k, stats = _process(pingest, corpus, out, mp)
    finally:
        mp.undo()
    return out, k, stats


def test_process_matches_jax(corpus, port_run, tmp_path, monkeypatch, capsys):
    out, k, stats = port_run
    jk, jstats = _process(jingest, corpus, tmp_path / "jax", monkeypatch)
    assert k == jk > 0 and stats.graph_copies == k
    for field in COUNTS:
        assert getattr(stats, field) == getattr(jstats, field), field
    assert stats.images_dropped >= 1 and [e.split(":")[0] for e in stats.drop_examples] == [
        e.split(":")[0] for e in jstats.drop_examples]
    _assert_same_output(out, tmp_path / "jax")


def test_numpy_path_gives_the_same_files(corpus, port_run, tmp_path, monkeypatch):
    from multimodaldiscussiontransformer_tpu_torch.native import loader

    assert loader.try_load() is not None
    calls = loader.CALLS["tree_distance_pairs"]
    monkeypatch.setenv("MDT_TPU_NO_NATIVE", "1")
    k, _ = _process(pingest, corpus, tmp_path / "numpy", monkeypatch)
    assert k == port_run[1] and loader.CALLS["tree_distance_pairs"] == calls
    _assert_same_output(port_run[0], tmp_path / "numpy")


def test_npy_images_need_no_pil_and_equal_png(corpus, port_run, tmp_path, monkeypatch):
    """The same corpus with ``.npy`` images, ingested with PIL made
    unimportable: the arrays equal the PNG run's."""
    synthetic_raw_corpus(str(corpus / "raw_npy.json"), str(corpus), image_format="npy", **CORPUS)
    monkeypatch.setitem(sys.modules, "PIL", None)
    k, stats = _process(pingest, corpus, tmp_path / "npy", monkeypatch, json_name="raw_npy.json")
    assert k == port_run[1] and stats.images_loaded == port_run[2].images_loaded
    _assert_same_output(port_run[0], tmp_path / "npy")


def test_workers_match_serial(corpus, port_run, tmp_path, monkeypatch):
    k, stats = _process(pingest, corpus, tmp_path / "pool", monkeypatch, workers=2)
    assert k == port_run[1]
    for field in COUNTS:
        assert getattr(stats, field) == getattr(port_run[2], field), field
    _assert_same_output(port_run[0], tmp_path / "pool")


def test_functions_match_jax(corpus, monkeypatch):
    monkeypatch.setenv("MDT_BERT_VOCAB", str(corpus / "vocab.txt"))
    ptok, jtok = pingest.make_tokenizer(), jingest.make_tokenizer()
    for text in ("see [a link](http://foo.bar/baz)", "x https://www.example.com/a?b=1 y", "[deleted]", ""):
        assert pingest.clean_urls(text) == jingest.clean_urls(text)
    with open(corpus / "raw.json") as f:
        trees = [json.loads(line) for line in f]
    for raw in trees:
        order, records, parents = pingest.collapse_tree(raw)
        jorder, jrecords, jparents = jingest.collapse_tree(raw)
        assert order == jorder and records == jrecords
        np.testing.assert_array_equal(parents, jparents)
        for nid in order:
            assert pingest.extract_text(records[nid]["data"]) == jingest.extract_text(records[nid]["data"])
    stub = {"data": {"title": "t", "body": "NA"}}
    assert pingest.extract_text(stub["data"]) == jingest.extract_text(stub["data"]) == "t"
    arr = np.random.default_rng(0).integers(0, 256, size=(224, 224, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pingest.preprocess_image(arr), jingest.preprocess_image(arr))
    raw = trees[-1]  # the big discussion
    loader = lambda path, size: np.zeros((3, size, size), np.float32)  # noqa: E731
    got = pingest.tree_to_items(raw, ptok, image_root=str(corpus), image_loader=loader, start_idx=5)
    want = jingest.tree_to_items(raw, jtok, image_root=str(corpus), image_loader=loader, start_idx=5)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for field in dataclasses.fields(b):
            x, y = getattr(a, field.name), getattr(b, field.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, field.name
                np.testing.assert_array_equal(x, y, err_msg=field.name)
            else:
                assert x == y, field.name


def test_no_vocab_fails_loudly_and_the_cli_opts_in(corpus, tmp_path, monkeypatch, capsys):
    import transformers

    def no_cache(*a, **k):
        raise OSError("no local cache")

    monkeypatch.delenv("MDT_BERT_VOCAB", raising=False)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", no_cache)
    with pytest.raises(RuntimeError, match="allow-hash-fallback"):
        pingest.process(str(corpus / "raw.json"), str(tmp_path / "none"), log_every=0)
    argv = [str(corpus / "raw.json"), str(tmp_path / "hash"), "--allow-hash-fallback", "--limit", "3",
            "--no-dedup", "--image-root", str(corpus)]
    assert pingest.main(argv) == 0
    assert jingest.main([*argv[:1], str(tmp_path / "jhash"), *argv[2:]]) == 0
    assert "FINAL K" in capsys.readouterr().out
    _assert_same_output(tmp_path / "hash", tmp_path / "jhash")
    assert not any(f.startswith("shared-") for f in os.listdir(tmp_path / "hash" / "processed"))


def test_the_port_dataset_reads_the_output(port_run):
    out, k, _ = port_run
    ds = create_hatespeech_dataset(root=str(out))
    assert len(ds) == k and len(ds.test_idx) > 0 and len(ds.train_idx) + len(ds.test_idx) == k
    items = [ds.get(i) for i in range(min(k, 4))]
    batch = collate(items, spatial_pos_max=5)
    assert batch.node_mask.sum() == sum(it.num_nodes for it in items)
