"""The port's ``hateful_discussions`` dataset and graph writers against the
JAX package's: graphs written by either package's ingest writers, in both
npz layouts, load bit-equal through both loaders, and both factories build
the same items and splits from the same directory. The port's launcher
trains on such a directory."""

import os

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.data import dataset as jdataset
from multimodaldiscussiontransformer_tpu.data import synthetic as jsyn
from multimodaldiscussiontransformer_tpu.experiments.hateful_discussions import dataset as jhd
from multimodaldiscussiontransformer_tpu.experiments.hateful_discussions import ingest as jingest
from multimodaldiscussiontransformer_tpu_torch.core import registry
from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig, TaskConfig
from multimodaldiscussiontransformer_tpu_torch.data import dataset as pdataset
from multimodaldiscussiontransformer_tpu_torch.data import synthetic as psyn
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import dataset as phd
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import ingest as pingest
from multimodaldiscussiontransformer_tpu_torch.train import launch

torch.set_num_threads(2)
IMG = (3, 16, 16)
FIELDS = ("input_ids", "token_type_ids", "attention_mask", "spatial_pos", "distance", "in_degree",
          "x_images", "x_image_index", "y", "y_mask")
N_GRAPHS = 14


def _items(mod, n=N_GRAPHS, seed=3, **kw):
    return mod.synthetic_batch_items(n, seed=seed, seq_len=12, vocab_size=100, image_shape=IMG, image_prob=0.4,
                                     max_nodes=10, **kw)


def _assert_items_equal(a, b):
    assert int(a.idx) == int(b.idx)
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _write(ingest, items, graph_dir, stub_every=3):
    """Every ``stub_every``-th graph in the stub + shared layout (two
    copies share one tree file), the rest self-contained."""
    os.makedirs(graph_dir, exist_ok=True)
    for k, item in enumerate(items):
        path = os.path.join(graph_dir, f"graph-{k}.npz")
        if k % stub_every == 0:
            ref = f"shared-{k // stub_every}.npz"
            ingest.save_shared_npz(os.path.join(graph_dir, ref), item)
            ingest.save_copy_npz(path, item, ref)
        else:
            ingest.save_graph_npz(path, item)


def _write_index(root, name, idx):
    with open(os.path.join(root, name), "w") as f:
        f.write("".join(f"{i}\n" for i in idx))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("layout", ["self_contained", "stub_and_shared"])
def test_graphs_load_bit_equal_in_both_packages(tmp_path, writer, layout):
    items = _items(jsyn if writer == "jax" else psyn)
    ingest = jingest if writer == "jax" else pingest
    _write(ingest, items, str(tmp_path), stub_every=1 if layout == "stub_and_shared" else N_GRAPHS + 1)
    for k, item in enumerate(items):
        path = str(tmp_path / f"graph-{k}.npz")
        got, want = phd.load_graph_npz(path), jhd.load_graph_npz(path)
        _assert_items_equal(got, want)
        _assert_items_equal(got, item)
        assert phd.NpzItemLoader(path).text_length() == jhd.NpzItemLoader(path).text_length() == jingest._text_len(item)


def test_stub_files_hold_only_the_labels(tmp_path):
    item = _items(psyn, n=1)[0]
    pingest.save_shared_npz(str(tmp_path / "shared-0.npz"), item)
    pingest.save_copy_npz(str(tmp_path / "graph-0.npz"), item, "shared-0.npz")
    with np.load(tmp_path / "graph-0.npz") as z:
        assert sorted(z.files) == ["idx", "shared_ref", "text_len", "y", "y_mask"]
    with np.load(tmp_path / "shared-0.npz") as z:
        assert tuple(z.files) == pingest.SHARED_FIELDS == jingest.SHARED_FIELDS


def test_contrastive_files_load_without_hard_y(tmp_path):
    """Graphs written for the contrastive task carry ``hard_y`` (and no
    ``y_mask``), by either package's writers in either layout: the port's
    loader reads it, as the JAX loader does. (The name is older than the
    port's contrastive task, when the loader skipped the field.)"""
    for writer in ("jax", "port"):
        items = _items(jsyn if writer == "jax" else psyn, n=4, contrastive=True)
        assert all(it.hard_y is not None and it.y_mask is None for it in items)
        for stub_every in (1, len(items) + 1):  # stub + shared, self-contained
            root = tmp_path / f"{writer}-{stub_every}"
            _write(jingest if writer == "jax" else pingest, items, str(root), stub_every=stub_every)
            for k, item in enumerate(items):
                path = str(root / f"graph-{k}.npz")
                got, want = phd.load_graph_npz(path), jhd.load_graph_npz(path)
                for other in (want, item):
                    _assert_items_equal(got, other)
                    assert got.hard_y.dtype == other.hard_y.dtype
                    np.testing.assert_array_equal(got.hard_y, other.hard_y)


def test_text_length_without_the_probe(tmp_path):
    """Corpora written before the ``text_len`` probe: the length comes from
    the attention mask, in both packages."""
    item = _items(psyn, n=1)[0]
    path = str(tmp_path / "graph-0.npz")
    np.savez_compressed(path, idx=np.asarray(0), **{f: getattr(item, f) for f in FIELDS})
    assert phd.NpzItemLoader(path).text_length() == jhd.NpzItemLoader(path).text_length() == pingest._text_len(item)


def test_shared_cache_stays_bounded(tmp_path):
    items = _items(psyn, n=12)
    _write(pingest, items, str(tmp_path), stub_every=1)
    for k in range(12):
        phd.load_graph_npz(str(tmp_path / f"graph-{k}.npz"))
    assert len(phd._SHARED_CACHE) == phd._SHARED_CACHE_MAX
    assert str(tmp_path / "shared-11.npz") in phd._SHARED_CACHE
    assert str(tmp_path / "shared-0.npz") not in phd._SHARED_CACHE


def _assert_datasets_equal(got, want):
    assert len(got) == len(want)
    for name in ("train_idx", "valid_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for i in range(len(got)):
        _assert_items_equal(got.get(i), want.get(i))


@pytest.mark.parametrize(
    "index_files",
    ["single_pair", "per_split", "per_split_other_split_only", "none"],
)
@pytest.mark.parametrize("processed", [False, True])
def test_factories_agree(tmp_path, index_files, processed):
    """Both factories over one directory: the same items and splits, with
    the single index pair, the ``-<split>`` pair (taken over the single
    pair), a ``-<split>`` pair of another split only (the single pair
    serves), or no index files (a seeded random split); graphs in
    ``processed/`` or at the root."""
    root = str(tmp_path)
    _write(pingest, _items(psyn), os.path.join(root, "processed") if processed else root)
    rng = np.random.default_rng(0)
    perm = rng.permutation(N_GRAPHS)
    if index_files in ("single_pair", "per_split_other_split_only"):
        _write_index(root, "train-idx-many.txt", perm[:10])
        _write_index(root, "test-idx-many.txt", perm[10:])
    if index_files == "per_split":
        _write_index(root, "train-idx-many.txt", perm[:4])
        _write_index(root, "test-idx-many.txt", perm[4:])
        _write_index(root, "train-idx-many-1.txt", perm[:9])
        _write_index(root, "test-idx-many-1.txt", perm[9:])
    if index_files == "per_split_other_split_only":
        _write_index(root, "train-idx-many-2.txt", perm[:3])
        _write_index(root, "test-idx-many-2.txt", perm[3:])
    got = phd.create_hatespeech_dataset(root=root, split=1, seed=5)
    _assert_datasets_equal(got, jhd.create_hatespeech_dataset(root=root, split=1, seed=5))
    if index_files == "none":
        assert len(got.train_idx) == int(0.8 * N_GRAPHS)
    else:
        np.testing.assert_array_equal(got.valid_idx, got.test_idx)
        n_train = {"single_pair": 10, "per_split": 9, "per_split_other_split_only": 10}[index_files]
        assert sorted(got.train_idx) == sorted(perm[:n_train])


@pytest.mark.parametrize("env", ["MDT_DATA_ROOT", "SLURM_TMPDIR"])
def test_root_from_environment(tmp_path, monkeypatch, env):
    _write(pingest, _items(psyn), str(tmp_path))
    _write_index(str(tmp_path), "train-idx-many.txt", range(10))
    _write_index(str(tmp_path), "test-idx-many.txt", range(10, N_GRAPHS))
    monkeypatch.delenv("MDT_DATA_ROOT", raising=False)
    monkeypatch.delenv("SLURM_TMPDIR", raising=False)
    monkeypatch.setenv(env, str(tmp_path))
    _assert_datasets_equal(phd.create_hatespeech_dataset(seed=1), jhd.create_hatespeech_dataset(seed=1))


@pytest.mark.parametrize("length_grouped", [False, True])
def test_registered_and_batches_equal(tmp_path, monkeypatch, length_grouped):
    """The registry's ``hateful_discussions`` is the port's factory, and its
    epoch batches equal the JAX package's, bit for bit; length-grouped
    batching reads the ``text_len`` probe, not the graphs."""
    from multimodaldiscussiontransformer_tpu.core import config as jconfig

    _write(jingest, _items(jsyn), str(tmp_path))
    _write_index(str(tmp_path), "train-idx-many.txt", range(10))
    _write_index(str(tmp_path), "test-idx-many.txt", range(10, N_GRAPHS))
    registry.populate()
    assert registry.DATASETS.get("hateful_discussions") is phd.create_hatespeech_dataset
    got = phd.create_hatespeech_dataset(root=str(tmp_path))
    want = jhd.create_hatespeech_dataset(root=str(tmp_path))
    kw = dict(batch_size=4, max_text_len=12, node_buckets=(16,), node_capacity_buckets=(64,),
              image_capacity_buckets=(16,), label_capacity_buckets=(32,), length_grouped=length_grouped)
    loads = []
    load = phd.load_graph_npz
    monkeypatch.setattr(phd, "load_graph_npz", lambda path: loads.append(path) or load(path))
    pb = list(pdataset.iterate_batches(got, got.train_idx, DataConfig(**kw), TaskConfig(), epoch=2, shuffle=True,
                                       image_shape=IMG))
    jb = list(jdataset.iterate_batches(want, want.train_idx, jconfig.DataConfig(**kw), jconfig.TaskConfig(), epoch=2,
                                       shuffle=True, image_shape=IMG))
    assert len(pb) == len(jb) == 2
    assert len(loads) == 8  # the 8 graphs of the two batches, nothing for the lengths
    for a, b in zip(pb, jb):
        for key, v in b.asdict().items():
            np.testing.assert_array_equal(a.asdict()[key], v, err_msg=key)


def test_launch_trains_on_a_data_root(tmp_path, capsys):
    """Without ``--synthetic`` the launcher reads ``--data-root`` through the
    registered factory (no ``KeyError``), trains and saves."""
    data = tmp_path / "data"
    items = psyn.synthetic_batch_items(20, seed=2, seq_len=16, vocab_size=128, image_shape=(3, 32, 32), max_nodes=8)
    _write(pingest, items, str(data))
    _write_index(str(data), "train-idx-many.txt", range(16))
    _write_index(str(data), "test-idx-many.txt", range(16, 20))
    argv = ["--tiny", "--device", "cpu", "--data-root", str(data), "--batch-size", "4", "--update-freq", "1",
            "--max-updates", "2", "--save-dir", str(tmp_path / "ck"), "--log-interval", "1"]
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert "dataset: 20 graphs (train 16 / valid 4 / test 4)" in out
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "metrics.jsonl"]


def test_launch_without_data_fails_cleanly(tmp_path, monkeypatch):
    """An empty data root gives an empty train split: the launcher's clean
    exit 1, not a ``KeyError`` from the registry."""
    monkeypatch.setenv("MDT_DATA_ROOT", str(tmp_path))
    assert launch.main(["--tiny", "--device", "cpu", "--no-save", "--save-dir", str(tmp_path / "ck")]) == 1
