"""The port's two-stage rehearsal (``experiments/hateful_discussions/
two_stage.py``, ``two_stage.sh``) against the JAX package's, on the CPU:

- ``generate_mini_corpus`` writes ``raw.json``, ``communities.json``,
  ``vocab.txt`` and the PNG images byte-equal to JAX's at two seeds in
  every label mode (PIL is here); ``image_format="npy"`` writes the same
  pixels without PIL and differs from the PNG corpus only in the images'
  extension; the smooth style without PIL raises naming PIL;
- ``build_contrastive_items`` and ``contrastive_dataset_from_ingest`` equal
  to JAX's on the same ingested corpus, field by field (exact);
- a tiny ``run`` of 2 contrastive + 4 node updates prints its ``TEST``
  line, and ``two_stage.sh`` runs it with small arguments."""

import builtins
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from multimodaldiscussiontransformer_tpu.data.tokenizer import BertWordPieceTokenizer as JaxTokenizer
from multimodaldiscussiontransformer_tpu.experiments.hateful_discussions import two_stage as jts
from multimodaldiscussiontransformer_tpu_torch.data.tokenizer import BertWordPieceTokenizer
from multimodaldiscussiontransformer_tpu_torch.data_prep.splits import make_splits
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import two_stage as pts
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.ingest import process

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("text", "context", "marker", "context_or")


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _same_tree(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 11])
def test_mini_corpus_is_byte_equal_to_jax(tmp_path, mode, seed):
    pytest.importorskip("PIL")
    kw = dict(n_trees=14, seed=seed, label_mode=mode, image_prob=0.5, context_star=seed == 11, marker_repeats=2)
    jts.generate_mini_corpus(str(tmp_path / "jax"), **kw)
    pts.generate_mini_corpus(str(tmp_path / "port"), **kw)
    assert os.listdir(tmp_path / "port" / "images")
    _same_tree(tmp_path / "jax", tmp_path / "port")


def test_smooth_images_and_comment_dist_match_jax(tmp_path):
    pytest.importorskip("PIL")
    kw = dict(n_trees=8, seed=3, image_prob=0.6, image_style="smooth", image_px=24)
    jts.generate_mini_corpus(str(tmp_path / "jax"), comment_dist=lambda r: 2 + r.randint(0, 5), **kw)
    pts.generate_mini_corpus(str(tmp_path / "port"), comment_dist=lambda r: 2 + r.randint(0, 5), **kw)
    _same_tree(tmp_path / "jax", tmp_path / "port")


def _no_pil(monkeypatch):
    real_import = builtins.__import__

    def block(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", block)


def test_npy_images_need_no_pil_and_hold_the_png_pixels(tmp_path, monkeypatch):
    PIL = pytest.importorskip("PIL.Image")
    pts.generate_mini_corpus(str(tmp_path / "png"), n_trees=10, seed=2, image_prob=0.5)
    _no_pil(monkeypatch)
    with pytest.raises(ImportError, match="PIL"):
        pts.generate_mini_corpus(str(tmp_path / "fail"), n_trees=10, seed=2, image_prob=0.5)
    with pytest.raises(ImportError, match="PIL"):
        pts.generate_mini_corpus(str(tmp_path / "smooth"), n_trees=10, seed=2, image_prob=0.5, image_style="smooth",
                                 image_format="npy")
    paths = pts.generate_mini_corpus(str(tmp_path / "npy"), n_trees=10, seed=2, image_prob=0.5, image_format="npy")
    monkeypatch.undo()
    with open(tmp_path / "png" / "raw.json") as f:
        png_raw = f.read()
    with open(paths["raw"]) as f:
        assert f.read() == png_raw.replace(".png", ".npy")
    names = sorted(os.listdir(tmp_path / "png" / "images"))
    assert names
    for n in names:
        arr = np.load(tmp_path / "npy" / "images" / n.replace(".png", ".npy"))
        np.testing.assert_array_equal(arr, np.asarray(PIL.open(tmp_path / "png" / "images" / n)))


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = (g() if callable(g) else g), (w() if callable(w) else w)
        for field in ("idx", "input_ids", "token_type_ids", "attention_mask", "spatial_pos", "distance", "in_degree",
                      "x_images", "x_image_index", "y", "y_mask", "hard_y"):
            a, b = getattr(g, field), getattr(w, field)
            if b is None:
                assert a is None, field
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("corpus"))
    paths = pts.generate_mini_corpus(out, n_trees=16, seed=4, image_prob=0.3)
    os.environ["MDT_BERT_VOCAB"] = paths["vocab"]
    try:
        make_splits(paths["raw"], os.path.join(out, "splits"), n_splits=1, seed=4)
        process(paths["raw"], os.path.join(out, "data"), train_idx_file=os.path.join(out, "splits", "train-idx.txt"),
                test_idx_file=os.path.join(out, "splits", "test-idx.txt"), image_root=out, max_length=16,
                image_size=32, log_every=0)
    finally:
        os.environ.pop("MDT_BERT_VOCAB", None)
    with open(paths["communities"]) as f:
        return out, paths, json.load(f)


def test_contrastive_items_match_jax(ingested):
    pytest.importorskip("PIL")
    out, paths, communities = ingested
    got = pts.build_contrastive_items(paths["raw"], communities, BertWordPieceTokenizer(paths["vocab"]), 16, out, 32)
    want = jts.build_contrastive_items(paths["raw"], communities, JaxTokenizer(paths["vocab"]), 16, out, 32)
    assert {int(it.hard_y[0]) for it in got} <= set(pts.POLAR.values())
    _assert_items_equal(got, want)


def test_contrastive_dataset_from_ingest_matches_jax(ingested):
    out, _, communities = ingested
    got = pts.contrastive_dataset_from_ingest(os.path.join(out, "data"), communities, seed=4)
    want = jts.contrastive_dataset_from_ingest(os.path.join(out, "data"), communities, seed=4)
    for split in ("train_idx", "valid_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(got, split), getattr(want, split))
    _assert_items_equal(got.items, want.items)
    assert got.text_length(0) == want.text_length(0)


def test_tiny_run_on_the_cpu(tmp_path, capsys):
    result = pts.run(str(tmp_path), n_trees=24, seed=0, stage1_updates=2, stage2_updates=4, max_length=16,
                     device="cpu")
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[two_stage] TEST ")]
    assert len(line) == 1 and json.loads(line[0].split("TEST ", 1)[1]) == result
    assert result["stage1_updates"] == 2 and result["stage2_updates"] == 4
    assert 0.0 <= result["f1"] <= 1.0 and np.isfinite(result["loss"])
    assert os.path.exists(tmp_path / "stage1" / "2" / "state.pt")  # the stage-1 checkpoint at its step


def test_two_stage_sh_runs_small(tmp_path):
    script = os.path.join(ROOT, "multimodaldiscussiontransformer_tpu_torch", "experiments", "hateful_discussions",
                          "two_stage.sh")
    env = {**os.environ, "DEVICE": "cpu", "OMP_NUM_THREADS": "2", "PYTHONPATH": ROOT}
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    (bindir / "python").chmod(0o755)
    env["PATH"] = f"{bindir}{os.pathsep}{env['PATH']}"
    proc = subprocess.run(["bash", script, str(tmp_path / "out"), "20", "1", "2"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    test = [ln for ln in proc.stdout.splitlines() if ln.startswith("[two_stage] TEST ")]
    assert len(test) == 1 and json.loads(test[0].split("TEST ", 1)[1])["n_trees"] == 20
