"""The port's context ablation (``experiments/hateful_discussions/
context_ablation.py``) against the JAX package's, on the CPU:

- the corpus invariants of ``tests/test_context_ablation.py`` on the port's
  generator (labelled bodies free of hate words, labels that follow the
  parent's / own / either marker, length-matched bodies);
- ``context_blind_items`` equal to JAX's on the same ingested corpus,
  field by field (exact);
- a tiny ``run`` with ``arms="full"`` (and one with the warm starts) on
  the CPU."""

import json
import os

import numpy as np
import pytest

from multimodaldiscussiontransformer_tpu.experiments.hateful_discussions import context_ablation as jca
from multimodaldiscussiontransformer_tpu.experiments.hateful_discussions.dataset import (
    create_hatespeech_dataset as jax_dataset,
)
from multimodaldiscussiontransformer_tpu_torch.data_prep.splits import make_splits
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import context_ablation as pca
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import two_stage as pts
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset import (
    create_hatespeech_dataset,
)
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.ingest import process


def _flat(raw_path):
    """(node, parent or None, submission) of every comment of every tree."""
    out = []
    with open(raw_path) as f:
        for line in f:
            sub = json.loads(line)
            stack = [(top, None) for top in sub["tree"]]
            while stack:
                node, parent = stack.pop()
                out.append((node, parent, sub))
                stack.extend((ch, node) for ch in node.get("tree", []))
    return out


def _marked(text):
    return bool(set(text.split()) & set(pts.MARKER_WORDS))


@pytest.mark.parametrize("mode,star", [("context", False), ("marker", True), ("context_or", True)])
def test_context_corpus_invariants(tmp_path, mode, star):
    paths = pts.generate_mini_corpus(str(tmp_path), n_trees=40, seed=3, image_prob=0.0, label_mode=mode,
                                     context_star=star)
    n_pos = n_neg = n_parent_only = 0
    for node, parent, sub in _flat(paths["raw"]):
        body = node["data"]["body"]
        assert not set(body.split()) & set(pts.HATE_WORDS)
        own = _marked(body)
        pmark = _marked(sub["data"]["selftext"] if parent is None else parent["data"]["body"])
        rule = {"context": pmark, "marker": own, "context_or": own or pmark}[mode]
        label = node["data"]["label"]
        if label == "DEG":
            n_pos += 1
            assert rule, node["data"]["id"]
            n_parent_only += int(pmark and not own)
        elif label == "lti_normal":
            n_neg += 1
            assert not rule, node["data"]["id"]
    assert n_pos > 10 and n_neg > 10, (n_pos, n_neg)
    if mode == "context_or":
        assert n_parent_only > 5


def test_no_length_leak(tmp_path):
    paths = pts.generate_mini_corpus(str(tmp_path), n_trees=30, seed=5, image_prob=0.0, label_mode="context",
                                     marker_repeats=4)
    lens = {True: set(), False: set()}
    for node, _, sub in _flat(paths["raw"]):
        for body in (node["data"]["body"], sub["data"]["selftext"]):
            lens[_marked(body)].add(len(body.split()))
    assert lens[True] and lens[True] == lens[False]


def test_context_blind_items_match_jax(tmp_path):
    out = str(tmp_path)
    paths = pts.generate_mini_corpus(out, n_trees=20, seed=1, image_prob=0.0, label_mode="context_or",
                                     context_star=True)
    os.environ["MDT_BERT_VOCAB"] = paths["vocab"]
    try:
        make_splits(paths["raw"], os.path.join(out, "splits"), n_splits=1, seed=1)
        process(paths["raw"], os.path.join(out, "data"), train_idx_file=os.path.join(out, "splits", "train-idx.txt"),
                test_idx_file=os.path.join(out, "splits", "test-idx.txt"), image_root=out, max_length=16,
                image_size=32, log_every=0)
    finally:
        os.environ.pop("MDT_BERT_VOCAB", None)
    got = pca.context_blind_items(create_hatespeech_dataset(root=os.path.join(out, "data"), seed=1))
    want = jca.context_blind_items(jax_dataset(root=os.path.join(out, "data"), seed=1))
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g.num_nodes == 1
        for field in ("idx", "input_ids", "token_type_ids", "attention_mask", "spatial_pos", "distance", "in_degree",
                      "x_images", "x_image_index", "y", "y_mask"):
            np.testing.assert_array_equal(np.asarray(getattr(g, field)), np.asarray(getattr(w, field)),
                                          err_msg=field)


def test_tiny_run_full_arm(tmp_path, capsys):
    res = pca.run(str(tmp_path), n_trees=16, updates=4, max_length=16, arms="full", device="cpu")
    assert res["f1_context_blind"] == 0.0 and res["margin"] == res["f1_full"]
    assert 0.0 <= res["f1_full"] <= 1.0
    out = capsys.readouterr().out
    assert "[context_ablation] FULL " in out and "[context_ablation] BLIND" not in out
    assert json.loads(out.split("[context_ablation] RESULT ", 1)[1].splitlines()[0]) == res


def test_tiny_run_with_warm_starts(tmp_path):
    res = pca.run(str(tmp_path), n_trees=16, updates=3, contrastive_updates=2, pretrain_updates=2, max_length=16,
                  device="cpu")
    for key in ("f1_pretrain", "f1_full", "f1_context_blind", "accuracy_full", "accuracy_context_blind", "margin"):
        assert np.isfinite(res[key]), key
