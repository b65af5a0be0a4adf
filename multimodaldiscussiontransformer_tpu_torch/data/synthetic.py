"""Synthetic discussion trees for tests and the chip smoke run.

Random trees with token-id text, optional images and sparse node labels
(or, with ``contrastive``, one community and one polar-opposite community
per discussion), in the shapes the HatefulDiscussions ingestion produces.
For the same seed they equal the JAX package's ``data/synthetic.py`` items:
the draws come in the same order."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.data.preprocess import (
    GraphItem,
    preprocess_item,
)
from multimodaldiscussiontransformer_tpu_torch.data.trees import (
    tree_distance_pairs,
)


def random_tree_parents(n: int, rng: np.random.Generator) -> np.ndarray:
    """Random rooted tree: node i > 0 attaches to a random earlier node."""
    parents = np.full(n, -1, dtype=np.int64)
    for i in range(1, n):
        parents[i] = rng.integers(0, i)
    return parents


def parents_to_edge_index(parents: np.ndarray) -> np.ndarray:
    """Undirected edge_index (2, 2E): each tree edge in both directions."""
    edges = []
    for i, p in enumerate(parents):
        if p >= 0:
            edges.append((p, i))
            edges.append((i, p))
    if not edges:
        return np.zeros((2, 0), dtype=np.int64)
    return np.asarray(edges, dtype=np.int64).T


def synthetic_item(
    idx: int,
    num_nodes: int,
    rng: np.random.Generator,
    seq_len: int = 100,
    vocab_size: int = 30522,
    image_prob: float = 0.2,
    label_prob: float = 0.3,
    num_classes: int = 2,
    image_shape: Tuple[int, int, int] = (3, 224, 224),
    contrastive: bool = False,
    num_communities: int = 4,
) -> GraphItem:
    n = num_nodes
    parents = random_tree_parents(n, rng)
    pairs = tree_distance_pairs(parents)
    edge_index = parents_to_edge_index(parents)

    lengths = rng.integers(min(5, seq_len), seq_len + 1, size=n)
    input_ids = np.zeros((n, seq_len), dtype=np.int32)
    attention_mask = np.zeros((n, seq_len), dtype=np.int32)
    for i, ln in enumerate(lengths):
        input_ids[i, :ln] = rng.integers(1, vocab_size, size=ln)
        attention_mask[i, :ln] = 1
    token_type_ids = np.zeros((n, seq_len), dtype=np.int32)

    has_image = rng.random(n) < image_prob
    k = int(has_image.sum())
    x_images = rng.standard_normal((k,) + image_shape).astype(np.float32)

    if contrastive:
        y = np.asarray([rng.integers(0, num_communities)], dtype=np.int64)
        hard_y = np.asarray([rng.integers(0, num_communities)], dtype=np.int64)
        y_mask = None
    else:
        y_mask = rng.random(n) < label_prob
        if not y_mask.any():
            y_mask[rng.integers(0, n)] = True
        y = rng.integers(0, num_classes, size=int(y_mask.sum())).astype(np.int64)
        hard_y = None

    return preprocess_item(
        idx=idx,
        tokens={
            "input_ids": input_ids,
            "token_type_ids": token_type_ids,
            "attention_mask": attention_mask,
        },
        edge_index=edge_index,
        distance_pairs=pairs,
        x_images=x_images,
        x_image_index=has_image,
        y=y,
        y_mask=y_mask,
        hard_y=hard_y,
    )


def synthetic_batch_items(
    batch_size: int,
    seed: int = 0,
    min_nodes: int = 3,
    max_nodes: int = 24,
    contrastive: bool = False,
    **kw,
):
    rng = np.random.default_rng(seed)
    return [
        synthetic_item(
            idx=i,
            num_nodes=int(rng.integers(min_nodes, max_nodes + 1)),
            rng=rng,
            contrastive=contrastive,
            **kw,
        )
        for i in range(batch_size)
    ]


def synthetic_dataset(num_graphs: int = 64, seed: int = 0, contrastive: bool = False, **kw):
    """The registered ``"synthetic"`` dataset: ``num_graphs`` synthetic
    discussions (contrastive items with ``contrastive``) in a random
    80/10/10 split."""
    from multimodaldiscussiontransformer_tpu_torch.data.dataset import DiscussionDataset

    items = synthetic_batch_items(num_graphs, seed=seed, contrastive=contrastive, **kw)
    return DiscussionDataset.from_splits(items, seed=seed)


def _register() -> None:
    from multimodaldiscussiontransformer_tpu_torch.core.registry import DATASETS

    if "synthetic" not in DATASETS:
        DATASETS.register("synthetic")(synthetic_dataset)


_register()
