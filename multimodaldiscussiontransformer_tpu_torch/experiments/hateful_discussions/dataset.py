"""The registered ``hateful_discussions`` dataset factory: the port's copy
of the JAX package's ``experiments/hateful_discussions/dataset.py``.

Reference: ``create_hatespeech_dataset``
(mDT/experiments/hateful_discussions/datasets/dataset.py:7-28) loads the
processed per-graph tensors plus the train/test index files
(``$SLURM_TMPDIR/{train,test}-idx-many.txt``), with ``valid_idx ==
test_idx``.

The graphs are the ``graph-<k>.npz`` files that ingestion writes
(``ingest.py``), in either layout: self-contained, or a per-copy stub that
names its tree's ``shared-<tree>.npz``. Items are callables, so only the
current batch's arrays are resident.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.core.registry import register_dataset
from multimodaldiscussiontransformer_tpu_torch.data.dataset import DiscussionDataset
from multimodaldiscussiontransformer_tpu_torch.data.preprocess import GraphItem

# The per-tree arrays of the stub layout: consecutive copies of one tree hit
# this small LRU instead of decompressing the (image-bearing) shared file
# again.
_SHARED_CACHE: "dict[str, dict]" = {}
_SHARED_CACHE_MAX = 8

_TREE_FIELDS = (
    "input_ids", "token_type_ids", "attention_mask", "spatial_pos",
    "distance", "in_degree", "x_images", "x_image_index",
)


def _load_shared(path: str) -> dict:
    hit = _SHARED_CACHE.pop(path, None)
    if hit is not None:
        _SHARED_CACHE[path] = hit  # re-insert: LRU order
        return hit
    with np.load(path, allow_pickle=False) as z:
        shared = {k: z[k] for k in z.files}
    _SHARED_CACHE[path] = shared
    while len(_SHARED_CACHE) > _SHARED_CACHE_MAX:
        _SHARED_CACHE.pop(next(iter(_SHARED_CACHE)))
    return shared


def load_graph_npz(path: str) -> GraphItem:
    """One processed graph, from the self-contained layout
    (``save_graph_npz``) or from a stub (``save_copy_npz``) and the
    ``shared-<tree>.npz`` it names, resolved against the stub's directory.
    ``y_mask`` (node task) and ``hard_y`` (contrastive task) are read where
    the file has them."""
    with np.load(path, allow_pickle=False) as z:
        tree = (
            _load_shared(os.path.join(os.path.dirname(path), str(z["shared_ref"])))
            if "shared_ref" in z
            else z
        )
        return GraphItem(
            idx=int(z["idx"]),
            **{f: tree[f] for f in _TREE_FIELDS},
            y=z["y"],
            y_mask=z["y_mask"] if "y_mask" in z else None,
            hard_y=z["hard_y"] if "hard_y" in z else None,
        )


class NpzItemLoader:
    """A picklable lazy item: loads its graph when called."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path

    def __call__(self) -> GraphItem:
        return load_graph_npz(self.path)

    def text_length(self) -> int:
        """The graph's longest attended token length, for length-grouped
        batching: read from the ``text_len`` scalar that ingestion writes,
        else from the attention mask alone, never from the images."""
        with np.load(self.path, allow_pickle=False) as z:
            if "text_len" in z:
                return int(z["text_len"])
            am = z["attention_mask"]
        return int(np.max(np.where(am.any(axis=0))[0], initial=0)) + 1 if am.any() else 1


def _read_index_file(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray([int(line) for line in f if line.strip()], dtype=np.int64)


@register_dataset("hateful_discussions")
def create_hatespeech_dataset(root: Optional[str] = None, split: int = 0, seed: int = 1) -> DiscussionDataset:
    """The dataset of a processed root: ``graph-<k>.npz`` files (in
    ``root/processed/`` if that exists, else in ``root``) and the index
    files ``train-idx-many-<split>.txt`` / ``test-idx-many-<split>.txt`` if
    both exist, else ``train-idx-many.txt`` / ``test-idx-many.txt``, else a
    seeded random split. ``root`` defaults to ``$MDT_DATA_ROOT``, then
    ``$SLURM_TMPDIR``, then the working directory."""
    root = root or os.environ.get("MDT_DATA_ROOT", os.environ.get("SLURM_TMPDIR", "."))
    graph_dir = os.path.join(root, "processed")
    if not os.path.isdir(graph_dir):
        graph_dir = root
    names = sorted(
        (f for f in os.listdir(graph_dir) if f.startswith("graph-") and f.endswith(".npz")),
        key=lambda s: int(s.split("-")[1].split(".")[0]),
    )
    items = [NpzItemLoader(os.path.join(graph_dir, f)) for f in names]

    train_file = os.path.join(root, f"train-idx-many-{split}.txt")
    test_file = os.path.join(root, f"test-idx-many-{split}.txt")
    if not (os.path.exists(train_file) and os.path.exists(test_file)):
        train_file = os.path.join(root, "train-idx-many.txt")
        test_file = os.path.join(root, "test-idx-many.txt")
    if os.path.exists(train_file) and os.path.exists(test_file):
        test_idx = _read_index_file(test_file)
        # valid == test, as in the reference (dataset.py:24-27)
        return DiscussionDataset.from_splits(
            items, train_idx=_read_index_file(train_file), valid_idx=test_idx, test_idx=test_idx, seed=seed
        )
    return DiscussionDataset.from_splits(items, seed=seed)
