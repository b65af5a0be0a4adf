"""The writers of processed HatefulDiscussions graphs: the port's copy of
``_text_len``, ``save_shared_npz``, ``save_copy_npz`` and
``save_graph_npz`` from the JAX package's
``experiments/hateful_discussions/ingest.py``. Files they write load
through either package's ``load_graph_npz``.

Two layouts:
- self-contained: ``save_graph_npz`` writes every array of one graph;
- deduplicated: ``save_shared_npz`` writes a tree's arrays once, and
  ``save_copy_npz`` writes each labelled-node copy as a stub (labels and a
  relative ``shared_ref``).
"""

from __future__ import annotations

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.data.preprocess import GraphItem

SHARED_FIELDS = (
    "input_ids", "token_type_ids", "attention_mask", "spatial_pos",
    "distance", "in_degree", "x_images", "x_image_index",
)


def _text_len(item: GraphItem) -> int:
    am = item.attention_mask
    return int(np.max(np.where(am.any(axis=0))[0], initial=0)) + 1 if am.any() else 1


def _label_arrays(item: GraphItem) -> dict:
    """``y``, with ``y_mask`` (node task) and ``hard_y`` (contrastive task)
    where the item has them."""
    out = {"y": item.y}
    if item.y_mask is not None:
        out["y_mask"] = item.y_mask
    if item.hard_y is not None:
        out["hard_y"] = item.hard_y
    return out


def save_shared_npz(path: str, item: GraphItem) -> None:
    """The arrays every copy of one tree shares, written once per tree."""
    np.savez_compressed(path, **{f: getattr(item, f) for f in SHARED_FIELDS})


def save_copy_npz(path: str, item: GraphItem, shared_ref: str) -> None:
    """A per-copy stub: the labels, the ``text_len`` probe and
    ``shared_ref``, the shared file's name relative to the stub."""
    np.savez_compressed(
        path,
        idx=np.asarray(item.idx),
        text_len=np.asarray(_text_len(item), np.int32),
        shared_ref=np.asarray(shared_ref),
        **_label_arrays(item),
    )


def save_graph_npz(path: str, item: GraphItem) -> None:
    """One self-contained graph, with the ``text_len`` probe that
    length-grouped batching reads instead of the arrays."""
    np.savez_compressed(
        path,
        idx=np.asarray(item.idx),
        text_len=np.asarray(_text_len(item), np.int32),
        **{f: getattr(item, f) for f in SHARED_FIELDS},
        **_label_arrays(item),
    )
