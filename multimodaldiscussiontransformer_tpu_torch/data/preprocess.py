"""Per-item graph preprocessing: Cantor spatial bucketing, distances, degrees.

- (up, down) tree-distance pairs go through the sorted Cantor pairing into
  spatial buckets, each component clipped at 5: a pair with either component
  above 5 falls into the (5, 5) bucket;
- ``distance[i, j] = up + down`` is kept for the collator's
  ``spatial_pos_max`` clipping;
- in/out degrees are the adjacency row sums (trees are undirected).

The bucket ids depend on CPython's ``set`` iteration order over the Cantor
values. ``_build_mapping`` repeats the reference construction verbatim so the
ids agree with the JAX package and the reference checkpoints on the same
interpreter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.native import loader as _native

CLIP = 5  # per-component clip of (up, down)


def cantor(x) -> float:
    """Sorted Cantor pairing, float-valued like the reference."""
    x = sorted(x)
    return ((x[0] + x[1]) * (x[0] + x[1] + 1)) / 2 + x[0]


def _build_mapping() -> Dict[float, int]:
    # identical construction to the reference, so that the
    # set-iteration-order-dependent bucket ids agree
    res = []
    for i in range(CLIP + 1):
        for k in range(CLIP + 1):
            res += [cantor([i, k])]
    res = list(set(res))
    return {val: i for i, val in enumerate(res)}


_MAPPING = _build_mapping()
NUM_SPATIAL_BUCKETS = len(_MAPPING)  # 21 distinct sorted pairs for clip 5


def spatial_bucket_table() -> np.ndarray:
    """(CLIP+1, CLIP+1) table: bucket id for each clipped (up, down) pair."""
    table = np.empty((CLIP + 1, CLIP + 1), dtype=np.int64)
    for u in range(CLIP + 1):
        for d in range(CLIP + 1):
            c = cantor([u, d])
            table[u, d] = _MAPPING.get(c, _MAPPING[cantor([CLIP, CLIP])])
    return table


_TABLE = spatial_bucket_table()


def spatial_buckets(pairs: np.ndarray) -> np.ndarray:
    """Map (..., 2) (up, down) pairs to bucket ids; pairs with either
    component above CLIP map to the (CLIP, CLIP) bucket. An (N, N, 2) array
    goes through the C++ host helper where it builds."""
    pairs = np.asarray(pairs, dtype=np.int64)
    lib = _native.try_load()
    if lib is not None and pairs.ndim == 3 and pairs.shape[0] == pairs.shape[1]:
        return _native.spatial_buckets(lib, pairs, _TABLE, CLIP)
    return _spatial_buckets_numpy(pairs)


def _spatial_buckets_numpy(pairs: np.ndarray) -> np.ndarray:
    up, down = pairs[..., 0], pairs[..., 1]
    oob = (up > CLIP) | (down > CLIP)
    u = np.where(oob, CLIP, up)
    d = np.where(oob, CLIP, down)
    return _TABLE[u, d]


@dataclass
class GraphItem:
    """One preprocessed discussion graph (host-side, numpy)."""

    idx: int
    input_ids: np.ndarray  # (N, T) int32
    token_type_ids: np.ndarray  # (N, T) int32
    attention_mask: np.ndarray  # (N, T) int32
    spatial_pos: np.ndarray  # (N, N) int64, UNSHIFTED bucket ids
    distance: np.ndarray  # (N, N) int64, up+down hop count
    in_degree: np.ndarray  # (N,) int64, UNSHIFTED degrees
    x_images: np.ndarray  # (K, 3, H, W) float32 (K may be 0)
    x_image_index: np.ndarray  # (N,) bool, which nodes carry an image
    y: np.ndarray  # node task: (L,) labels of the labelled nodes; contrastive: (1,) community
    y_mask: Optional[np.ndarray] = None  # (N,) bool, which nodes are labelled (node task only)
    hard_y: Optional[np.ndarray] = None  # (1,) polar-opposite community (contrastive task only)

    @property
    def num_nodes(self) -> int:
        return int(self.input_ids.shape[0])


def preprocess_item(
    idx: int,
    tokens: Dict[str, np.ndarray],
    edge_index: np.ndarray,
    distance_pairs: np.ndarray,
    x_images: np.ndarray,
    x_image_index: np.ndarray,
    y: np.ndarray,
    y_mask: Optional[np.ndarray] = None,
    hard_y: Optional[np.ndarray] = None,
) -> GraphItem:
    """Build a GraphItem from raw per-graph arrays: adjacency -> degrees,
    (up, down) pairs -> spatial buckets + hop distance."""
    n = tokens["input_ids"].shape[0]
    adj = np.zeros((n, n), dtype=bool)
    e = np.asarray(edge_index)
    if e.size:
        adj[e[0], e[1]] = True
    in_degree = adj.sum(axis=1).astype(np.int64)
    pairs = np.asarray(distance_pairs, dtype=np.int64)
    spatial = spatial_buckets(pairs)
    distance = pairs.sum(axis=-1)
    images = np.asarray(x_images)
    return GraphItem(
        idx=idx,
        input_ids=np.asarray(tokens["input_ids"], dtype=np.int32),
        token_type_ids=np.asarray(tokens["token_type_ids"], dtype=np.int32),
        attention_mask=np.asarray(tokens["attention_mask"], dtype=np.int32),
        spatial_pos=spatial,
        distance=distance,
        in_degree=in_degree,
        x_images=images.astype(np.float32).reshape(
            (-1,) + tuple(images.shape[-3:]) if images.size else (0, 3, 224, 224)
        ),
        x_image_index=np.asarray(x_image_index, dtype=bool),
        y=np.asarray(y),
        y_mask=None if y_mask is None else np.asarray(y_mask, dtype=bool),
        hard_y=None if hard_y is None else np.asarray(hard_y),
    )
