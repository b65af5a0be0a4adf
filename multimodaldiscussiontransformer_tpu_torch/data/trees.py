"""Discussion-tree distances (numpy).

For an ordered node pair (i, j) of a rooted tree the relative distance is
``(up, down)``: ``up = depth(i) - depth(lca(i, j))`` and
``down = depth(j) - depth(lca(i, j))``, i.e. walk up from i to the lowest
common ancestor, then down to j. Same semantics as the JAX package's
``data/trees.py`` numpy path.
"""

from __future__ import annotations

import numpy as np


def _depths_and_ancestors(parents: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Node depths and ``anc[i, d]``, the ancestor of node i at depth d
    (-1 where d > depth(i)). ``parents[root] == -1``; nodes need not be
    topologically ordered."""
    n = len(parents)
    depths = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        # walk up to the first node of known depth
        chain = []
        j = i
        while j != -1 and depths[j] < 0:
            chain.append(j)
            j = parents[j]
        base = 0 if j == -1 else depths[j] + 1
        for k, node in enumerate(reversed(chain)):
            depths[node] = base + k
    max_depth = int(depths.max(initial=0))
    anc = np.full((n, max_depth + 1), -1, dtype=np.int64)
    for i in range(n):
        j = i
        d = depths[i]
        while j != -1:
            anc[i, d] = j
            j = parents[j]
            d -= 1
    return depths, anc


def tree_distance_pairs(parents: np.ndarray) -> np.ndarray:
    """All-pairs (up, down) distances: (N, N, 2) int64, diagonal (0, 0)."""
    parents = np.asarray(parents, dtype=np.int64)
    depths, anc = _depths_and_ancestors(parents)
    # LCA depth of every pair: deepest d where anc[i, d] == anc[j, d] != -1
    eq = (anc[:, None, :] == anc[None, :, :]) & (anc[:, None, :] >= 0)
    d_idx = np.arange(anc.shape[1])
    lca_depth = np.where(eq, d_idx, -1).max(axis=2)
    up = depths[:, None] - lca_depth
    down = depths[None, :] - lca_depth
    return np.stack([up, down], axis=-1).astype(np.int64)


def floyd_warshall(adjacency: np.ndarray, unreachable: int = 510) -> np.ndarray:
    """All-pairs shortest path lengths over a dense adjacency matrix:
    nonzero entries are unit edges, the diagonal is 0, unreachable pairs are
    clamped to ``unreachable``."""
    a = np.asarray(adjacency)
    n = a.shape[0]
    m = np.where(a != 0, 1, unreachable).astype(np.int64)
    np.fill_diagonal(m, 0)
    for k in range(n):
        np.minimum(m, m[:, k : k + 1] + m[k : k + 1, :], out=m)
    m[m >= unreachable] = unreachable
    return m
