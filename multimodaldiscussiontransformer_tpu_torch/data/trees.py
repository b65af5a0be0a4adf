"""Discussion-tree distances: the C++ host helper (``native/``) where it
builds, numpy otherwise.

For an ordered node pair (i, j) of a rooted tree the relative distance is
``(up, down)``: ``up = depth(i) - depth(lca(i, j))`` and
``down = depth(j) - depth(lca(i, j))``, i.e. walk up from i to the lowest
common ancestor, then down to j. Same semantics as the JAX package's
``data/trees.py``; the numpy bodies (``_tree_distance_pairs_numpy``,
``_floyd_warshall_numpy``) are the plain versions the helper is held
against.
"""

from __future__ import annotations

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.native import loader as _native


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
    lib = _native.try_load()
    if lib is not None:
        return _native.tree_distance_pairs(lib, parents)
    return _tree_distance_pairs_numpy(parents)


def _tree_distance_pairs_numpy(parents: np.ndarray) -> np.ndarray:
    depths, anc = _depths_and_ancestors(parents)
    # LCA depth of every pair: deepest d where anc[i, d] == anc[j, d] != -1
    eq = (anc[:, None, :] == anc[None, :, :]) & (anc[:, None, :] >= 0)
    d_idx = np.arange(anc.shape[1])
    lca_depth = np.where(eq, d_idx, -1).max(axis=2)
    up = depths[:, None] - lca_depth
    down = depths[None, :] - lca_depth
    return np.stack([up, down], axis=-1).astype(np.int64)


def edges_to_parents(edge_index: np.ndarray, n: int, root: int = 0) -> np.ndarray:
    """Parent pointers rooted at ``root`` (DFS orientation) for an
    undirected edge list (2, E), as the reference builds trees from
    ``parent_id`` links (hateful_discussions.py:116-148); -1 for the root
    and for nodes it cannot reach."""
    adj = [[] for _ in range(n)]
    e = np.asarray(edge_index)
    for a, b in zip(e[0], e[1]):
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    parents = np.full(n, -1, dtype=np.int64)
    seen = np.zeros(n, dtype=bool)
    seen[root] = True
    stack = [root]
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                parents[v] = u
                stack.append(v)
    return parents


def floyd_warshall(adjacency: np.ndarray, unreachable: int = 510) -> np.ndarray:
    """All-pairs shortest path lengths over a dense adjacency matrix:
    nonzero entries are unit edges, the diagonal is 0, unreachable pairs are
    clamped to ``unreachable``."""
    a = np.asarray(adjacency)
    lib = _native.try_load()
    if lib is not None:
        return _native.floyd_warshall(lib, a, unreachable)
    return _floyd_warshall_numpy(a, unreachable)


def _floyd_warshall_numpy(a: np.ndarray, unreachable: int) -> np.ndarray:
    n = a.shape[0]
    m = np.where(a != 0, 1, unreachable).astype(np.int64)
    np.fill_diagonal(m, 0)
    for k in range(n):
        np.minimum(m, m[:, k : k + 1] + m[k : k + 1, :], out=m)
    m[m >= unreachable] = unreachable
    return m
