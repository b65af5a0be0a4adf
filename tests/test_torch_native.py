"""The port's C++ host helper (``native/``) against its numpy versions and
the JAX package's, exactly: (up, down) tree distances, Floyd-Warshall and
spatial buckets on random trees of up to 600 nodes, a deep chain and a
forest; ``edges_to_parents``; the build into ``_build/`` (never the source
tree), the ``MDT_TPU_NO_NATIVE`` escape and the quiet numpy fallback when
the helper cannot be built."""

import os

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.data import preprocess as jpre
from multimodaldiscussiontransformer_tpu.data import trees as jtrees
from multimodaldiscussiontransformer_tpu.data.synthetic import parents_to_edge_index, random_tree_parents
from multimodaldiscussiontransformer_tpu_torch.data import preprocess as ppre
from multimodaldiscussiontransformer_tpu_torch.data import trees as ptrees
from multimodaldiscussiontransformer_tpu_torch.native import loader as ploader

torch.set_num_threads(2)


def _bushy(n, rng, fanout=6):
    """A tree whose node i hangs under one of the few nodes before it (the
    shape of a long discussion: shallow and wide)."""
    return np.asarray([-1] + [int(rng.integers(max(0, (i - 1) // fanout - 2), (i - 1) // fanout + 1))
                              for i in range(1, n)], np.int64)


def _trees():
    rng = np.random.default_rng(0)
    out = [np.asarray([-1], np.int64), np.asarray([-1, 0], np.int64)]
    out += [random_tree_parents(n, rng) for n in (7, 33, 120)]
    out += [_bushy(n, rng) for n in (520, 600)]
    out.append(np.asarray([-1] + list(range(199)), np.int64))  # a chain of depth 199
    out.append(np.asarray([-1, 0, 1, -1, 3, 3], np.int64))  # a forest
    perm = rng.permutation(40)  # nodes out of topological order
    p = random_tree_parents(40, rng)
    inv = np.argsort(perm)
    out.append(np.asarray([-1 if p[perm[i]] < 0 else inv[p[perm[i]]] for i in range(40)], np.int64))
    return out


@pytest.fixture(scope="module")
def lib():
    lib = ploader.try_load()
    assert lib is not None, "the helper must build here (g++ is installed)"
    return lib


@pytest.mark.parametrize("index", range(10))
def test_distances_and_buckets_match_numpy_and_jax(lib, index):
    parents = _trees()[index]
    want = jtrees._tree_distance_pairs_numpy(parents)
    np.testing.assert_array_equal(ptrees._tree_distance_pairs_numpy(parents), want)
    native = ptrees.tree_distance_pairs(parents)
    assert native.dtype == np.int64
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(native, jtrees.tree_distance_pairs(parents))  # JAX's native where it builds
    buckets = ppre.spatial_buckets(native)
    np.testing.assert_array_equal(buckets, ppre._spatial_buckets_numpy(native))
    np.testing.assert_array_equal(buckets, jpre.spatial_buckets(want))


@pytest.mark.parametrize("n", [1, 2, 37, 600])
def test_floyd_warshall_matches_numpy_and_jax(lib, n):
    rng = np.random.default_rng(n)
    parents = _bushy(n, rng) if n > 2 else np.asarray([-1, 0][:n], np.int64)
    adj = np.zeros((n, n), np.int64)
    e = parents_to_edge_index(parents)
    adj[e[0], e[1]] = 1
    if n > 2:
        adj[:, n // 2:] = 0  # cut the tree: unreachable pairs clamp
        adj[n // 2:, :] = 0
    for unreachable in (510, 7):
        got = ptrees.floyd_warshall(adj, unreachable)
        np.testing.assert_array_equal(got, ptrees._floyd_warshall_numpy(adj, unreachable))
        np.testing.assert_array_equal(got, jtrees.floyd_warshall(adj, unreachable))


def test_native_calls_are_counted_and_the_escape_forces_numpy(lib, monkeypatch):
    parents = _trees()[4]
    before = dict(ploader.CALLS)
    pairs = ptrees.tree_distance_pairs(parents)
    ppre.spatial_buckets(pairs)
    assert ploader.CALLS["tree_distance_pairs"] == before["tree_distance_pairs"] + 1
    assert ploader.CALLS["spatial_buckets"] == before["spatial_buckets"] + 1
    monkeypatch.setenv("MDT_TPU_NO_NATIVE", "1")
    assert ploader.try_load() is None
    np.testing.assert_array_equal(ptrees.tree_distance_pairs(parents), pairs)
    assert ploader.CALLS["tree_distance_pairs"] == before["tree_distance_pairs"] + 1


def test_edges_to_parents_matches_jax():
    rng = np.random.default_rng(5)
    for n in (1, 9, 64):
        parents = random_tree_parents(n, rng)
        e = parents_to_edge_index(parents)
        for root in (0, n - 1):
            got = ptrees.edges_to_parents(e, n, root=root)
            np.testing.assert_array_equal(got, jtrees.edges_to_parents(e, n, root=root))
            np.testing.assert_array_equal(ptrees.tree_distance_pairs(got)[root], jtrees.tree_distance_pairs(got)[root])


def test_built_into_the_build_dir_and_falls_back_quietly(lib, monkeypatch, tmp_path):
    path = ploader.library_path()
    assert path.parent == ploader.BUILD_DIR and path.exists() and path.name.startswith("mdt_native-")
    assert not [f for f in os.listdir(ploader.SOURCE.parent) if f.endswith(".so")]
    # no compiler: the build raises, try_load gives None, callers take numpy
    monkeypatch.setattr(ploader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ploader, "_lib", None)
    monkeypatch.setattr(ploader, "_failed", False)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        ploader.build()
    assert ploader.try_load() is None and ploader._failed
    parents = _trees()[3]
    np.testing.assert_array_equal(ptrees.tree_distance_pairs(parents), jtrees._tree_distance_pairs_numpy(parents))
