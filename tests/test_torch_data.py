"""The port's copies of the host-side data modules against the JAX
package's: the same inputs give bit-equal arrays."""

import numpy as np
import pytest

from multimodaldiscussiontransformer_tpu.data import collator as jcollator
from multimodaldiscussiontransformer_tpu.data import preprocess as jpre
from multimodaldiscussiontransformer_tpu.data import synthetic as jsyn
from multimodaldiscussiontransformer_tpu.data import trees as jtrees
from multimodaldiscussiontransformer_tpu_torch.data import collator, preprocess, synthetic, trees

IMG = (3, 16, 16)


def test_cantor_bucket_table_equal():
    """The bucket ids depend on set iteration order; both packages build the
    table the same way on the same interpreter."""
    assert preprocess._MAPPING == jpre._MAPPING
    np.testing.assert_array_equal(preprocess.spatial_bucket_table(), jpre.spatial_bucket_table())
    assert preprocess.NUM_SPATIAL_BUCKETS == jpre.NUM_SPATIAL_BUCKETS == 21
    pairs = np.random.default_rng(0).integers(0, 9, (7, 7, 2))
    np.testing.assert_array_equal(preprocess.spatial_buckets(pairs), jpre.spatial_buckets(pairs))


@pytest.mark.parametrize("n", [1, 2, 17, 60])
def test_tree_distances_equal(n):
    parents = synthetic.random_tree_parents(n, np.random.default_rng(n))
    np.testing.assert_array_equal(trees.tree_distance_pairs(parents), jtrees._tree_distance_pairs_numpy(parents))
    adj = np.zeros((n, n), np.int64)
    for i, p in enumerate(parents):
        if p >= 0:
            adj[i, p] = adj[p, i] = 1
    np.testing.assert_array_equal(trees.floyd_warshall(adj), jtrees.floyd_warshall(adj))


def _items(mod, seed, **kw):
    kw = dict(seed=seed, seq_len=12, vocab_size=100, image_shape=IMG, image_prob=0.4, **kw)
    return mod.synthetic_batch_items(3, **kw)


def _assert_items_equal(a, b):
    for x, y in zip(a, b):
        for name in ("input_ids", "token_type_ids", "attention_mask", "spatial_pos", "distance",
                     "in_degree", "x_images", "x_image_index", "y", "y_mask"):
            np.testing.assert_array_equal(getattr(x, name), getattr(y, name), err_msg=name)


def test_synthetic_items_equal():
    _assert_items_equal(_items(synthetic, 3), _items(jsyn, 3))


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"pad_to_graphs": 8},
        {"node_buckets": (40,), "image_capacity_buckets": (0,)},
        {"node_buckets": (8,), "node_capacity_buckets": (16,), "label_capacity_buckets": (4,)},  # past the ladders
    ],
)
def test_collate_equal(kw):
    a = collator.collate(_items(synthetic, 4), image_shape=IMG, **kw)
    b = jcollator.collate(_items(jsyn, 4), image_shape=IMG, **kw)
    for k, v in b.asdict().items():
        got = a.asdict()[k]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_empty_collate_raises():
    with pytest.raises(ValueError):
        collator.collate([], pad_to_graphs=2, image_shape=IMG)


def test_bucket_ladder_past_the_end():
    for value, ladder in ((600, (8, 16, 256)), (33, (8, 32)), (5, (8,))):
        assert collator._bucket(value, ladder) == jcollator._bucket(value, ladder)
    assert collator._bucket(600, (8, 16, 32, 64, 128, 256)) == 600
