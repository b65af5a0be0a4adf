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


def _datasets(seed, n=30):
    kw = dict(seq_len=24, vocab_size=100, image_shape=IMG, image_prob=0.3, max_nodes=12)
    from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_dataset as jds
    from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_dataset as pds

    a, b = pds(n, seed=seed, **kw), jds(n, seed=seed, **kw)
    for split in ("train_idx", "valid_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(a, split), getattr(b, split))
    return a, b


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g = g.asdict() if hasattr(g, "asdict") else g
        w = w.asdict() if hasattr(w, "asdict") else w
        assert set(g) == set(w)
        for k, v in w.items():
            assert g[k].dtype == v.dtype, k
            np.testing.assert_array_equal(g[k], v, err_msg=k)


@pytest.mark.parametrize(
    "data_kw, it_kw",
    [
        ({}, dict(epoch=2, shuffle=True)),
        ({"length_grouped": True, "text_len_buckets": (8, 16, 24)}, dict(epoch=3, shuffle=True)),
        ({"node_buckets": (4, 8, 16)}, dict(drop_last=False, pad_tail_to_batch=True)),
    ],
)
def test_iterate_batches_bit_equal(data_kw, it_kw):
    from multimodaldiscussiontransformer_tpu.core.config import DataConfig as JDataConfig, TaskConfig as JTaskConfig
    from multimodaldiscussiontransformer_tpu.data.dataset import iterate_batches as jiter
    from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig, TaskConfig
    from multimodaldiscussiontransformer_tpu_torch.data.dataset import iterate_batches

    pds, jds = _datasets(5)
    common = dict(batch_size=4, node_capacity_buckets=(16, 32, 64), image_capacity_buckets=(0, 4, 8),
                  label_capacity_buckets=(4, 8, 16), **data_kw)
    got = iterate_batches(pds, pds.train_idx, DataConfig(**common), TaskConfig(seed=3), image_shape=IMG, **it_kw)
    want = jiter(jds, jds.train_idx, JDataConfig(**common), JTaskConfig(seed=3), image_shape=IMG, **it_kw)
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("k", [2, 4])
def test_stack_microbatches_bit_equal(k):
    """Mixed bucket shapes grown inertly, and a ragged tail padded with
    all-pad microbatches, as the JAX copy does."""
    from multimodaldiscussiontransformer_tpu.core.config import DataConfig as JDataConfig, TaskConfig as JTaskConfig
    from multimodaldiscussiontransformer_tpu.data.dataset import iterate_batches as jiter
    from multimodaldiscussiontransformer_tpu.data.loader import stack_microbatches as jstack
    from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig, TaskConfig
    from multimodaldiscussiontransformer_tpu_torch.data.dataset import iterate_batches
    from multimodaldiscussiontransformer_tpu_torch.data.loader import stack_microbatches

    pds, jds = _datasets(6, n=36)
    common = dict(batch_size=3, node_buckets=(4, 8, 16), node_capacity_buckets=(8, 16, 32, 64),
                  image_capacity_buckets=(0, 4, 8, 16), label_capacity_buckets=(2, 4, 8, 16), text_len_buckets=(8, 16, 24))
    pb = list(iterate_batches(pds, pds.train_idx, DataConfig(**common), TaskConfig(seed=4), shuffle=True, image_shape=IMG))
    jb = list(jiter(jds, jds.train_idx, JDataConfig(**common), JTaskConfig(seed=4), shuffle=True, image_shape=IMG))
    assert len({b.input_ids.shape for b in pb}) > 1 and len(pb) % k != 0
    _assert_batches_equal(stack_microbatches(iter(pb), k, pad_tail=True), jstack(iter(jb), k, pad_tail=True))
    _assert_batches_equal(stack_microbatches(iter(pb), k), jstack(iter(jb), k))


def test_big_discussions_collate_and_stack_equal():
    """Discussions of 520-700 nodes, one per microbatch, on the canonical
    ladders: past the node ladder Nmax is the node count itself (padded S
    >= 513), the text capacity takes the 1024 bucket and the label capacity
    its own count; stacking an update's microbatches grows them all to the
    largest S. Every array equals the JAX copy's."""
    from multimodaldiscussiontransformer_tpu.core.config import DataConfig as JDataConfig, TaskConfig as JTaskConfig
    from multimodaldiscussiontransformer_tpu.data.dataset import iterate_batches as jiter
    from multimodaldiscussiontransformer_tpu.data.loader import stack_microbatches as jstack
    from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_dataset as jds
    from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig, TaskConfig
    from multimodaldiscussiontransformer_tpu_torch.data.dataset import iterate_batches
    from multimodaldiscussiontransformer_tpu_torch.data.loader import stack_microbatches
    from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_dataset as pds

    kw = dict(seq_len=8, vocab_size=100, image_shape=IMG, image_prob=0.05, min_nodes=520, max_nodes=700)
    p, j = pds(10, seed=7, **kw), jds(10, seed=7, **kw)
    pb = list(iterate_batches(p, p.train_idx, DataConfig(batch_size=1, max_text_len=8), TaskConfig(seed=2),
                              shuffle=True, image_shape=IMG))
    jb = list(jiter(j, j.train_idx, JDataConfig(batch_size=1, max_text_len=8), JTaskConfig(seed=2),
                    shuffle=True, image_shape=IMG))
    _assert_batches_equal(pb, jb)
    for b in pb:
        n = int(b.node_mask.sum())
        assert b.max_nodes == n and b.attn_bias.shape == (1, n + 1, n + 1) and n + 1 >= 513
        assert b.node_capacity == 1024 and b.y.shape[0] == max(int(b.y_slot_mask.sum()), 128)
    groups = list(stack_microbatches(iter(pb), 3, pad_tail=True))
    _assert_batches_equal(groups, jstack(iter(jb), 3, pad_tail=True))
    assert groups[0]["attn_bias"].shape[-1] == max(b.max_nodes for b in pb[:3]) + 1
