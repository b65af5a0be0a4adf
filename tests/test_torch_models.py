"""Port model modules against the JAX package's Flax modules, in float32 on
the CPU.

Each test gives both sides the same numpy inputs and the same weights (Flax
init, perturbed so that biases and layer-norm affines are not trivial,
carried over with ``utils/flax_import.py``). Where the JAX side reaches the
tree-attention Pallas kernel, ``ta.FORCE_KERNEL`` runs it in interpret mode.
Tolerance: rtol/atol 1e-5 (float32; XLA and PyTorch sum in different
orders), 2e-4 where a Pallas kernel is on the JAX side (its own tests'
tolerance).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multimodaldiscussiontransformer_tpu.core.config import tiny_model_config as jax_tiny_config
from multimodaldiscussiontransformer_tpu.data.collator import collate as jax_collate
from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_batch_items as jax_items
from multimodaldiscussiontransformer_tpu.models import bert as jbert
from multimodaldiscussiontransformer_tpu.models import graphormer as jgraph
from multimodaldiscussiontransformer_tpu.models import vit as jvit
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu.ops import tree_attention as jta
from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig, tiny_model_config
from multimodaldiscussiontransformer_tpu_torch.data.collator import collate, to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.preprocess import preprocess_item
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_batch_items
from multimodaldiscussiontransformer_tpu_torch.data.trees import tree_distance_pairs
from multimodaldiscussiontransformer_tpu_torch.models import bert, graphormer, vit
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import (
    flax_to_state_dict,
    load_flax_params,
    to_flax_params,
)

torch.set_num_threads(2)
IMG = (3, 32, 32)
F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)


def perturbed(params, seed=0):
    """Flax params with every leaf moved by N(0, 0.05) noise."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        jax.device_get(params),
    )


def jit_init(mod, key, *args, **kw):
    """``mod.init`` in one jit (eagerly each op compiles on its own); the
    arguments are closed over, so ``None`` and ``method`` stay static."""
    return jax.jit(lambda r: mod.init(r, *args, **kw))(key)


def jit_apply(mod, params, *args, **kw):
    """``mod.apply`` in one jit, as ``jit_init``."""
    return jax.jit(lambda p: mod.apply(p, *args, **kw))(params)


def ported(module, params):
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module


def t(x):
    return torch.from_numpy(np.asarray(x))


def batch_pair(seed, num_graphs=2, image_prob=0.5, **kw):
    """The same synthetic items collated by both packages (asserted equal)."""
    item_kw = dict(seed=seed, seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8, image_prob=image_prob)
    jb = jax_collate(jax_items(num_graphs, **item_kw), image_shape=IMG, **kw)
    pb = collate(synthetic_batch_items(num_graphs, **item_kw), image_shape=IMG, **kw)
    for k, v in jb.asdict().items():
        np.testing.assert_array_equal(v, pb.asdict()[k], err_msg=k)
    return jb, pb


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setattr(jta, "FORCE_KERNEL", True)


def test_bert_layer():
    cfg = jax_tiny_config().text_tower
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 7, 64)).astype(np.float32)
    mask = (rng.random((2, 7)) < 0.7).astype(np.int32)
    mask[:, 0] = 1
    jbias = jbert.attention_mask_bias(jnp.asarray(mask), jnp.float32)
    mod = jbert.BertLayer(cfg)
    params = perturbed(jit_init(mod, jax.random.PRNGKey(0), jnp.asarray(hidden), jbias))
    want = jit_apply(mod, params, jnp.asarray(hidden), jbias)
    port = ported(bert.BertLayer(tiny_model_config().text_tower, F32), params)
    with torch.no_grad():
        got = port(t(hidden), bert.attention_mask_bias(t(mask), F32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("num_images", [3, 0])
def test_vit_embeddings(num_images):
    """Patch conv (HWIO -> OIHW), CLS and positions; a zero-capacity image
    buffer flows through."""
    cfg = jax_tiny_config().image_tower
    rng = np.random.default_rng(2)
    pixels = rng.standard_normal((num_images,) + IMG).astype(np.float32)
    mod = jvit.ViTEmbeddings(cfg)
    params = perturbed(jit_init(mod, jax.random.PRNGKey(0), jnp.zeros((1,) + IMG)))
    want = np.asarray(jit_apply(mod, params, jnp.asarray(pixels)))
    port = ported(vit.ViTEmbeddings(tiny_model_config().image_tower, F32), params)
    with torch.no_grad():
        got = port(t(pixels)).numpy()
    assert got.shape == want.shape == (num_images, cfg.seq_len, cfg.hidden_size)
    np.testing.assert_allclose(got, want, **TOL)


def test_vit_layer():
    cfg = jax_tiny_config().image_tower
    hidden = np.random.default_rng(3).standard_normal((3, cfg.seq_len, 64)).astype(np.float32)
    mod = jvit.ViTLayer(cfg)
    params = perturbed(jit_init(mod, jax.random.PRNGKey(0), jnp.asarray(hidden)))
    want = jit_apply(mod, params, jnp.asarray(hidden))
    port = ported(vit.ViTLayer(tiny_model_config().image_tower, F32), params)
    with torch.no_grad():
        got = port(t(hidden))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _graph_inputs(seed):
    jb, _ = batch_pair(seed, image_prob=0.0)
    return jb.attn_bias, jb.spatial_pos


def test_graph_attn_bias_dense_and_compact():
    template, spatial = _graph_inputs(4)
    mod = jgraph.GraphAttnBias(jax_tiny_config())
    params = perturbed(jit_init(mod, jax.random.PRNGKey(0), jnp.asarray(template), jnp.asarray(spatial)))
    dense = np.asarray(jit_apply(mod, params, jnp.asarray(template), jnp.asarray(spatial)))
    compact = jit_apply(mod, params, jnp.asarray(template), jnp.asarray(spatial), method=jgraph.GraphAttnBias.compact_inputs)
    port = ported(graphormer.GraphAttnBias(tiny_model_config(), F32), params)
    with torch.no_grad():
        got_dense = port(t(template), t(spatial).long()).numpy()
        got_compact = port.compact_inputs(t(template), t(spatial).long())
    assert np.isinf(dense).any()
    np.testing.assert_allclose(got_dense, dense, **TOL)  # -inf in the same places
    for g, w in zip(got_compact, compact):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _attention_inputs(seed):
    template, spatial = _graph_inputs(seed)
    b, s, _ = template.shape
    x = np.random.default_rng(seed).standard_normal((b, s, 64)).astype(np.float32)
    return x, template, spatial


@pytest.mark.parametrize("compact", [True, False])
def test_biased_multihead_attention(pallas, compact):
    """Compact path (JAX: the Pallas kernel) and the dense-bias plain path
    with key padding."""
    x, template, spatial = _attention_inputs(5)
    jcfg = jax_tiny_config(use_pallas_attention=compact)
    jbias_mod = jgraph.GraphAttnBias(jcfg)
    bparams = perturbed(jit_init(jbias_mod, jax.random.PRNGKey(1), jnp.asarray(template), jnp.asarray(spatial)), 1)
    if compact:
        jbias = jit_apply(jbias_mod, bparams, jnp.asarray(template), jnp.asarray(spatial), method=jgraph.GraphAttnBias.compact_inputs)
    else:
        jbias = jit_apply(jbias_mod, bparams, jnp.asarray(template), jnp.asarray(spatial))
    grid_mask = np.any(spatial > 0, axis=-1)
    kpm = np.concatenate([np.zeros((x.shape[0], 1), bool), ~grid_mask], axis=1)
    mod = jgraph.BiasedMultiheadAttention(jcfg)
    params = perturbed(jit_init(mod, jax.random.PRNGKey(0), jnp.asarray(x), jbias, jnp.asarray(kpm)))
    want = np.asarray(jax.jit(mod.apply)(params, jnp.asarray(x), jbias, jnp.asarray(kpm)))

    pcfg = tiny_model_config(use_pallas_attention=compact)
    pbias_mod = ported(graphormer.GraphAttnBias(pcfg, F32), bparams)
    port = ported(graphormer.BiasedMultiheadAttention(pcfg, F32), params)
    with torch.no_grad():
        args = (t(template), t(spatial).long())
        pbias = pbias_mod.compact_inputs(*args) if compact else pbias_mod(*args)
        got = port(t(x), pbias, t(kpm)).numpy()
    np.testing.assert_allclose(got, want, **(KERNEL_TOL if compact else TOL))


def test_graph_encoder_stack(pallas):
    x, template, spatial = _attention_inputs(6)
    jcfg = jax_tiny_config()
    jbias_mod = jgraph.GraphAttnBias(jcfg)
    bparams = perturbed(jit_init(jbias_mod, jax.random.PRNGKey(1), jnp.asarray(template), jnp.asarray(spatial)), 1)
    jbias = jit_apply(jbias_mod, bparams, jnp.asarray(template), jnp.asarray(spatial), method=jgraph.GraphAttnBias.compact_inputs)
    mod = jgraph.GraphEncoderStack(jcfg, 2)
    params = perturbed(jit_init(mod, jax.random.PRNGKey(0), jnp.asarray(x), jbias, None))
    want = np.asarray(jax.jit(mod.apply)(params, jnp.asarray(x), jbias, None))
    port = ported(graphormer.GraphEncoderStack(tiny_model_config(), 2, F32), params)
    pbias = ported(graphormer.GraphAttnBias(tiny_model_config(), F32), bparams)
    with torch.no_grad():
        got = port(t(x), pbias.compact_inputs(t(template), t(spatial).long()), None).numpy()
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


def test_masked_embed_saturates_and_zeroes_padding():
    table = torch.arange(12, dtype=F32).view(4, 3) + 1
    ids = torch.tensor([[0, 1, 3, 4, 99, -2]])
    out = graphormer.masked_embed(table, ids)
    want = jgraph.masked_embed(jnp.asarray(table.numpy()), jnp.asarray(ids.numpy()))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert (out[0, 0] == 0).all() and (out[0, 4] == table[3]).all()


@pytest.fixture(scope="module")
def models():
    """A JAX MDTModel's params on tiny_model_config, and the port model
    carrying them."""
    # the port's init carried to the Flax layout (a jitted Flax init costs
    # ~15 s here), perturbed as a JAX init would be
    params = perturbed(to_flax_params(MDTModel(tiny_model_config(), generator=torch.Generator().manual_seed(0))))
    port = MDTModel(tiny_model_config())
    load_flax_params(port, params)
    return params, port.eval()


def _port_forward(model, batch):
    with torch.no_grad():
        return model(to_tensors(batch, "cpu"))


@pytest.mark.parametrize("use_pallas_attention", [True, False])
@pytest.mark.parametrize("image_prob", [0.5, 0.0])
def test_mdt_model_matches_jax(models, monkeypatch, image_prob, use_pallas_attention):
    """Logits on real node slots and the global embedding, with and without
    images, on the compact (kernel) and the dense-bias path."""
    monkeypatch.setattr(jta, "FORCE_KERNEL", True)
    params, port = models
    jb, pb = batch_pair(7, num_graphs=3, image_prob=image_prob)
    assert (pb.images.shape[0] > 0) == (image_prob > 0)
    jcfg = jax_tiny_config(use_pallas_attention=use_pallas_attention)
    want = jax.jit(lambda p, b: JaxMDTModel(jcfg).apply(p, b, deterministic=True))(
        params, {k: jnp.asarray(v) for k, v in jb.asdict().items()}
    )
    if not use_pallas_attention:
        port = MDTModel(tiny_model_config(use_pallas_attention=False))
        load_flax_params(port, params)
    got = _port_forward(port, pb)
    tol = KERNEL_TOL if use_pallas_attention else TOL
    mask = pb.node_mask
    np.testing.assert_allclose(got.logits.numpy()[mask], np.asarray(want.logits)[mask], **tol)
    np.testing.assert_allclose(got.global_embedding.numpy(), np.asarray(want.global_embedding), **tol)


def test_padding_invariance(models):
    """Same items, larger capacities -> same real-node outputs."""
    _, port = models
    items = synthetic_batch_items(2, seed=2, seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8, image_prob=0.5)
    small = collate(items, image_shape=IMG)
    big = collate(
        items, image_shape=IMG, node_buckets=(32,), node_capacity_buckets=(64,),
        image_capacity_buckets=(16,), label_capacity_buckets=(32,), pad_to_graphs=4,
    )
    assert big.max_nodes > small.max_nodes and big.node_capacity > small.node_capacity
    out_s, out_b = _port_forward(port, small), _port_forward(port, big)
    np.testing.assert_allclose(
        out_s.logits.numpy()[small.node_mask], out_b.logits.numpy()[big.node_mask], rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        out_s.global_embedding.numpy(), out_b.global_embedding.numpy()[:2], rtol=1e-4, atol=1e-5
    )


def test_degree_overflow_saturates_not_nan(models):
    """A star node whose in-degree exceeds ``num_in_degree`` reads the last
    embedding row: finite logits, equal to the same graph with its degrees
    clipped to the table."""
    _, port = models
    cfg = port.config
    n = cfg.num_in_degree + 8
    parents = np.asarray([-1] + [0] * (n - 1), np.int64)
    edges = [(0, i) for i in range(1, n)]
    rng = np.random.default_rng(0)
    item = preprocess_item(
        idx=0,
        tokens={
            "input_ids": rng.integers(1, 128, (n, 16)).astype(np.int32),
            "token_type_ids": np.zeros((n, 16), np.int32),
            "attention_mask": np.ones((n, 16), np.int32),
        },
        edge_index=np.asarray(edges + [(b, a) for a, b in edges], np.int64).T,
        distance_pairs=tree_distance_pairs(parents),
        x_images=np.zeros((0,) + IMG, np.float32),
        x_image_index=np.zeros(n, bool),
        y=np.asarray([1], np.int64),
        y_mask=np.asarray([True] + [False] * (n - 1), bool),
    )
    batch = collate([item], node_buckets=(n,), image_shape=IMG)
    assert batch.in_degree.max() >= cfg.num_in_degree
    logits = _port_forward(port, batch).logits
    assert torch.isfinite(logits).all()
    batch.in_degree = np.minimum(batch.in_degree, cfg.num_in_degree - 1)
    batch.out_degree = np.minimum(batch.out_degree, cfg.num_out_degree - 1)
    torch.testing.assert_close(_port_forward(port, batch).logits, logits, rtol=0, atol=0)


def test_dead_graph_stack_is_not_built():
    """The stack the reference builds but never runs has no parameters;
    with reproduce_dead_graph_stack=False it is built and run. Both stacks
    come after the last fusion, so only the global embedding sees it."""
    dead = MDTModel(tiny_model_config())
    live = MDTModel(tiny_model_config(reproduce_dead_graph_stack=False))
    assert not any(k.startswith("graph_encoder.graph_stack_2.") for k in dead.state_dict())
    assert any(k.startswith("graph_encoder.graph_stack_2.") for k in live.state_dict())
    _, pb = batch_pair(8)
    live.load_state_dict(dead.state_dict(), strict=False)
    out_dead, out_live = _port_forward(dead, pb), _port_forward(live, pb)
    torch.testing.assert_close(out_live.logits, out_dead.logits, rtol=0, atol=0)
    assert not torch.allclose(out_live.global_embedding, out_dead.global_embedding)


def test_init_is_seeded():
    a = MDTModel(tiny_model_config(), generator=torch.Generator().manual_seed(3))
    b = MDTModel(tiny_model_config(), generator=torch.Generator().manual_seed(3))
    c = MDTModel(tiny_model_config(), generator=torch.Generator().manual_seed(4))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.graph_encoder.bottle_neck, c.graph_encoder.bottle_neck)


@pytest.mark.parametrize(
    "override",
    [
        {"param_dtype": "float16"},
        {"dtype": "float16"},
    ],
)
def test_unsupported_settings_raise(override):
    """Dtypes the port lacks raise; ``sequence_parallel`` builds (its ring
    runs once the model is laid out on an sp group:
    ``test_sequence_parallel_without_an_sp_group_is_the_one_device_model``)."""
    with pytest.raises(NotImplementedError):
        MDTModel(tiny_model_config(**override))


def test_sequence_parallel_without_an_sp_group_is_the_one_device_model(models):
    """``sequence_parallel=True`` on a model that no sp group lays out runs
    the one-device path (JAX without an sp axis): the same logits and
    global embedding, bit for bit."""
    _, port = models
    sp = MDTModel(tiny_model_config(sequence_parallel=True))
    sp.load_state_dict(port.state_dict())
    _, pb = batch_pair(3, num_graphs=2, image_prob=0.5)
    a, b = _port_forward(port, pb), _port_forward(sp.eval(), pb)
    assert torch.equal(a.logits, b.logits) and torch.equal(a.global_embedding, b.global_embedding)


def test_config_copy_matches_jax():
    """Same fields and defaults as the JAX package's config."""
    import dataclasses

    from multimodaldiscussiontransformer_tpu.core import config as jconfig
    from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig

    for name in ("BertTowerConfig", "ViTTowerConfig", "ModelConfig", "TaskConfig", "DataConfig", "OptimConfig"):
        want = dataclasses.asdict(getattr(jconfig, name)())
        assert dataclasses.asdict(getattr(pconfig, name)()) == want, name
    assert dataclasses.asdict(pconfig.tiny_model_config()) == dataclasses.asdict(jconfig.tiny_model_config())
    assert isinstance(ModelConfig(), pconfig.ModelConfig)
