"""Weight import from the JAX package's Flax params into the port's model
(``utils/flax_import.py``): every Flax leaf lands in exactly one port tensor,
every port tensor is filled, layouts are converted, and what does not fit
raises."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multimodaldiscussiontransformer_tpu.core.config import tiny_model_config as jax_tiny_config
from multimodaldiscussiontransformer_tpu.data.collator import collate as jax_collate
from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_batch_items as jax_items
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu_torch.core.config import tiny_model_config
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import (
    flax_to_state_dict,
    load_flax_params,
)

torch.set_num_threads(2)
IMG = (3, 32, 32)


@pytest.fixture(scope="module")
def params():
    items = jax_items(2, seed=0, seq_len=12, vocab_size=128, image_shape=IMG, max_nodes=6, image_prob=0.5)
    batch = {k: jnp.asarray(v) for k, v in jax_collate(items, image_shape=IMG).asdict().items()}
    # the tree of a JAX init, traced without compiling it (``eval_shape``),
    # every leaf filled with seeded normal values
    shapes = jax.eval_shape(lambda r, b: JaxMDTModel(jax_tiny_config()).init(r, b, deterministic=True),
                            jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(x.dtype), shapes)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("wrapped", [True, False])
def test_every_leaf_fills_one_port_tensor(params, wrapped):
    tree = params if wrapped else params["params"]
    leaves = dict(_leaves(params["params"]))
    sd = flax_to_state_dict(tree)
    port = MDTModel(tiny_model_config())
    assert len(sd) == len(leaves)
    assert set(sd) == set(port.state_dict())
    load_flax_params(port, tree)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    total = sum(v.size for v in leaves.values())
    assert total == sum(p.numel() for p in port.parameters())


def test_layouts(params):
    p = params["params"]["graph_encoder"]
    sd = flax_to_state_dict(params)
    dense = p["text_model"]["layer_0"]["intermediate_dense"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(sd["graph_encoder.text_model.layer_0.intermediate_dense.weight"].numpy(), dense.T)
    conv = p["vit_model"]["embeddings"]["patch_embeddings"]["kernel"]  # HWIO
    np.testing.assert_array_equal(
        sd["graph_encoder.vit_model.embeddings.patch_embeddings.weight"].numpy(), conv.transpose(3, 2, 0, 1)
    )
    ln = p["emb_layer_norm"]["scale"]
    np.testing.assert_array_equal(sd["graph_encoder.emb_layer_norm.weight"].numpy(), ln)
    emb = p["text_model"]["embeddings"]["word_embeddings"]["embedding"]
    np.testing.assert_array_equal(sd["graph_encoder.text_model.embeddings.word_embeddings.weight"].numpy(), emb)
    for raw in ("bottle_neck",):
        np.testing.assert_array_equal(sd[f"graph_encoder.{raw}"].numpy(), p[raw])
    np.testing.assert_array_equal(
        sd["graph_encoder.graph_attn_bias.spatial_pos_encoder"].numpy(),
        p["graph_attn_bias"]["spatial_pos_encoder"],
    )


def test_dead_graph_stack_on_neither_side(params):
    """Tiny config: fusion stacks [1, 1, 1], graph stacks 0..3, stack 2 dead."""
    assert "graph_stack_2" not in params["params"]["graph_encoder"]
    assert "graph_stack_3" in params["params"]["graph_encoder"]
    assert not any(".graph_stack_2." in k for k in MDTModel(tiny_model_config()).state_dict())


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_misfit_raises(params, fault):
    tree = jax.tree_util.tree_map(np.array, params["params"])
    if fault == "extra":
        tree["graph_encoder"]["unused_head"] = {"kernel": np.zeros((4, 4), np.float32)}
    elif fault == "missing":
        del tree["node_classifier"]["bias"]
    else:
        tree["graph_encoder"]["bottle_neck"] = np.zeros((3, 64), np.float32)
    with pytest.raises(ValueError):
        load_flax_params(MDTModel(tiny_model_config()), tree)
