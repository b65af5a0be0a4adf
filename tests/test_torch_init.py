"""The port's random init draws from the JAX modules' distributions: for
every parameter of the tiny model, the empirical std and the range (max |x|
in units of the std, which tells a truncated normal, ~2.3, from a uniform,
~1.7, and a normal, >3) agree with a JAX init of the same shapes.

Bounds: std within 20% and range within 25% for tensors of >= 1024 entries
(sampling noise is a few percent there); std within 50% for smaller ones;
parameters the JAX init sets to a constant are that constant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core.config import tiny_model_config as jax_tiny_config
from multimodaldiscussiontransformer_tpu.data.collator import collate as jax_collate
from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_batch_items as jax_items
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu.models.mdt import apply_graphormer_init_params
from multimodaldiscussiontransformer_tpu_torch.core.config import tiny_model_config
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import to_flax_params

torch.set_num_threads(2)
IMG = (3, 32, 32)


def _flat(tree):
    return {
        "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.mark.parametrize("graphormer_init", [False, True])
def test_init_distributions_match_jax(graphormer_init):
    items = jax_items(2, seed=0, seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8, image_prob=0.5)
    batch = {k: jnp.asarray(v) for k, v in jax_collate(items, image_shape=IMG).asdict().items()}
    want = JaxMDTModel(jax_tiny_config()).init(jax.random.PRNGKey(0), batch, deterministic=True)
    if graphormer_init:
        want = apply_graphormer_init_params(want, jax.random.PRNGKey(1))
    want = _flat(jax.device_get(want)["params"])
    port = MDTModel(tiny_model_config(apply_graphormer_init=graphormer_init), generator=torch.Generator().manual_seed(0))
    got = _flat(to_flax_params(port)["params"])
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        std_ratio = g.std() / w.std()
        if w.size >= 1024:
            range_ratio = (np.abs(g).max() / g.std()) / (np.abs(w).max() / w.std())
            assert 0.8 < std_ratio < 1.25 and 0.75 < range_ratio < 1.33, (key, std_ratio, range_ratio)
        else:
            assert 0.5 < std_ratio < 2.0, (key, std_ratio)
