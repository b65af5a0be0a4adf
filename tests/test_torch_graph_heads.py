"""Other graph head counts than ``ModelConfig()``'s 12: the graph layers'
head dim is ``encoder_embed_dim // encoder_attention_heads``, so
``--encoder-attention-heads 6`` gives DH 128 at d = 768 (the reference's
``multi_graphormer`` base architecture, 1024 over 8 heads) and 24 gives DH
32; on the card bf16 takes the tensor-core tree kernels at every such DH.

On the CPU: the launchers of both packages build one ``ModelConfig`` from
the flag, and the whole model at tiny towers of hidden 128 with 1 graph
head (DH 128) and 4 (DH 32), float32 with dropout off, agrees with the JAX
package's model on the same weights, forward and gradients. The JAX side
runs its tree-attention Pallas kernels in interpret mode
(``ta.FORCE_KERNEL``), as its own tests run them; tolerance rtol/atol 2e-4,
``tests/test_torch_models.py``'s where a Pallas kernel is on the JAX side
(float32 sums in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu.ops import tree_attention as jta
from multimodaldiscussiontransformer_tpu.train import launch as jlaunch
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import collate, to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_batch_items
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from multimodaldiscussiontransformer_tpu_torch.train import launch
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import (
    flax_to_state_dict,
    load_flax_params,
    to_flax_params,
)

torch.set_num_threads(2)
IMG = (3, 32, 32)
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)
HIDDEN = 128  # the towers' and the graph layers' width


def test_launchers_agree_on_six_graph_heads():
    """``--encoder-attention-heads 6`` (graph DH 128 at d = 768) gives the
    same model config in both launchers, on the canonical flags of
    ``run_train.sh 8 4 5 2 2 0``; bf16 there takes the tensor-core kernels."""
    argv = ["--synthetic", "--num-fusion-layers", "8", "--num-bottleneck-tokens", "4", "--spatial-pos-max", "5",
            "--num-graph-stack", "2", "--num-fusion-stack", "2", "--freeze-initial-encoders",
            "--encoder-attention-heads", "6"]
    want = jlaunch.config_from_args(jlaunch.build_parser().parse_args(argv)).model
    got = launch.config_from_args(launch.build_parser().parse_args(argv)).model
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.encoder_attention_heads == 6 and got.encoder_embed_dim // 6 == 128
    assert ta.kernel_route(getattr(torch, got.dtype), got.encoder_embed_dim // 6) == "tensor_core"


def config(module, heads: int):
    """``module``'s tiny config with towers and graph layers of width
    HIDDEN (the towers at 4 heads, DH 32) and ``heads`` graph heads."""
    base = module.tiny_model_config(encoder_embed_dim=HIDDEN, encoder_ffn_embed_dim=HIDDEN,
                                    encoder_attention_heads=heads)
    tower = dict(hidden_size=HIDDEN, intermediate_size=2 * HIDDEN, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
    return base.replace(text_tower=dataclasses.replace(base.text_tower, **tower),
                        image_tower=dataclasses.replace(base.image_tower, **tower))


def host_batch():
    items = synthetic_batch_items(3, seed=4, min_nodes=4, max_nodes=8, seq_len=16, vocab_size=128,
                                  image_prob=0.5, image_shape=IMG)
    return collate(items, spatial_pos_max=5, node_buckets=(8,), node_capacity_buckets=(32,),
                   image_capacity_buckets=(8,), label_capacity_buckets=(16,), image_shape=IMG).asdict()


@pytest.mark.parametrize("heads", [1, 4])
def test_model_at_other_graph_head_counts_matches_jax(monkeypatch, heads):
    """The whole model at 1 graph head (DH 128) and 4 (DH 32): logits and
    the global embedding, then the gradient of sum(logits^2) for every
    parameter, against the JAX model on the same (perturbed) weights."""
    monkeypatch.setattr(jta, "FORCE_KERNEL", True)
    pcfg, jcfg = config(pconfig, heads), config(jconfig, heads)
    assert pcfg.encoder_embed_dim // pcfg.encoder_attention_heads == {1: 128, 4: 32}[heads]
    rng = np.random.default_rng(heads)
    params = jax.tree_util.tree_map(  # biases and layer-norm affines moved off their init
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        to_flax_params(MDTModel(pcfg, generator=torch.Generator().manual_seed(heads))))
    model = MDTModel(pcfg)
    load_flax_params(model, params)
    host = host_batch()
    out = model(to_tensors(host, "cpu"), deterministic=True)
    (out.logits.float() ** 2).sum().backward()

    jmodel = JaxMDTModel(jcfg)
    jb = {k: jnp.asarray(v) for k, v in host.items()}

    def loss_fn(p):
        jout = jmodel.apply(p, jb, deterministic=True)
        return jnp.sum(jout.logits.astype(jnp.float32) ** 2), jout

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, params))
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(jout.logits), **KERNEL_TOL)
    np.testing.assert_allclose(out.global_embedding.detach().numpy(), np.asarray(jout.global_embedding),
                               **KERNEL_TOL)
    want = flax_to_state_dict(jax.device_get(jgrads))
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        got = named[name].grad
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), err_msg=name, **KERNEL_TOL)
