"""Remat in the port (``models/remat.py``) on the CPU: every policy gives the
loss, the gradients and the generator states of a run without remat with
dropout on (bit for bit), matches the JAX package's remat with dropout off,
saves what its policy names (in the predicted order of bytes), and reruns
the attention kernels' forwards in the recompute."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import collate, to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_batch_items
from multimodaldiscussiontransformer_tpu_torch.models import bert, remat
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import dropout_rngs
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict, to_flax_params

torch.set_num_threads(2)
IMG = (3, 32, 32)
POLICIES = ("full", "dots", "dots_saveable", "names", "names_heavy")


def host_batch(seed=0):
    items = synthetic_batch_items(3, seed=seed, min_nodes=4, max_nodes=8, seq_len=16, vocab_size=128,
                                  image_prob=0.5, image_shape=IMG)
    return collate(items, spatial_pos_max=5, node_buckets=(8,), node_capacity_buckets=(32,),
                   image_capacity_buckets=(8,), label_capacity_buckets=(16,), image_shape=IMG).asdict()


def dropout_config(**kw):
    """The tiny model with dropout at every site, both towers fused (the
    tower attention's Philox dropout draws seeds too)."""
    m = pconfig.tiny_model_config(dropout=0.3, attention_dropout=0.3, act_dropout=0.2, **kw)
    fused = dict(use_pallas_attention=True, attention_probs_dropout_prob=0.2, hidden_dropout_prob=0.1)
    return m.replace(text_tower=dataclasses.replace(m.text_tower, **fused),
                     image_tower=dataclasses.replace(m.image_tower, **fused))


def loss_and_grads(cfg, batch):
    """One training forward and backward from fixed weights and generators:
    (loss, grads by name, host and device generator states after)."""
    model = MDTModel(cfg, generator=torch.Generator().manual_seed(0))
    host, device = torch.Generator().manual_seed(5), torch.Generator().manual_seed(6)
    with dropout_rngs(host, device):
        loss = (model(batch, deterministic=False).logits.float() ** 2).sum()
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return loss.item(), grads, host.get_state(), device.get_state()


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_equals_no_remat_with_dropout(policy):
    """The recompute replays the segment's dropout: loss, every gradient
    and both generators' final states equal the run without remat, bit for
    bit."""
    batch = to_tensors(host_batch(), "cpu")
    base = dropout_config()
    ref = loss_and_grads(base, batch)
    got = loss_and_grads(base.replace(remat=True, remat_policy=policy), batch)
    assert got[0] == ref[0]
    assert set(got[1]) == set(ref[1]) and len(ref[1]) > 50
    for k, g in ref[1].items():
        assert torch.equal(got[1][k], g), k
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])


def test_remat_without_the_replay_would_differ(monkeypatch):
    """The generator replay is what makes remat exact: a recompute that
    draws on from where the generators stand gives other gradients."""
    batch = to_tensors(host_batch(), "cpu")
    cfg = dropout_config().replace(remat=True, remat_policy="full")
    ref = loss_and_grads(cfg, batch)

    @contextlib.contextmanager
    def draw_on(host, device, entry, tags):  # the generators as they stand, no reset
        with dropout_rngs(host, device), remat._tags(tags):
            yield

    monkeypatch.setattr(remat, "_replay", draw_on)
    host, device = torch.Generator().manual_seed(5), torch.Generator().manual_seed(6)
    model = MDTModel(cfg, generator=torch.Generator().manual_seed(0))
    with dropout_rngs(host, device):
        (model(batch, deterministic=False).logits.float() ** 2).sum().backward()
    assert any(not torch.equal(p.grad, ref[1][n]) for n, p in model.named_parameters() if p.grad is not None)


@pytest.mark.parametrize("policy", ["full", "names_heavy"])
def test_remat_matches_jax_remat(policy):
    """Dropout off, float32: the port's remat loss and gradients against
    JAX's ``jax.checkpoint`` with the same policy on the same weights (rtol
    2e-4, atol 1e-5 on gradients of order 1: float32 sums in other orders),
    as the JAX package's
    ``tests/test_train.py::test_remat_policies_match_no_remat``."""
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)

    def cfg(mod):
        m = mod.tiny_model_config(remat=True, remat_policy=policy)
        return m.replace(text_tower=dataclasses.replace(m.text_tower, **no_drop),
                         image_tower=dataclasses.replace(m.image_tower, **no_drop))

    host = host_batch()
    model = MDTModel(cfg(pconfig), generator=torch.Generator().manual_seed(0))
    params = to_flax_params(model)
    with dropout_rngs(torch.Generator(), torch.Generator()):
        loss = (model(to_tensors(host, "cpu"), deterministic=False).logits.float() ** 2).sum()
        loss.backward()

    jmodel = JaxMDTModel(cfg(jconfig))
    jb = {k: jnp.asarray(v) for k, v in host.items()}

    def loss_fn(p):
        out = jmodel.apply(p, jb, deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out.logits.astype(jnp.float32) ** 2)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = flax_to_state_dict(jax.device_get(jgrads))
    named = dict(model.named_parameters())
    for k, g in want.items():
        got = named[k].grad
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=2e-4, atol=1e-5, err_msg=k)


def _saved_bytes(cfg, batch) -> int:
    """Bytes the backward keeps after a training forward: what autograd
    saves outside the remat segments (the segments' inputs included), seen
    through ``saved_tensors_hooks``, plus the outputs the selective policy
    caches inside them (sized from the saved ops' operands)."""
    model = MDTModel(cfg, generator=torch.Generator().manual_seed(0))
    seen, total = set(), [0]

    def pack(t):
        key = (t.untyped_storage().data_ptr(), t.dtype)
        if key not in seen:
            seen.add(key)
            total[0] += t.untyped_storage().nbytes()
        return t

    def out_bytes(op, args):
        if op == remat.NAMED_OP:
            return args[0].numel() * args[0].element_size()
        a, b = (args[1], args[2]) if op in (torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default) else args[:2]
        return a.numel() // a.shape[-1] * b.shape[-1] * a.element_size()

    policy_saves = remat.saved_ops

    def counting(policy):
        saves = policy_saves(policy)

        def check(op, args):
            keep = saves(op, args)
            if keep:
                total[0] += out_bytes(op, args)
            return keep

        return check

    remat.saved_ops = counting
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                dropout_rngs(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)):
            model(batch, deterministic=False)
    finally:
        remat.saved_ops = policy_saves
    return total[0]


def test_saved_bytes_follow_the_policy_order():
    """full < names < names_heavy < dots <= dots_saveable < no remat, on a
    batch with images and the towers unfused (their attention products are
    ``bmm``s, which only ``dots_saveable`` keeps)."""
    batch = to_tensors(host_batch(1), "cpu")
    base = pconfig.tiny_model_config(dropout=0.3, attention_dropout=0.3)
    got = {p: _saved_bytes(base.replace(remat=True, remat_policy=p), batch) for p in POLICIES}
    got["none"] = _saved_bytes(base, batch)
    assert got["full"] < got["names"] < got["names_heavy"] < got["dots"] <= got["dots_saveable"] < got["none"], got
    assert got["dots"] < got["dots_saveable"], got


@pytest.mark.parametrize("policy", ["full", "dots_saveable", "names_heavy"])
def test_recompute_reruns_the_kernels_and_saves_no_kernel_output(policy, monkeypatch):
    """The policies save only matmul outputs and tagged tensors (never an
    allocation that a kernel writes), and the backward reruns every tree
    and tower attention forward of a segment whose backward runs."""
    calls = {"tree": 0, "tower": 0}
    saved = set()
    tree, tower, policy_saves = ta.tree_attention, bert.masked_attention, remat.saved_ops

    def count(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    def spy(p):
        saves = policy_saves(p)

        def check(op, args):
            keep = saves(op, args)
            if keep:
                saved.add(op)
            return keep

        return check

    monkeypatch.setattr(ta, "tree_attention", count("tree", tree))
    monkeypatch.setattr(bert, "masked_attention", count("tower", tower))
    monkeypatch.setattr(remat, "saved_ops", spy)
    batch = to_tensors(host_batch(), "cpu")
    base = dropout_config()

    def run(cfg):
        calls.update(tree=0, tower=0)
        loss_and_grads(cfg, batch)
        return dict(calls)

    plain = run(base)
    got = run(base.replace(remat=True, remat_policy=policy))
    # the recompute reruns the graph layers whose backward the node loss
    # reaches (the last stack feeds only the global embedding) and every
    # fusion layer's towers; the bottom towers stay outside remat
    graph_bwd = base.num_graph_stack * (base.num_fusion_stacks - 1)
    fusion_towers = plain["tower"] - base.num_bottom_text_layers - base.num_bottom_image_layers
    assert got["tree"] == plain["tree"] + graph_bwd, (got, plain)
    assert got["tower"] == plain["tower"] + fusion_towers, (got, plain)
    allowed = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
               torch.ops.aten.baddbmm.default, remat.NAMED_OP}
    assert saved <= allowed and bool(saved) == (policy != "full"), saved


def test_tags_are_identities_outside_remat():
    x = torch.randn(3, 4)
    assert remat.checkpoint_name(x, "attn_out") is x
    with pytest.raises(ValueError):
        MDTModel(pconfig.tiny_model_config(remat=True, remat_policy="everything"))
