"""The port's tower attention (``ops/masked_attention.py``) against the JAX
package's, in float32 on the CPU.

- Rate 0: the port's forward and autograd gradients (dq, dk, dv) against
  JAX ``masked_attention`` with ``FORCE_KERNEL`` (the Pallas forward and
  backward in interpret mode, through its custom VJP) and against JAX's
  XLA ``masked_attention_reference``, with and without key padding, at an S
  that is not a multiple of 8.
- A row whose every key is padding: the port equals JAX's XLA reference
  (equal weights over the S keys); JAX's kernel spreads the row over its
  8-padded S as well, so only real rows are compared with it.
- ``SelfAttention`` with ``use_pallas`` against JAX's, as
  ``tests/test_masked_attention.py`` holds it.
- Rate 0.3: the TPU's dropout bits cannot be reproduced, so the plain
  version is held to its own contract: the mask read back equals the
  Philox mask (``ops/tree_attention.py``), determinism, seed sensitivity,
  the kept fraction, and the adjoint identity.
- The tiny ``MDTModel`` with both towers fused against JAX's (both Pallas
  kernels in interpret mode) on real nodes, at rtol 2e-4 / atol 2e-5 as
  ``tests/test_masked_attention.py`` holds JAX's own; one scan update with
  fused towers against the JAX ``Trainer``; capacity-padding rows never
  reach the loss.

Tolerance: rtol 2e-5 / atol 2e-6 on outputs (the JAX kernel tests' own);
gradients within 2e-5 x their largest magnitude (sums in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.models import bert as jbert
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu.ops import masked_attention as jma
from multimodaldiscussiontransformer_tpu.ops import tree_attention as jta
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import collate, to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_batch_items
from multimodaldiscussiontransformer_tpu_torch.losses.node_cross_entropy import node_cross_entropy_loss
from multimodaldiscussiontransformer_tpu_torch.models import bert
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict, load_flax_params, to_flax_params
from test_torch_masked_attention_card import _inputs, forward_and_grads, read_back_mask
from test_torch_models import IMG, batch_pair, perturbed
from test_torch_train import assert_scan_step_matches_jax, train_cfg

torch.set_num_threads(2)
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_REL = 2e-5
MODEL_TOL = dict(rtol=2e-4, atol=2e-5)


def fused_towers(model_cfg):
    """``model_cfg`` with ``use_pallas_attention`` on in both towers."""
    return model_cfg.replace(
        text_tower=dataclasses.replace(model_cfg.text_tower, use_pallas_attention=True),
        image_tower=dataclasses.replace(model_cfg.image_tower, use_pallas_attention=True),
    )


def _jax_grads(fn, q, k, v, g):
    """fn's output and its vjp of g, in one jit (eagerly each op compiles
    on its own)."""

    def run(q_, k_, v_, g_):
        out, vjp = jax.vjp(fn, q_, k_, v_)
        return (out, *vjp(g_))

    return [np.asarray(x) for x in jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, g)))]


def _port_grads(q, k, v, bias, g, **kw):
    got = forward_and_grads(ma.masked_attention, *(torch.from_numpy(x) for x in (q, k, v)),
                            None if bias is None else torch.from_numpy(bias), torch.from_numpy(g), **kw)
    return [x.numpy() for x in got]


def _assert_close(got, want, rows=slice(None)):
    np.testing.assert_allclose(got[0][rows], want[0][rows], **OUT_TOL)
    for name, a, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(a - w).max() <= GRAD_REL * scale, (name, np.abs(a - w).max(), scale)


@pytest.mark.parametrize(
    "b, h, s, dh, masked",
    [
        (3, 2, 17, 8, True),  # S padded to 24 by the JAX kernel
        (2, 2, 13, 16, False),  # no bias (the ViT tower)
    ],
)
def test_forward_and_grads_match_jax_kernel_and_reference(monkeypatch, b, h, s, dh, masked):
    monkeypatch.setattr(jma, "FORCE_KERNEL", True)
    q, k, v, bias = _inputs(31, b, h, s, dh, masked)
    g = np.random.default_rng(32).standard_normal(q.shape).astype(np.float32)
    jbias = None if bias is None else jnp.asarray(bias)
    got = _port_grads(q, k, v, bias, g)
    _assert_close(got, _jax_grads(lambda q_, k_, v_: jma.masked_attention(q_, k_, v_, jbias), q, k, v, g))
    _assert_close(got, _jax_grads(lambda q_, k_, v_: jma.masked_attention_reference(q_, k_, v_, jbias), q, k, v, g))
    plain = ma.masked_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                          None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jma.masked_attention_reference(q, k, v, jbias)), **OUT_TOL)


def test_fully_masked_rows(monkeypatch):
    """Batch row 1 has every key masked: finite, equal weights over S as in
    JAX's reference; the other rows equal JAX's kernel."""
    monkeypatch.setattr(jma, "FORCE_KERNEL", True)
    q, k, v, bias = _inputs(33, 3, 2, 11, 8, True)
    bias[1] = ta.MASK_BIAS
    g = np.random.default_rng(34).standard_normal(q.shape).astype(np.float32)
    got = _port_grads(q, k, v, bias, g)
    assert all(np.isfinite(x).all() for x in got)
    np.testing.assert_allclose(got[0][1], np.broadcast_to(v[1].mean(axis=1, keepdims=True), v[1].shape), **OUT_TOL)
    jb = jnp.asarray(bias)
    _assert_close(got, _jax_grads(lambda *a: jma.masked_attention_reference(*a, jb), q, k, v, g))
    kernel = _jax_grads(lambda *a: jma.masked_attention(*a, jb), q, k, v, g)
    np.testing.assert_allclose(got[0][[0, 2]], kernel[0][[0, 2]], **OUT_TOL)


def test_self_attention_fused_matches_jax(monkeypatch):
    """``SelfAttention(use_pallas=True)``: JAX through its kernel
    (deterministic, interpret mode), the port through the fused op's plain
    version, from the same weights."""
    monkeypatch.setattr(jma, "FORCE_KERNEL", True)
    rng = np.random.default_rng(5)
    b, s, d, h = 3, 17, 32, 4
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    jbias = jbert.attention_mask_bias(jnp.asarray(mask), jnp.float32)
    mod = jbert.SelfAttention(d, h, 0.0, use_pallas=True)
    # jitted: eagerly each op (the interpret-mode kernel's too) compiles on its own
    params = jax.device_get(jax.jit(lambda r: mod.init(r, jnp.asarray(hidden), jbias))(jax.random.PRNGKey(0)))
    want = np.asarray(jax.jit(lambda p: mod.apply(p, jnp.asarray(hidden), jbias, deterministic=True))(params))
    port = bert.SelfAttention(d, h, torch.float32, 0.0, use_pallas=True)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    before = [fn.launches for fn in ma.KERNELS]
    with torch.no_grad():
        got = port(torch.from_numpy(hidden), bert.attention_mask_bias(torch.from_numpy(mask), torch.float32)).numpy()
    np.testing.assert_allclose(got, want, **OUT_TOL)
    assert [fn.launches for fn in ma.KERNELS] == before  # the CPU path launches nothing


def test_plain_mask_is_the_philox_mask_and_keeps_one_minus_rate():
    """q = k = 0 and v = one-hot columns read the keep mask back out of the
    plain dropout version: it is ``tree_attention.dropout_keep_mask``,
    deterministic, seed-sensitive, with a kept fraction near 1 - rate."""
    b, h, s, rate = 3, 4, 21, 0.3
    a = read_back_mask(ma.masked_attention, b, h, s, rate, seed=11, device="cpu")
    assert torch.equal(a, ta.dropout_keep_mask(11, b, h, s, rate))
    assert torch.equal(a, read_back_mask(ma.masked_attention, b, h, s, rate, seed=11, device="cpu"))
    assert not torch.equal(a, read_back_mask(ma.masked_attention, b, h, s, rate, seed=12, device="cpu"))
    # 5,292 draws: the kept fraction is 0.7 within 5 standard errors
    assert abs(a.float().mean().item() - 0.7) < 5 * (0.21 / a.numel()) ** 0.5


def test_plain_dropout_adjoint_identity():
    """<g, f(v2)> = <vjp_v(g), v2>: f is linear in v for a fixed mask, so
    this holds only if the backward sees the forward's mask."""
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(35, 2, 3, 14, 8, True))
    gen = torch.Generator().manual_seed(6)
    g, v2 = (torch.randn(q.shape, generator=gen, dtype=torch.float64).float() for _ in range(2))
    vv = v.clone().requires_grad_(True)
    ma.masked_attention(q, k, vv, bias, seed=9, rate=0.3).backward(g)
    lhs = (g.double() * ma.masked_attention(q, k, v2, bias, seed=9, rate=0.3).double()).sum().item()
    rhs = (vv.grad.double() * v2.double()).sum().item()
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0), (lhs, rhs)


def test_check_supported_accepts_fused_towers():
    """Both tower flags build a model whose attention layers take the fused
    op."""
    model = MDTModel(fused_towers(pconfig.tiny_model_config()))
    layers = [m for m in model.modules() if isinstance(m, bert.SelfAttention)]
    assert layers and all(m.use_pallas for m in layers)


def test_mdt_model_with_fused_towers_matches_jax(monkeypatch):
    """The tiny model with both towers fused, deterministic: logits on real
    node slots and the global embedding against JAX's with its tower and
    tree-attention kernels in interpret mode, from the same weights."""
    monkeypatch.setattr(jma, "FORCE_KERNEL", True)
    monkeypatch.setattr(jta, "FORCE_KERNEL", True)
    jb, pb = batch_pair(7, num_graphs=3, image_prob=0.5)
    assert pb.images.shape[0] > 0
    jx = {k: jnp.asarray(v) for k, v in jb.asdict().items()}
    # the weights from the port's init (JAX's eager init would run the
    # interpret-mode kernels once more), perturbed as the JAX-init ones are
    params = perturbed(to_flax_params(MDTModel(pconfig.tiny_model_config(), generator=torch.Generator().manual_seed(0))))
    want = jax.jit(lambda p, b: JaxMDTModel(fused_towers(jconfig.tiny_model_config())).apply(p, b, deterministic=True))(
        params, jx)
    port = MDTModel(fused_towers(pconfig.tiny_model_config()))
    load_flax_params(port, params)
    before = [fn.launches for fn in ma.KERNELS]
    with torch.no_grad():
        got = port.eval()(to_tensors(pb, "cpu"))
    assert [fn.launches for fn in ma.KERNELS] == before
    mask = pb.node_mask
    np.testing.assert_allclose(got.logits.numpy()[mask], np.asarray(want.logits)[mask], **MODEL_TOL)
    np.testing.assert_allclose(got.global_embedding.numpy(), np.asarray(want.global_embedding), **MODEL_TOL)


def test_scan_step_with_fused_towers_matches_jax(monkeypatch):
    """One update (3 microbatches, every dropout 0) with both towers fused:
    the port's gradients and updated parameters against the JAX
    ``Trainer``'s with its tower kernel in interpret mode (forward and the
    custom-VJP backward), at ``test_torch_train``'s tolerances."""
    monkeypatch.setattr(jma, "FORCE_KERNEL", True)

    def fused(mod, **kw):
        cfg = train_cfg(mod, **kw)
        return dataclasses.replace(cfg, model=fused_towers(cfg.model))

    assert_scan_step_matches_jax(fused(jconfig, fast_dropout_rng=False), fused(pconfig))


def test_capacity_padding_rows_never_reach_the_loss():
    """Capacity-padding text rows have every key masked in the bottom tower:
    the fused op gives them equal weights over their keys (finite states).
    Whatever tokens they hold, the loss and every gradient are unchanged."""
    model = MDTModel(fused_towers(pconfig.tiny_model_config()), generator=torch.Generator().manual_seed(1))
    items = synthetic_batch_items(2, seed=3, seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8, image_prob=0.5)
    batch = to_tensors(collate(items, image_shape=IMG, node_capacity_buckets=(64,)), "cpu")
    pad = ~batch["node_mask"]
    assert pad.sum() > 0 and not batch["attention_mask"][pad].any()

    def loss_and_grads(b):
        model.zero_grad(set_to_none=True)
        out = model(b)
        loss = node_cross_entropy_loss(out.logits, b["y"], b["y_node"], b["y_slot_mask"], 1.5, 1.0)[0]
        loss.backward()
        assert torch.isfinite(out.text_states).all()
        return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    loss, grads = loss_and_grads(batch)
    other = dict(batch)
    other["input_ids"] = torch.where(pad[:, None], torch.randint_like(batch["input_ids"], 1, 128), batch["input_ids"])
    loss2, grads2 = loss_and_grads(other)
    assert torch.equal(loss, loss2) and grads.keys() == grads2.keys()
    for n, g in grads.items():
        assert torch.equal(g, grads2[n]), n
