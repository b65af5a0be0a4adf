"""The plain ring tree attention of ``ops/ring_attention.py`` against the JAX
package's ring (``ring_tree_attention`` on 2- and 4-device CPU meshes,
``ring_tree_attention_dispatch`` on an sp mesh) and against the whole-S
tree attention reference, forward and dq, dk, dv, dLUT in float32 within
1e-5, S divisible by the ring or not (a fully padded last block included);
the plain versions of the three tile kernels against autograd; and the
ring's dropout: keep statistics, and masks that differ across strips,
blocks and data-parallel shards. No process is spawned (the distributed
ring is held against this plain ring in ``test_torch_sequence_parallel.py``
and ``test_torch_parallel_four.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.ops import ring_attention as jra
from multimodaldiscussiontransformer_tpu.ops import tree_attention as jta
from multimodaldiscussiontransformer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodaldiscussiontransformer_tpu_torch.ops import ring_attention as ra
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, b=2, h=3, s=16, dh=8):
    """numpy inputs as the JAX ring tests make them: 20% of the template at
    MASK_BIAS (column 0 open), ids over the whole LUT, LUT row 0 zero."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    template = np.where(rng.random((b, s, s)) < 0.2, ta.MASK_BIAS, 0.0).astype(np.float32)
    template[:, :, 0] = 0.0
    ids = rng.integers(0, ta.LUT_SIZE, (b, s, s)).astype(np.int32)
    lut = rng.standard_normal((ta.LUT_SIZE, h)).astype(np.float32)
    lut[0] = 0.0
    cot = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    return q, k, v, template, ids, lut, cot


def _torch_grads(fn, q, k, v, lut, cot):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, lut)]
    out = fn(*leaves)
    out.backward(torch.from_numpy(cot))
    return [out.detach().numpy()] + [x.grad.numpy() for x in leaves]


def _jax_grads(fn, q, k, v, lut, cot):
    """fn's output and its vjp of cot, in one jit (one compile, where the
    eager vjp compiles op by op)."""

    def run(q_, k_, v_, lut_, cot_):
        out, vjp = jax.vjp(fn, q_, k_, v_, lut_)
        return (out, *vjp(cot_))

    return [np.asarray(x) for x in jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, lut, cot)))]


@pytest.mark.parametrize("n", [2, 4])
def test_plain_ring_matches_jax_ring(n):
    """The output and the gradients of q, k, v and the LUT equal JAX's
    ``ring_tree_attention`` over an n-device mesh axis (S = 16)."""
    q, k, v, template, ids, lut, cot = _inputs(n)
    scale = q.shape[-1] ** -0.5
    mesh = jax_make_mesh(n, 1, devices=jax.devices()[:n])
    want = _jax_grads(lambda *a: jra.ring_tree_attention(a[0], a[1], a[2], jnp.asarray(template), jnp.asarray(ids),
                                                         a[3], mesh, "dp", scale), q, k, v, lut, cot)
    got = _torch_grads(lambda *a: ra.ring_tree_attention_reference(a[0], a[1], a[2], torch.from_numpy(template),
                                                                   torch.from_numpy(ids), a[3], n, scale),
                       q, k, v, lut, cot)
    for name, g, x in zip(("out", "dq", "dk", "dv", "dlut"), got, want):
        np.testing.assert_allclose(g, x, err_msg=name, **TOL)


@pytest.mark.parametrize("s, n", [(16, 4), (13, 2), (13, 4), (9, 4)])
def test_plain_ring_on_padded_s_matches_the_whole_s_reference(s, n):
    """S padded to a multiple of n (``pad_compact``: template rows and
    columns at MASK_BIAS, ids 0), the padded rows sliced off, equals JAX's
    one-device ``tree_attention_reference`` at the whole S, forward and
    gradients. At S = 9 on 4 ranks (S' = 12) the last k/v block is all
    padding: its tiles merge with weight 0."""
    q, k, v, template, ids, lut, cot = _inputs(s + n, s=s)
    scale = q.shape[-1] ** -0.5
    want = _jax_grads(lambda *a: jta.tree_attention_reference(a[0], a[1], a[2], jnp.asarray(template),
                                                              jnp.asarray(ids), a[3], scale, True), q, k, v, lut, cot)

    def ring(qq, kk, vv, ll):
        qp, kp, vp, tpl, idp = ra.pad_compact(qq, kk, vv, torch.from_numpy(template), torch.from_numpy(ids), n)
        return ra.ring_tree_attention_reference(qp, kp, vp, tpl, idp, ll, n, scale)[:, :, :s]

    got = _torch_grads(ring, q, k, v, lut, cot)
    for name, g, x in zip(("out", "dq", "dk", "dv", "dlut"), got, want):
        np.testing.assert_allclose(g, x, err_msg=name, **TOL)


def test_plain_ring_matches_jax_dispatch_on_an_sp_mesh():
    """JAX's ``ring_tree_attention_dispatch`` (it pads S = 9 to 12 itself)
    on a (dp 1, tp 1, sp 4) mesh against the port's padded plain ring."""
    q, k, v, template, ids, lut, _ = _inputs(11, b=1, s=9)
    scale = q.shape[-1] ** -0.5
    mesh = jax_make_mesh(1, 1, 4, devices=jax.devices()[:4])
    with mesh:
        want = jax.jit(lambda *a: jra.ring_tree_attention_dispatch(*a, scale=scale))(
            *(jnp.asarray(x) for x in (q, k, v, template, ids, lut)))
    qp, kp, vp, tpl, idp = ra.pad_compact(*(torch.from_numpy(x) for x in (q, k, v, template, ids)), 4)
    got = ra.ring_tree_attention_reference(qp, kp, vp, tpl, idp, torch.from_numpy(lut), 4, scale)[:, :, :9]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_plain_tile_kernels_match_autograd(rate):
    """``tile_forward_plain`` / ``tile_dq_plain`` / ``tile_dkv_plain`` (the
    three kernels' interfaces: out and lse; dq, dlut and delta from lse and
    out; dk and dv from lse and delta) equal the output and the autograd
    gradients of ``tree_attention_dropout_reference`` with the same mask,
    a fully masked row included (out 0, lse = -1e9 + log 1e-30)."""
    q, k, v, template, ids, lut, cot = (torch.from_numpy(x) for x in _inputs(7, s=11))
    template[1, 3, :] = float("-inf")
    scale = q.shape[-1] ** -0.5
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, lut)]
    want = ta.tree_attention_dropout_reference(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], seed=5,
                                               rate=rate, scale=scale)
    want.backward(cot)
    out, lse = ra.tile_forward_plain(q, k, v, template, ids, lut, scale, True, rate, 5)
    dq, dlut, delta = ra.tile_dq_plain(q, k, v, out, cot, template, ids, lut, lse, scale, True, rate, 5)
    dk, dv = ra.tile_dkv_plain(q, k, v, cot, template, ids, lut, lse, delta, scale, True, rate, 5)
    for name, g, x in zip(("out", "dq", "dk", "dv", "dlut"), (out, dq, dk, dv, dlut),
                          (want, *(t.grad for t in leaves))):
        np.testing.assert_allclose(g.detach().numpy(), x.detach().numpy(), err_msg=name, **TOL)
    assert (out[1, :, 3] == 0).all()
    np.testing.assert_allclose(lse[1, :, 3].numpy(), ta.MASK_BIAS + np.log(np.float32(1e-30)), rtol=1e-7)
    np.testing.assert_allclose(delta.numpy(), (cot * out).sum(-1).numpy(), **TOL)


def test_ring_dropout_statistics():
    """Each tile's mask keeps 1 - rate of its terms, and dropout leaves the
    output unbiased: the mean over many seeds of the ring at rate 0.3 is
    the ring at rate 0."""
    b, h, s, n, rate = 1, 2, 32, 4, 0.3
    c = s // n
    kept = [ta.dropout_keep_mask(ra.tile_seed(11, 0, r, src, n), b, h, c, rate).float().mean().item()
            for r in range(n) for src in range(n)]
    assert abs(np.mean(kept) - (1 - rate)) < 0.02
    q, k, v, template, ids, lut, _ = (torch.from_numpy(x) for x in _inputs(3, b=b, h=h, s=s))
    plain = ra.ring_tree_attention_reference(q, k, v, template, ids, lut, n)
    mean = sum(ra.ring_tree_attention_reference(q, k, v, template, ids, lut, n, seed=sd, rate=rate)
               for sd in range(200)) / 200
    assert (mean - plain).abs().mean() < 0.05 * plain.abs().mean()


def test_ring_dropout_decorrelated_across_strips_blocks_and_dp_shards():
    """As JAX's ``test_ring_dropout_decorrelated_across_dp_shards``: the
    same rows on two data-parallel shards get different in-ring masks (the
    shard is folded into every tile's seed), dropout perturbs the output,
    and without dropout the shards agree. Within one ring, the tiles of
    different (strip, block) pairs draw different masks."""
    q, k, v, template, ids, lut, _ = (torch.from_numpy(x) for x in _inputs(5, b=1, h=2, s=32))
    drop = [ra.ring_tree_attention_reference(q, k, v, template, ids, lut, 4, seed=7, rate=0.4, shard=d)
            for d in (0, 1)]
    plain = [ra.ring_tree_attention_reference(q, k, v, template, ids, lut, 4, shard=d) for d in (0, 1)]
    assert not torch.allclose(drop[0], plain[0])
    assert not torch.allclose(drop[0], drop[1])
    np.testing.assert_allclose(plain[0].numpy(), plain[1].numpy(), **TOL)
    masks = {(r, src): ta.dropout_keep_mask(ra.tile_seed(7, 0, r, src, 4), 1, 2, 8, 0.4) for r in range(4)
             for src in range(4)}
    assert len({m.numpy().tobytes() for m in masks.values()}) == 16
    seeds = {ra.tile_seed(7, d, r, src, 4) for d in range(2) for r in range(4) for src in range(4)}
    assert len(seeds) == 32
