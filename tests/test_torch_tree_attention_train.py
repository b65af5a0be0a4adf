"""The training path of the port's tree attention against the JAX package,
in float32 on the CPU.

- Rate 0: the port's forward and autograd gradients (dq, dk, dv, dLUT)
  against JAX ``ta._tree_attention`` (its custom VJP: the Pallas forward in
  interpret mode and the XLA backward ``_bwd``, or the streaming Pallas
  backward where S is forced into the flash regime).
- Rate 0.3: the TPU's dropout bits cannot be reproduced, so the JAX side is
  the XLA oracle of ``tests/test_tree_attention_dropout.py`` driven by the
  port's own Philox mask.
- The Philox generator against Random123's published answer, and the mask's
  determinism, seed sensitivity and kept fraction.

Tolerance: 1e-5 (rtol and atol) on the outputs; gradients 2e-5 x their
largest magnitude, since XLA and PyTorch sum the (S, S) products in other
orders. The same at DH 8, 16 and 128 (the plain backward that the float32
route's kernels are held to on the card, against JAX's ``_bwd``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core.config import tiny_model_config as jax_tiny_config
from multimodaldiscussiontransformer_tpu.models import graphormer as jgraph
from multimodaldiscussiontransformer_tpu.ops import tree_attention as jta
from multimodaldiscussiontransformer_tpu_torch.core.config import tiny_model_config
from multimodaldiscussiontransformer_tpu_torch.models import graphormer
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import dropout_rngs
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict
from test_torch_tree_attention_train_card import _inputs, forward_and_grads

torch.set_num_threads(2)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 2e-5


def _port_grads(arrays, g, **kw):
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in arrays)
    got = forward_and_grads(ta.tree_attention, q, k, v, template, ids, lut, torch.from_numpy(g), **kw)
    return [x.numpy() for x in got]


def _jax_grads(fn, arrays, g):
    q, k, v, template, ids, lut = (jnp.asarray(a) for a in arrays)

    def run(q_, k_, v_, l_, g_):  # one jit: the eager vjp compiles op by op
        out, vjp = jax.vjp(lambda *a: fn(*a[:3], template, ids, a[3]), q_, k_, v_, l_)
        return (out, *vjp(g_))

    return [np.asarray(x) for x in jax.jit(run)(q, k, v, lut, jnp.asarray(g))]


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], **OUT_TOL)
    for name, a, w in zip(("dq", "dk", "dv", "dlut"), got[1:], want[1:]):
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(a - w).max() <= GRAD_REL * scale, (name, np.abs(a - w).max(), scale)


@pytest.mark.parametrize(
    "regime, b, h, s, dh",
    [
        ("batched", 3, 2, 17, 8),  # s_pad 24 <= 128
        ("per_bh", 1, 2, 137, 8),  # s_pad 144
        ("flash", 1, 2, 40, 8),  # forced: the streaming forward and backward
        # the head dims of the float32 route's kernels beside DH 64: the
        # workflows' 16 and the largest, 128
        ("batched", 2, 2, 17, 16),
        ("batched", 1, 2, 33, 128),
    ],
)
def test_rate_zero_forward_and_grads_match_jax(monkeypatch, regime, b, h, s, dh):
    monkeypatch.setattr(jta, "FORCE_KERNEL", True)
    if regime == "flash":
        monkeypatch.setattr(jta, "_FLASH_MIN_S", 16)
        monkeypatch.setattr(jta, "_FLASH_TILE", 16)
    arrays = _inputs(21, b, h, s, dh)
    g = np.random.default_rng(22).standard_normal((b, h, s, dh)).astype(np.float32)
    scale = dh**-0.5
    want = _jax_grads(lambda *a: jta._tree_attention(*a, scale, True), arrays, g)
    _assert_close(_port_grads(arrays, g), want)


@pytest.mark.parametrize("b, h, s, dh", [(2, 3, 17, 8), (1, 2, 70, 16)])
def test_dropout_forward_and_grads_match_jax_oracle(b, h, s, dh):
    """The JAX XLA replica of the dropped attention, driven by the port's
    mask, against the port (``f_oracle`` of the JAX dropout tests)."""
    arrays = _inputs(23, b, h, s, dh)
    g = np.random.default_rng(24).standard_normal((b, h, s, dh)).astype(np.float32)
    rate, seed, scale = 0.3, 4242, dh**-0.5
    mask = jnp.asarray(ta.dropout_keep_mask(seed, b, h, s, rate).numpy())

    def f_oracle(q_, k_, v_, template, ids, lut_):
        bias = jta._assemble_bias_xla(template, ids, lut_, True)
        scores = jnp.einsum("bhqd,bhkd->bhqk", q_ * scale, k_) + bias
        p = jax.nn.softmax(scores, axis=-1)
        return jnp.einsum("bhqk,bhkd->bhqd", jnp.where(mask, p, 0.0) / (1 - rate), v_)

    _assert_close(_port_grads(arrays, g, rate=rate, seed=seed), _jax_grads(f_oracle, arrays, g))


def test_philox_known_answer_vectors():
    """Random123's kat_vectors for philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, 0xFFFFFFFFFFFFFFFF, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0x299F31D0 << 32) | 0xA4093822,
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        words = ta.philox4x32(*(torch.tensor([c]) for c in ctr), key)
        assert tuple(int(w) for w in words) == want


def test_mask_is_deterministic_seed_sensitive_and_keeps_one_minus_rate():
    a = ta.dropout_keep_mask(7, 4, 12, 33, 0.3)
    assert torch.equal(a, ta.dropout_keep_mask(7, 4, 12, 33, 0.3))
    assert not torch.equal(a, ta.dropout_keep_mask(8, 4, 12, 33, 0.3))
    # 52,272 draws: the kept fraction is 0.7 within 5 standard errors
    assert abs(a.float().mean().item() - 0.7) < 5 * (0.21 / a.numel()) ** 0.5
    # a pure function of (seed, b, h, i, j): a sub-shape is a sub-block
    assert torch.equal(ta.dropout_keep_mask(7, 2, 5, 9, 0.3), a[:2, :5, :9, :9])
    assert ta.dropout_keep_mask(7, 1, 1, 9, 0.0).all()


def test_dropout_output_is_unbiased():
    """E[dropped attention] = the deterministic attention (600 seeds)."""
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in _inputs(25, 1, 2, 12, 8))
    det = ta.tree_attention(q, k, v, template, ids, lut)
    mean = sum(ta.tree_attention(q, k, v, template, ids, lut, rate=0.5, seed=s) for s in range(600)) / 600
    assert (mean - det).abs().max() < 0.12 * det.abs().max()


def test_compact_attention_layer_with_dropout_matches_jax_oracle():
    """BiasedMultiheadAttention with ``deterministic=False`` on the compact
    path: the seed drawn from the host generator keys the mask, and the
    layer equals the JAX layer's math with that mask."""
    jcfg = jax_tiny_config(attention_dropout=0.3)
    rng = np.random.default_rng(26)
    b, s, d, h = 2, 9, 64, jcfg.encoder_attention_heads
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    template = np.zeros((b, s, s), np.float32)
    ids = rng.integers(0, 22, (b, s, s)).astype(np.int32)
    lut = rng.standard_normal((ta.LUT_SIZE, h)).astype(np.float32)
    lut[0] = 0.0
    mod = jgraph.BiasedMultiheadAttention(jcfg)
    jbias = tuple(jnp.asarray(a) for a in (template, ids, lut))
    # jitted: eagerly each op of the init compiles on its own
    params = jax.device_get(jax.jit(lambda r: mod.init(r, jnp.asarray(x), jbias, None))(jax.random.PRNGKey(0)))

    port = graphormer.BiasedMultiheadAttention(tiny_model_config(attention_dropout=0.3), torch.float32)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    host = torch.Generator().manual_seed(5)
    seed = int(torch.randint(0, 2**63 - 1, (), generator=torch.Generator().manual_seed(5)))
    with dropout_rngs(host, torch.Generator().manual_seed(0)), torch.no_grad():
        got = port(torch.from_numpy(x), tuple(torch.from_numpy(a) for a in (template, ids, lut)), None, False).numpy()

    mask = jnp.asarray(ta.dropout_keep_mask(seed, b, h, s, 0.3).numpy())
    p = params["params"]
    dh = d // h

    def proj(name, y):
        return y @ p[name]["kernel"] + p[name]["bias"]

    def heads(y):
        return y.reshape(b, s, h, dh).transpose(0, 2, 1, 3)

    q, k, v = (heads(proj(n, jnp.asarray(x))) for n in ("q_proj", "k_proj", "v_proj"))
    bias = jta._assemble_bias_xla(*jbias, True)
    probs = jax.nn.softmax(jnp.einsum("bhqd,bhkd->bhqk", q * dh**-0.5, k) + bias, axis=-1)
    ctx = jnp.einsum("bhqk,bhkd->bhqd", jnp.where(mask, probs, 0.0) / 0.7, v)
    want = proj("out_proj", ctx.transpose(0, 2, 1, 3).reshape(b, s, d))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
