"""The port's compact-bias tree attention against the JAX package's Pallas
kernels (run in interpret mode on the CPU).

The same numpy inputs go through ``ta._tree_forward`` (JAX, which routes to
the batched, per-(b,h) or streaming Pallas kernel by padded size) and the
port's ``tree_attention`` on CPU tensors, which is the plain PyTorch version
the CUDA kernel is held against on the card. Tolerance: rtol/atol 2e-4 in
float32, as the JAX package's own kernel tests use. The wrapper's contract
and the on-card tests are in ``test_torch_tree_attention_card.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.ops import tree_attention as jta
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from test_torch_tree_attention_card import _inputs, _port

torch.set_num_threads(2)


def _jax_kernel(arrays):
    scale = arrays[0].shape[-1] ** -0.5
    out = jta._tree_forward(*(jnp.asarray(a) for a in arrays), scale, True)
    return np.asarray(out)


@pytest.mark.parametrize(
    "regime, b, h, s, dh",
    [
        ("batched", 5, 3, 17, 8),  # s_pad 24 <= 128: _make_kernel_batched
        ("per_bh", 2, 2, 137, 8),  # s_pad 144: _make_kernel
        ("flash", 2, 2, 40, 8),  # forced: _make_kernel_flash, rate 0
    ],
)
def test_plain_version_matches_pallas_kernel(monkeypatch, regime, b, h, s, dh):
    if regime == "flash":
        monkeypatch.setattr(jta, "_FLASH_MIN_S", 16)
        monkeypatch.setattr(jta, "_FLASH_TILE", 16)
    arrays = _inputs(11, b, h, s, dh)
    np.testing.assert_allclose(_port(arrays), _jax_kernel(arrays), rtol=2e-4, atol=2e-4)


def test_out_of_range_ids_add_nothing():
    """ids outside [0, LUT_SIZE) contribute 0, as the Pallas select loop
    does, and are never used as an index."""
    arrays = _inputs(12, 2, 3, 17, 8, id_low=-40, id_high=3 * ta.LUT_SIZE)
    ids = arrays[4]
    assert (ids < 0).any() and (ids >= ta.LUT_SIZE).any()
    clean = list(arrays)
    clean[4] = np.where((ids >= 0) & (ids < ta.LUT_SIZE), ids, 0).astype(np.int32)
    got = _port(arrays)
    np.testing.assert_array_equal(got, _port(clean))
    np.testing.assert_allclose(got, _jax_kernel(arrays), rtol=2e-4, atol=2e-4)


def test_build_compact_bias_inputs_bit_equal():
    rng = np.random.default_rng(14)
    b, n, h = 3, 11, 4
    template = np.where(rng.random((b, n + 1, n + 1)) < 0.2, -np.inf, 0.0).astype(np.float32)
    spatial_pos = rng.integers(0, 23, (b, n, n)).astype(np.int32)
    table = rng.standard_normal((64, h)).astype(np.float32)
    virtual = rng.standard_normal((1, h)).astype(np.float32)
    want = jta.build_compact_bias_inputs(*(jnp.asarray(a) for a in (template, spatial_pos, table, virtual)))
    got = ta.build_compact_bias_inputs(*(torch.from_numpy(a) for a in (template, spatial_pos, table, virtual)))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.dtype == {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32}[w.dtype]
        np.testing.assert_array_equal(g.numpy(), w)
