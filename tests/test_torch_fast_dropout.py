"""The port's mask-regenerating dropout (``models/fast_dropout.py``): the
four properties ``tests/test_fast_dropout.py`` pins for the JAX version,
and that the backward keeps no activation-sized mask."""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import (
    FastDropout,
    draw_seed,
    dropout_rngs,
    fast_dropout,
)

torch.set_num_threads(2)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_deterministic_given_generator_state_and_inverted_scaling():
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 32).astype(np.float32))
    a = fast_dropout(x, 0.5, gen(7))
    assert torch.equal(a, fast_dropout(x, 0.5, gen(7)))
    assert not torch.equal(a, fast_dropout(x, 0.5, gen(8)))
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] / 0.5, rtol=1e-6, atol=0)


def test_backward_regenerates_the_same_mask():
    """The gradient is g / (1 - rate) exactly on the forward's kept entries
    and 0 elsewhere, and the graph saves no activation-sized tensor."""
    x = torch.from_numpy(np.random.RandomState(1).randn(64, 128).astype(np.float32)).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t, lambda t: t):
        out = fast_dropout(x, 0.3, gen(3))
    assert all(n < x.numel() for n in saved), saved
    out.backward(torch.ones_like(out))
    kept = out.detach() != 0
    torch.testing.assert_close(x.grad[kept], torch.full_like(x.grad[kept], 1 / 0.7), rtol=1e-6, atol=0)
    assert (x.grad[~kept] == 0).all()


def test_unbiased_mean():
    x = torch.ones(32, 64)
    g = gen(0)
    vals = [fast_dropout(x, 0.4, g).mean().item() for _ in range(200)]
    assert abs(np.mean(vals) - 1.0) < 0.02


def test_module_contract():
    """deterministic=True and rate 0 are the identity; a training forward
    needs the generators; the same generator states give the same output;
    rate 1 drops everything."""
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 8).astype(np.float32))
    mod = FastDropout(0.5)
    assert mod(x, deterministic=True) is x
    assert FastDropout(0.0)(x, deterministic=False) is x
    with pytest.raises(RuntimeError, match="dropout_rngs"):
        mod(x, deterministic=False)
    with dropout_rngs(gen(1), gen(0)):
        y1 = mod(x, deterministic=False)
        s1 = draw_seed()
    with dropout_rngs(gen(1), gen(0)):
        y2 = mod(x, deterministic=False)
        s2 = draw_seed()
        assert (FastDropout(1.0)(x, deterministic=False) == 0).all()
    assert torch.equal(y1, y2) and s1 == s2 and 0 <= s1 < 2**63
