"""The training path of the tree attention: the wrapper's contract, and the
CUDA forward (dropout, LSE) and backward kernels against the plain version
on the card.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_tree_attention_train_card.py

Without a card the tests marked ``gpu`` skip. The comparisons with the JAX
package are in ``test_torch_tree_attention_train.py``.

Tolerances on the card: float32 with TF32 off, 1e-4 x max|ref| (the kernels
and the plain version sum in other orders, and dlut is summed with atomics
in an order that changes from run to run); bfloat16, 1e-2 x max|ref| (the
kernels round out and g to bf16 before forming g . out, and every output is
rounded to bf16: a few bf16 steps of 2^-8).
"""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

torch.set_num_threads(2)

F32_RTOL_OF_MAX = 1e-4
BF16_RTOL_OF_MAX = 1e-2


def _inputs(seed, b, h, s, dh):
    """numpy (q, k, v, template, ids, lut) with ~15% of the template masked
    (never column 0, as the collator never does)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    template = np.where(rng.random((b, s, s)) < 0.15, ta.MASK_BIAS, 0.0).astype(np.float32)
    template[:, :, 0] = 0.0
    ids = rng.integers(0, ta.LUT_SIZE, (b, s, s)).astype(np.int32)
    lut = rng.standard_normal((ta.LUT_SIZE, h)).astype(np.float32)
    lut[0] = 0.0
    return q, k, v, template, ids, lut


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def forward_and_grads(fn, q, k, v, template, ids, lut, g, **kw):
    """fn's output and its gradients (dq, dk, dv, dlut) for the cotangent g."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v, lut)]
    out = fn(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], **kw)
    out.backward(g)
    return [out.detach()] + [x.grad for x in leaves]


def max_err_of_max(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def test_keep_mask_known_answer():
    """Random123's published vector: counter 0, key 0."""
    z = torch.zeros(1, dtype=torch.int64)
    words = [int(w) for w in ta.philox4x32(z, z, z, z, 0)]
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


@pytest.mark.parametrize("rate, seed, fault", [(1.0, 3, "rate"), (-0.1, 3, "rate"), (0.3, None, "seed"), (0.3, 2**64, "seed")])
def test_rate_and_seed_checks(rate, seed, fault):
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 9, 16))
    with pytest.raises(ValueError, match=fault):
        ta.tree_attention(q, k, v, template, ids, lut, rate=rate, seed=seed)


@pytest.mark.parametrize("name", ["g", "out", "lse", "delta"])
def test_backward_inputs_checked(name):
    """What the backward kernels refuse, checked on CPU tensors."""
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in _inputs(2, 1, 2, 9, 16))
    bad = {"g": q.double(), "out": q[..., :8].contiguous(), "lse": torch.zeros(1, 2, 8), "delta": torch.zeros(1, 9, 2).transpose(1, 2)}
    with pytest.raises((TypeError, ValueError)):
        ta._check_cuda_inputs(q, k, v, template, ids, lut, **{name: bad[name]})


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("s, b", [(33, 4), (129, 2), (257, 1), (601, 1)])  # 601: the streaming sizes
def test_kernels_match_plain_on_card(dtype, rate, s, b, dh):
    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v, template, ids, lut = (torch.from_numpy(a).to(dev) for a in _inputs(s, b, 768 // dh, s, dh))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(s), device=dev).to(dt)
    before = [fn.launches for fn in ta.KERNELS]
    got = forward_and_grads(ta.tree_attention, q, k, v, template, ids, lut, g, rate=rate, seed=1234)
    # (tensor-core fwd, dq, dkv; 3xTF32 dq, dkv; 3xTF32 fwd): bf16 takes
    # the tensor-core kernels both ways at every DH, float32 the 3xTF32
    # forward and pair
    fwd = [1, 1, 1, 0, 0, 0] if ta.kernel_route(dt, dh) == "tensor_core" else [0, 0, 0, 1, 1, 1]
    assert [fn.launches for fn in ta.KERNELS] == [n + d for n, d in zip(before, fwd)]
    want = forward_and_grads(ta.tree_attention_dropout_reference, q, k, v, template, ids, lut, g, rate=rate, seed=1234)
    tol = F32_RTOL_OF_MAX if dtype == "float32" else BF16_RTOL_OF_MAX
    for name, a, w in zip(("out", "dq", "dk", "dv", "dlut"), got, want):
        assert a.dtype == w.dtype, name
        assert torch.isfinite(a).all(), name
        assert max_err_of_max(a, w) <= tol, (name, max_err_of_max(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [33, 64])
def test_kernel_mask_is_the_plain_philox(s):
    """With q = k = 0, no bias and v = the identity, out = keep / (S (1 -
    rate)): the kernel's mask, read back, equals the plain Philox bit for
    bit."""
    dev = _card()
    b, h, dh, rate = 2, 3, 64, 0.3
    zeros = torch.zeros(b, h, s, dh, device=dev)
    eye = torch.eye(s, dh, device=dev).expand(b, h, s, dh).contiguous()
    template = torch.zeros(b, s, s, device=dev)
    ids = torch.zeros(b, s, s, dtype=torch.int32, device=dev)
    lut = torch.zeros(ta.LUT_SIZE, h, device=dev)
    out = ta.tree_attention(zeros, zeros, eye, template, ids, lut, rate=rate, seed=99)
    mask = (out[..., :s] * s * (1 - rate)).round() > 0.5
    assert torch.equal(mask, ta.dropout_keep_mask(99, b, h, s, rate, dev))
    assert abs(mask.float().mean().item() - (1 - rate)) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("s, b", [(33, 4), (257, 1), (601, 1)])
def test_adjoint_identity_in_v(s, b):
    """<g, f(v2)> = <vjp_v(g), v2> holds only if the backward regenerates
    the forward's mask (float32, relative 1e-4)."""
    dev = _card()
    q, k, v, template, ids, lut = (torch.from_numpy(a).to(dev) for a in _inputs(s + 1, b, 12, s, 64))
    gen = torch.Generator(device=dev).manual_seed(5)
    g, v2 = (torch.randn(q.shape, generator=gen, device=dev) for _ in range(2))
    vv = v.clone().requires_grad_(True)
    ta.tree_attention(q, k, vv, template, ids, lut, rate=0.3, seed=77).backward(g)
    lhs = (g.double() * ta.tree_attention(q, k, v2, template, ids, lut, rate=0.3, seed=77).double()).sum().item()
    rhs = (vv.grad.double() * v2.double()).sum().item()
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])  # both forward routes
def test_cuda_path_never_calls_the_plain_version(monkeypatch, dtype, dh):
    dev = _card()

    def no_plain(*a, **kw):
        raise AssertionError("the CUDA path must not call the plain version")

    for name in ("tree_attention_dropout_reference", "tree_attention_reference", "dropout_keep_mask", "philox4x32"):
        monkeypatch.setattr(ta, name, no_plain)
    q, k, v, template, ids, lut = (torch.from_numpy(a).to(dev) for a in _inputs(7, 2, 768 // dh, 33, dh))
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    got = forward_and_grads(ta.tree_attention, q, k, v, template, ids, lut, torch.ones_like(q), rate=0.3, seed=5)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x.float()).all() for x in got)
