"""The dense-bias attention (``ops/biased_attention.py``): the wrapper's
contract and its backward on the CPU, and the routed CUDA forward kernel
with the Function's gradients against the plain version on the card.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_biased_attention_card.py

Without a card the tests marked ``gpu`` skip. The comparisons with the JAX
package are in ``test_torch_biased_attention.py``.

Tolerances: on the CPU, the Function's backward against autograd of the
plain version within 1e-5 x max|ref| (float32, sums in other orders). On
the card, the forward in float32 (TF32 off, the 3xTF32 kernel) within
1e-4 absolute (sums over dh and S in other orders, ~1e-6 here); in bfloat16
the routed tensor-core kernel within 1e-2 x max|ref| (it rounds P to bf16
before P V, about one more bf16 step) and the CUDA-core kernel, called
directly on the same inputs, within one bf16 step of the value (2^-7
relative, atol 1e-5: both compute in f32 from the same bf16 inputs and round
once); gradients within 1e-4 x max|ref| in float32 and 1e-2 x max|ref| in
bfloat16 (both round every gradient to bf16).
"""

import importlib

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

ba = importlib.import_module("multimodaldiscussiontransformer_tpu_torch.ops.biased_attention")

torch.set_num_threads(2)

F32_ATOL = 1e-4
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
BF16_RTOL_OF_MAX = 1e-2
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
CPU_GRAD_REL = 1e-5
BIAS_KINDS = ("head", "shared", "none")
# the shapes of the path on the card: the canonical node buckets at the
# batch sizes a scoring (16) and a training (12) batch give, and single big
# discussions past the JAX kernel's 8-padded whole-S blocks
CARD_SHAPES = ((33, 16), (33, 12), (129, 12), (257, 4), (601, 1), (1025, 1))


def make_inputs(seed, b, h, s, dh, kind="head", pad=True):
    """numpy (q, k, v, bias or None, pad mask or None). The bias is N(0, 1)
    with ~15% of its entries -inf (never key 0, as the collator's template
    never masks column 0); about 20% of the keys past key 0 are padded."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    bias = None
    if kind != "none":
        bias = rng.standard_normal((b, h if kind == "head" else 1, s, s)).astype(np.float32)
        bias[rng.random(bias.shape) < 0.15] = -np.inf
        bias[..., 0] = rng.standard_normal(bias.shape[:-1])
    mask = None
    if pad:
        mask = rng.random((b, s)) < 0.2
        mask[:, 0] = False
    return q, k, v, bias, mask


def to_torch(arrays, device="cpu", dtype=torch.float32, bias_dtype=None):
    q, k, v, bias, mask = (None if a is None else torch.from_numpy(a).to(device) for a in arrays)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    if bias is not None:
        bias = bias.to(bias_dtype or dtype)
    return q, k, v, bias, mask


def forward_and_grads(fn, q, k, v, bias, mask, g):
    """fn's output and its gradients (dq, dk, dv, dbias or None) for the
    cotangent g."""
    leaves = [None if x is None else x.detach().clone().requires_grad_(True) for x in (q, k, v, bias)]
    out = fn(*leaves, mask)
    out.backward(g)
    return [out.detach()] + [None if x is None else x.grad for x in leaves]


def max_err_of_max(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def test_cpu_path_never_builds_or_counts(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    before = [fn.launches for fn in ba.KERNELS]
    q, k, v, bias, mask = to_torch(make_inputs(1, 2, 2, 9, 8))
    forward_and_grads(ba.biased_attention, q, k, v, bias, mask, torch.ones_like(q))
    assert [fn.launches for fn in ba.KERNELS] == before


def test_other_devices_raise():
    q = torch.empty(1, 2, 9, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ba.biased_attention(q, q, q)


@pytest.mark.parametrize("fault", ["dtype", "head_dim", "bias_shape", "bias_dtype", "mask_shape", "mask_dtype",
                                   "layout"])
def test_kernel_input_checks(fault):
    """What the CUDA path refuses, checked on CPU tensors."""
    q, k, v, bias, mask = to_torch(make_inputs(3, 2, 2, 9, 64))
    expected = ValueError
    if fault == "dtype":
        q, k, v = q.half(), k.half(), v.half()
        expected = TypeError
    elif fault == "head_dim":
        q, k, v = (x[..., :48].contiguous() for x in (q, k, v))
    elif fault == "bias_shape":
        bias = bias[:, :, :8].contiguous()
    elif fault == "bias_dtype":
        bias = bias.half()
        expected = TypeError
    elif fault == "mask_shape":
        mask = mask[:, :8].contiguous()
    elif fault == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif fault == "layout":
        bias = bias.transpose(2, 3)
    with pytest.raises(expected):
        ba._check_cuda_inputs(q, k, v, bias, mask)
    for kind in BIAS_KINDS:  # what it takes
        ba._check_cuda_inputs(*to_torch(make_inputs(3, 2, 2, 9, 64, kind)))
    ba._check_cuda_inputs(*to_torch(make_inputs(3, 2, 2, 9, 64), bias_dtype=torch.bfloat16))


@pytest.mark.parametrize("kind", BIAS_KINDS)
def test_function_backward_is_autograd_of_the_plain_version(kind):
    """The Function's backward (JAX's rematerialized ``_bwd``, which the
    card runs too) equals autograd of the plain version: dbias of the
    bias's shape (summed over heads when shared), none without a bias."""
    q, k, v, bias, mask = to_torch(make_inputs(5, 2, 3, 17, 8, kind))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    got = forward_and_grads(ba.biased_attention, q, k, v, bias, mask, g)
    want = forward_and_grads(ba.biased_attention_reference, q, k, v, bias, mask, g)
    assert torch.equal(got[0], want[0])  # the CPU forward is the plain version
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got[1:], want[1:]):
        if w is None:
            assert a is None and kind == "none"
            continue
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert max_err_of_max(a, w) <= CPU_GRAD_REL, (name, max_err_of_max(a, w))


def test_function_keeps_nothing_without_a_gradient():
    """Without an input that wants a gradient the Function records no node
    (a scoring forward saves nothing); a bias that wants one is enough."""
    q, k, v, bias, mask = to_torch(make_inputs(6, 2, 2, 9, 8))
    assert ba.biased_attention(q, k, v, bias, mask).grad_fn is None
    assert ba.biased_attention(q, k, v, bias.requires_grad_(True), mask).grad_fn is not None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", BIAS_KINDS)
@pytest.mark.parametrize("s, b", CARD_SHAPES)
def test_kernel_and_gradients_match_plain_on_card(dtype, kind, s, b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v, bias, mask = to_torch(make_inputs(s + b, b, 12, s, 64, kind), "cuda", dt)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(s), device="cuda").to(dt)
    before = [fn.launches for fn in ba.KERNELS]
    got = forward_and_grads(ba.biased_attention, q, k, v, bias, mask, g)
    routed = ba.FORWARDS[ba.kernel_route(dt, 64)]
    assert [fn.launches for fn in ba.KERNELS] == [n + (fn is routed) for n, fn in zip(before, ba.KERNELS)]
    want = forward_and_grads(ba.biased_attention_reference, q, k, v, bias, mask, g)
    torch.cuda.synchronize()
    err = (got[0].float() - want[0].float()).abs()
    assert got[0].dtype == dt and torch.isfinite(got[0]).all()
    if dt == torch.float32:
        assert err.max().item() <= F32_ATOL, err.max().item()
    else:
        assert max_err_of_max(got[0], want[0]) <= BF16_RTOL_OF_MAX, max_err_of_max(got[0], want[0])
        cuda_core = ba.biased_attention_fwd(q, k, v, bias, mask, 64 ** -0.5)
        err = (cuda_core.float() - want[0].float()).abs()
        assert (err <= BF16_ATOL + BF16_RTOL * want[0].float().abs()).all(), err.max().item()
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got[1:], want[1:]):
        if w is None:
            assert a is None
            continue
        assert a.dtype == w.dtype and torch.isfinite(a).all(), name
        assert max_err_of_max(a, w) <= GRAD_REL[dt], (name, max_err_of_max(a, w))


@pytest.mark.gpu
def test_f32_inputs_with_a_bf16_bias_on_card():
    """The bias is read in its own type, whatever q's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, bias, mask = to_torch(make_inputs(9, 4, 12, 129, 64, "shared"), "cuda", bias_dtype=torch.bfloat16)
    got = ba.biased_attention(q, k, v, bias, mask)
    want = ba.biased_attention_reference(q, k, v, bias, mask)
    assert (got - want).abs().max().item() <= F32_ATOL


@pytest.mark.gpu
def test_cuda_path_never_calls_the_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def no_plain(*a, **kw):
        raise AssertionError("the CUDA path must not call the plain version")

    for name in ("biased_attention_reference", "dropped_softmax_attention"):
        monkeypatch.setattr(ba, name, no_plain)
    monkeypatch.setattr(ta, "dropped_softmax_attention", no_plain)
    q, k, v, bias, mask = to_torch(make_inputs(7, 4, 12, 33, 64), "cuda")
    got = forward_and_grads(ba.biased_attention, q, k, v, bias, mask, torch.ones_like(q))
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in got)
