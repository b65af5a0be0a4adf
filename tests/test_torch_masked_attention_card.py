"""The tower attention (``ops/masked_attention.py``): the wrapper's contract,
and the CUDA forward and backward kernels against the plain version on the
card.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_masked_attention_card.py

Without a card the tests marked ``gpu`` skip. The comparisons with the JAX
package are in ``test_torch_masked_attention.py``.

Tolerances on the card, as for the tree-attention kernels: float32 with
TF32 off, 1e-4 x max|ref| (sums in other orders); bfloat16, 1e-2 x max|ref|
(the kernels round out and g to bf16 before forming g . out, the
tensor-core forward rounds p to bf16 before P V, the one-pass backward
rounds p and ds to bf16 before its second products, and every output is
rounded to bf16).
"""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

torch.set_num_threads(2)

F32_RTOL_OF_MAX = 1e-4
BF16_RTOL_OF_MAX = 1e-2


def _inputs(seed, b, h, s, dh, masked=True):
    """numpy (q, k, v, key bias or None): about 30% of the keys of each row
    padded with MASK_BIAS, key 0 never."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    bias = None
    if masked:
        bias = np.where(rng.random((b, s)) < 0.3, ta.MASK_BIAS, 0.0).astype(np.float32)
        bias[:, 0] = 0.0
    return q, k, v, bias


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def forward_and_grads(fn, q, k, v, bias, g, **kw):
    """fn's output and its gradients (dq, dk, dv) for the cotangent g."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves, bias, **kw)
    out.backward(g)
    return [out.detach()] + [x.grad for x in leaves]


def read_back_mask(fn, b, h, s, rate, seed, device, dh=16, dtype=torch.float32):
    """The keep mask ``fn`` applies, read back: with q = k = 0 and no bias
    every row weighs its keys equally, so with v holding one-hot columns for
    keys c*dh .. c*dh+dh-1, out = keep / (S (1 - rate)) there (within a
    bf16 step in bf16, far from the 0.5 the rounding cuts at)."""
    zeros = torch.zeros(b, h, s, dh, device=device, dtype=dtype)
    chunks = []
    for c in range(-(-s // dh)):
        v = torch.zeros(s + dh, dh, device=device)
        v[c * dh : (c + 1) * dh] = torch.eye(dh, device=device)
        out = fn(zeros, zeros, v[:s].to(dtype).expand(b, h, s, dh).contiguous(), None, seed=seed, rate=rate)
        chunks.append((out.float() * s * (1 - rate)).round() > 0.5)
    return torch.cat(chunks, dim=-1)[..., :s]


def max_err_of_max(got, want, floor=1e-30):
    """max |got - want| over max(max |want|, floor)."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(floor)).item()


# launches of ma.KERNELS (one-pass bwd, tensor-core fwd, 3xTF32 fwd, dq,
# dkv, tiled fwd, dq, dkv) for one forward and backward, by route
ROUTE_LAUNCHES = {"tensor_core": [1, 1, 0, 0, 0, 0, 0, 0], "tf32": [0, 0, 1, 1, 1, 0, 0, 0],
                  "tensor_core_tiled": [0, 0, 0, 0, 0, 1, 1, 1]}
# the forward and backward stand-ins each route calls
ROUTE_FORWARD = {"tensor_core": "fwd_fused", "tensor_core_tiled": "fwd_tiled", "tf32": "fwd_tf32"}
ROUTE_BACKWARD = {"tensor_core": ["fused"], "tensor_core_tiled": ["dq_tiled", "dkv_tiled"],
                  "tf32": ["dq_tf32", "dkv_tf32"]}


def expected_launches(dtype, s, dh=64):
    """Launches of ma.KERNELS for one forward and backward, by the route."""
    return ROUTE_LAUNCHES[ma.kernel_route(dtype, dh, s)]


def plain_stats(q, k, bias, scale):
    """(row max clamped at -1e9, log of the clamped undropped row sum), f32
    (2, B, H, S), as the kernels store them."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float().clamp_min(ta.MASK_BIAS)[:, None, None, :]
    m = s.amax(-1).clamp_min(ta.MASK_BIAS)
    return torch.stack([m, torch.exp(s - m[..., None]).sum(-1).clamp_min(1e-30).log()])


def test_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the build raise; nothing falls back."""
    monkeypatch.setenv("NVCC", "/bin/false")
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_lib.build()


def test_build_tables_cover_every_source_and_header():
    """Every kernel source is built, bound and named in ``cuda_lib``'s
    tables, and every header a source includes is in ``HEADERS``, which the
    libraries' build hash reads."""
    import re

    assert set(cuda_lib.SOURCES) == set(cuda_lib.ENTRY_POINTS) == set(cuda_lib.ERROR_STRINGS)
    assert sorted(cuda_lib.SOURCES.values()) == sorted(cuda_lib.CSRC.glob("*.cu"))
    included = {name for src in cuda_lib.CSRC.glob("*.cu*")
                for name in re.findall(r'#include "([^"]+)"', src.read_text())}
    assert included == {p.name for p in cuda_lib.HEADERS} == {p.name for p in cuda_lib.CSRC.glob("*.cuh")}
    assert "masked_attention_fwd_mma" in cuda_lib.ENTRY_POINTS["masked_fwd_mma"]


def test_cpu_path_never_builds_or_counts(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    before = [fn.launches for fn in ma.KERNELS]
    q, k, v, bias = (torch.from_numpy(x).requires_grad_(x.ndim == 4) for x in _inputs(1, 2, 2, 9, 8))
    ma.masked_attention(q, k, v, bias, seed=3, rate=0.2).sum().backward()
    assert [fn.launches for fn in ma.KERNELS] == before


def test_other_devices_raise():
    q = torch.empty(1, 2, 9, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ma.masked_attention(q, q, q)


@pytest.mark.parametrize("rate, seed, fault", [(1.0, 3, "rate"), (0.3, None, "seed")])
def test_rate_and_seed_checks(rate, seed, fault):
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(2, 1, 2, 9, 16))
    with pytest.raises(ValueError, match=fault):
        ma.masked_attention(q, k, v, bias, rate=rate, seed=seed)


@pytest.mark.parametrize("fault", ["dtype", "head_dim", "bias_shape", "bias_dtype", "layout", "stats"])
def test_kernel_input_checks(fault):
    """What the CUDA path refuses, checked on CPU tensors."""
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(3, 2, 2, 9, 64))
    extra, expected = {}, ValueError
    if fault == "dtype":
        q, k, v = q.half(), k.half(), v.half()
        expected = TypeError
    elif fault == "head_dim":
        q, k, v = (x[..., :48].contiguous() for x in (q, k, v))
    elif fault == "bias_shape":
        bias = bias[:, :8].contiguous()
    elif fault == "bias_dtype":
        bias = bias.double()
    elif fault == "layout":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "stats":
        extra["stats"] = torch.zeros(2, 2, 9)  # (B, H, S): the row sums' plane is missing
    with pytest.raises(expected):
        ma._check_cuda_inputs(q, k, v, bias, **extra)
    ma._check_cuda_inputs(*(torch.from_numpy(x) for x in _inputs(3, 2, 2, 9, 64)))


ROUTE_CASES = [
    (torch.bfloat16, 64, 100, "tensor_core"),  # text bottom
    (torch.bfloat16, 64, 104, "tensor_core"),  # text fusion
    (torch.bfloat16, 64, 201, "tensor_core"),  # ViT fusion
    (torch.bfloat16, 64, 1, "tensor_core"),
    (torch.bfloat16, 64, 256, "tensor_core"),
    (torch.bfloat16, 64, 257, "tensor_core_tiled"),  # longer S
    (torch.bfloat16, 32, 104, "tensor_core_tiled"),  # other DH
    (torch.bfloat16, 128, 104, "tensor_core_tiled"),
    (torch.float32, 64, 104, "tf32"),  # f32: the card-vs-CPU steps' tolerances
]


@pytest.mark.parametrize("dtype, dh, s, route", ROUTE_CASES)
def test_backward_route(dtype, dh, s, route):
    """One predicate routes both directions: the forward that writes the
    statistics and the backward that reads them."""
    assert ma.kernel_route(dtype, dh, s) == route


def _stub_kernels(monkeypatch, calls, asked=None):
    """Stand-ins on CPU tensors for every kernel wrapper of ``ma``: each
    records its name in ``calls``; the forwards return the plain version's
    output and (when asked, recorded in ``asked``) zero statistics."""

    def fwd(name):
        def run(q, k, v, key_bias, scale, rate, seed, with_stats):
            calls.append(name)
            if asked is not None:
                asked.append(with_stats)
            out = ma.masked_attention_dropout_reference(q, k, v, key_bias, seed, rate, scale)
            return out, torch.zeros((2,) + q.shape[:3]) if with_stats else None
        return run

    def fake_fused(q, k, v, out, g, key_bias, stats, scale, rate, seed):
        calls.append("fused")
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def fake_dq(name):
        def run(q, k, v, out, g, key_bias, stats, scale, rate, seed):
            calls.append(name)
            return torch.zeros_like(q), torch.zeros(q.shape[:3])
        return run

    def fake_dkv(name):
        def run(q, k, v, g, key_bias, stats, delta, scale, rate, seed):
            calls.append(name)
            return torch.zeros_like(k), torch.zeros_like(v)
        return run

    for name, fn in (("masked_attention_fwd_tiled", fwd("fwd_tiled")), ("masked_attention_fwd_fused", fwd("fwd_fused")),
                     ("masked_attention_fwd_tf32", fwd("fwd_tf32")),
                     ("masked_attention_bwd_fused", fake_fused), ("masked_attention_bwd_dq_tiled", fake_dq("dq_tiled")),
                     ("masked_attention_bwd_dkv_tiled", fake_dkv("dkv_tiled")),
                     ("masked_attention_bwd_dq_tf32", fake_dq("dq_tf32")),
                     ("masked_attention_bwd_dkv_tf32", fake_dkv("dkv_tf32"))):
        monkeypatch.setattr(ma, name, fn)


@pytest.mark.parametrize("with_grad", [False, True])
@pytest.mark.parametrize("dtype, dh, s, route", ROUTE_CASES)
def test_forward_launches_the_routed_kernel(monkeypatch, dtype, dh, s, route, with_grad):
    """``MaskedAttention.forward`` calls the forward kernel ``kernel_route``
    names, asking for the statistics only when an input wants a gradient.
    The kernels are stood in for on CPU tensors."""
    calls, asked = [], []
    _stub_kernels(monkeypatch, calls, asked)
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(11, 1, 2, s, dh))
    q, k, v = (x.to(dtype).requires_grad_(with_grad) for x in (q, k, v))
    ma.MaskedAttention.apply(q, k, v, bias, 3, 0.2, dh ** -0.5)
    assert calls == [ROUTE_FORWARD[route]]
    assert asked == [with_grad]


def test_every_tower_shape_routes_to_tensor_cores():
    """``ModelConfig()`` in bf16: the text tower at its collated length
    (bottom) and with the bottleneck tokens (fusion), the ViT over its
    patches and CLS token and with the bottleneck tokens, all take the
    tensor-core kernels."""
    from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig, ModelConfig

    mc = ModelConfig()
    dtype = getattr(torch, mc.dtype)
    assert dtype == torch.bfloat16
    text, vit = DataConfig().max_text_len, mc.image_tower.seq_len
    shapes = {"text_bottom": (mc.text_tower.head_dim, text), "text_fusion": (mc.text_tower.head_dim, text + mc.num_bottleneck_tokens),
              "vit_bottom": (mc.image_tower.head_dim, vit), "vit_fusion": (mc.image_tower.head_dim, vit + mc.num_bottleneck_tokens)}
    assert {name: (dh, s) for name, (dh, s) in shapes.items()} == {
        "text_bottom": (64, 100), "text_fusion": (64, 104), "vit_bottom": (64, 197), "vit_fusion": (64, 201)}
    assert {name: ma.kernel_route(dtype, dh, s) for name, (dh, s) in shapes.items()} == dict.fromkeys(shapes, "tensor_core")


@pytest.mark.parametrize("dtype, dh, s", [(torch.bfloat16, 64, 104), (torch.float32, 64, 104), (torch.bfloat16, 32, 40)])
def test_backward_launches_the_routed_kernels(monkeypatch, dtype, dh, s):
    """``MaskedAttention`` calls the tensor-core forward and the one-pass
    backward, the 3xTF32 forward and pair, or the tiled tensor-core
    forward and pair, as ``kernel_route`` says, the backward with the
    forward's saved tensors.
    The kernels are stood in for on CPU tensors."""
    calls = []
    _stub_kernels(monkeypatch, calls)
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(6, 2, 2, s, dh))
    q, k, v = (x.to(dtype).requires_grad_(True) for x in (q, k, v))
    ma.MaskedAttention.apply(q, k, v, bias, 3, 0.2, dh ** -0.5).float().sum().backward()
    route = ma.kernel_route(dtype, dh, s)
    assert calls == [ROUTE_FORWARD[route]] + ROUTE_BACKWARD[route]
    assert q.grad.dtype == dtype and k.grad.shape == k.shape


@pytest.mark.parametrize("fault", ["float32", "head_dim", "long_s", "stats", "bias_shape", "cpu"])
def test_fused_backward_input_checks(monkeypatch, fault):
    """What ``masked_attention_bwd_fused`` refuses: anything but bf16 at DH
    64 and S <= 256, malformed stats or bias, and tensors off the card. It
    raises before any build."""

    def no_build():
        raise AssertionError("an input check must raise before the build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    b, h, s, dh = 2, 2, 9, 64
    if fault == "head_dim":
        dh = 32
    elif fault == "long_s":
        s = 257
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(8, b, h, s, dh))
    dt = torch.float32 if fault == "float32" else torch.bfloat16
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    stats = torch.zeros(2, b, h, s)
    if fault == "stats":
        stats = torch.zeros(b, h, s)
    elif fault == "bias_shape":
        bias = bias[:, :-1].contiguous()
    with pytest.raises(ValueError):
        ma.masked_attention_bwd_fused(q, k, v, q, q, bias, stats, dh ** -0.5, 0.3, 1)


@pytest.mark.parametrize("fault", ["float32", "head_dim", "long_s", "bias_shape", "k_shape", "cpu"])
def test_fused_forward_input_checks(monkeypatch, fault):
    """What ``masked_attention_fwd_fused`` refuses: anything but bf16 at DH
    64 and S <= 256, a malformed bias or k, and tensors off the card. It
    raises before any build."""

    def no_build():
        raise AssertionError("an input check must raise before the build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    b, h, s, dh = 2, 2, 9, 64
    if fault == "head_dim":
        dh = 32
    elif fault == "long_s":
        s = 257
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(12, b, h, s, dh))
    dt = torch.float32 if fault == "float32" else torch.bfloat16
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if fault == "bias_shape":
        bias = bias[:, :-1].contiguous()
    elif fault == "k_shape":
        k = k[:, :, :-1].contiguous()
    with pytest.raises(ValueError):
        ma.masked_attention_fwd_fused(q, k, v, bias, dh ** -0.5, 0.3, 1, with_stats=True)


def test_cpu_path_never_builds_the_fused_backward(monkeypatch):
    """bf16 at DH = 64 on the CPU: the plain version and autograd, no build
    and no launch (the tensor-core forward's count included), although the
    card would take the tensor-core forward and the one-pass backward."""

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    before = [fn.launches for fn in ma.KERNELS]
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(9, 2, 2, 20, 64))
    q, k, v = (x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    ma.masked_attention(q, k, v, bias, seed=3, rate=0.2).float().sum().backward()
    assert torch.isfinite(q.grad.float()).all()
    assert [fn.launches for fn in ma.KERNELS] == before


def test_function_saves_only_when_a_gradient_is_wanted(monkeypatch):
    """``MaskedAttention`` asks its forward kernel for the row statistics,
    and saves tensors, only when q, k or v wants a gradient (the frozen
    bottom towers save nothing). The kernels are stood in for by the plain
    version."""
    calls, asked = [], []
    _stub_kernels(monkeypatch, calls, asked)
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(4, 2, 2, 9, 8))
    frozen = ma.MaskedAttention.apply(q, k, v, bias, 0, 0.0, 0.35)
    assert frozen.grad_fn is None
    live = ma.MaskedAttention.apply(q.requires_grad_(True), k, v, bias, 0, 0.0, 0.35)
    assert asked == [False, True]
    assert len(live.grad_fn.saved_tensors) == 6


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("s, b, masked", [(36, 4, True), (104, 8, True), (201, 2, False)])
def test_kernels_match_plain_on_card(dtype, rate, s, b, masked):
    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v, bias = (None if x is None else torch.from_numpy(x).to(dev) for x in _inputs(s, b, 12, s, 64, masked))
    if masked:
        bias[-1] = ta.MASK_BIAS  # a capacity-padding row: every key masked
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(s), device=dev).to(dt)
    before = [fn.launches for fn in ma.KERNELS]
    got = forward_and_grads(ma.masked_attention, q, k, v, bias, g, rate=rate, seed=1234)
    assert [fn.launches - n for fn, n in zip(ma.KERNELS, before)] == expected_launches(dt, s)
    want = forward_and_grads(ma.masked_attention_dropout_reference, q, k, v, bias, g, rate=rate, seed=1234)
    tol = F32_RTOL_OF_MAX if dtype == "float32" else BF16_RTOL_OF_MAX
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == w.dtype, name
        assert torch.isfinite(a).all(), name
        assert max_err_of_max(a, w) <= tol, (name, max_err_of_max(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [36, 104])
def test_kernel_mask_is_the_plain_philox(s):
    dev = _card()
    mask = read_back_mask(ma.masked_attention, 2, 3, s, 0.3, seed=99, device=dev)
    assert torch.equal(mask, ta.dropout_keep_mask(99, 2, 3, s, 0.3, dev))
    assert abs(mask.float().mean().item() - 0.7) < 0.05


@pytest.mark.gpu
def test_adjoint_identity_in_v():
    """<g, f(v2)> = <vjp_v(g), v2> holds only if the backward regenerates
    the forward's mask (float32, relative 1e-4)."""
    dev = _card()
    q, k, v, bias = (torch.from_numpy(x).to(dev) for x in _inputs(5, 4, 12, 104, 64))
    gen = torch.Generator(device=dev).manual_seed(5)
    g, v2 = (torch.randn(q.shape, generator=gen, device=dev) for _ in range(2))
    vv = v.clone().requires_grad_(True)
    ma.masked_attention(q, k, vv, bias, rate=0.3, seed=77).backward(g)
    lhs = (g.double() * ma.masked_attention(q, k, v2, bias, rate=0.3, seed=77).double()).sum().item()
    rhs = (vv.grad.double() * v2.double()).sum().item()
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.gpu
def test_cuda_path_never_calls_the_plain_version(monkeypatch):
    dev = _card()

    def no_plain(*a, **kw):
        raise AssertionError("the CUDA path must not call the plain version")

    for name in ("masked_attention_dropout_reference", "masked_attention_reference", "dropped_softmax_attention"):
        monkeypatch.setattr(ma, name, no_plain)
    monkeypatch.setattr(ta, "dropout_keep_mask", no_plain)
    q, k, v, bias = (torch.from_numpy(x).to(dev) for x in _inputs(7, 4, 12, 36, 64))
    got = forward_and_grads(ma.masked_attention, q, k, v, bias, torch.ones_like(q), rate=0.3, seed=5)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in got)


# the fused backward's S list: tower lengths (text 100 / 104, ViT 197 /
# 201), the ends of its range and the edges of its 16-key steps, 64-row
# tiles and 8-/16-warp blocks
FUSED_S = (1, 16, 17, 36, 100, 104, 127, 128, 129, 197, 201, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("s", FUSED_S)
def test_fused_backward_matches_plain_on_card(rate, s):
    """bf16 through the one-pass backward against the plain version, with
    about 30% of the keys padded and the last row of each batch fully
    masked (a capacity-padding row)."""
    dev = _card()
    b = 3
    q, k, v, bias = (torch.from_numpy(x).to(dev) for x in _inputs(s + 1000, b, 12, s, 64))
    bias[-1] = ta.MASK_BIAS
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(s), device=dev).to(torch.bfloat16)
    before = [fn.launches for fn in ma.KERNELS]
    got = forward_and_grads(ma.masked_attention, q, k, v, bias, g, rate=rate, seed=4321 + s)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(ma.KERNELS, before)] == ROUTE_LAUNCHES["tensor_core"]
    want = forward_and_grads(ma.masked_attention_dropout_reference, q, k, v, bias, g, rate=rate, seed=4321 + s)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        # at S = 1 dq and dk are 0 in exact arithmetic (softmax over one key
        # has no gradient): what remains is the rounding of g . v / (1 - rate)
        # - g . out (out in bf16), terms of the size of dv
        err = max_err_of_max(a, w, floor=want[3].float().abs().max().item() if s == 1 else 1e-30)
        assert err <= BF16_RTOL_OF_MAX, (name, err)
    # the fully masked rows: dq as the plain version's (equal weights 1/S)
    floor = want[3][-1].float().abs().max().item() if s == 1 else 1e-30
    assert max_err_of_max(got[1][-1], want[1][-1], floor=floor) <= BF16_RTOL_OF_MAX
    if rate == 0.0:  # and the forward's equal weights: out = mean of v
        mean_v = v[-1].float().mean(dim=-2, keepdim=True).expand(12, s, 64)
        assert max_err_of_max(got[0][-1], mean_v) <= BF16_RTOL_OF_MAX


@pytest.mark.gpu
@pytest.mark.parametrize("s", [104, 201])
def test_fused_backward_mask_is_the_plain_philox(s):
    """The backward's keep mask, read back through dv: with q = k = 0 and no
    bias every weight is 1/S, so with g one-hot in rows c*64 .. c*64+63,
    dv[j, d] = keep[c*64 + d, j] / (S (1 - rate))."""
    dev = _card()
    b, h, dh, rate, seed = 2, 3, 64, 0.3, 555
    zeros = torch.zeros(b, h, s, dh, device=dev, dtype=torch.bfloat16)
    chunks = []
    for c in range(-(-s // dh)):
        g = torch.zeros(s + dh, dh, device=dev)
        g[c * dh: (c + 1) * dh] = torch.eye(dh, device=dev)
        g = g[:s].to(torch.bfloat16).expand(b, h, s, dh).contiguous()
        v = zeros.clone().requires_grad_(True)
        before = ma.masked_attention_bwd_fused.launches
        ma.masked_attention(zeros, zeros, v, None, seed=seed, rate=rate).backward(g)
        assert ma.masked_attention_bwd_fused.launches == before + 1
        chunks.append(v.grad.float().transpose(-1, -2) != 0)  # [d, j]: row c*64 + d
    mask = torch.cat(chunks, dim=-2)[..., :s, :]
    assert torch.equal(mask, ta.dropout_keep_mask(seed, b, h, s, rate, dev))


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("s", FUSED_S)
def test_fused_forward_matches_plain_on_card(rate, s):
    """The tensor-core forward alone against the plain version, bf16, with
    about 30% of the keys padded and the last row of the batch fully masked:
    out within 1e-2 of max |ref|, the row statistics (f32 sums over bf16
    inputs) within 1e-4 of the plain ones, and the fully masked row's
    weights equal, 1/S, at rate 0."""
    dev = _card()
    b, h, dh = 3, 12, 64
    q, k, v, bias = (torch.from_numpy(x).to(dev) for x in _inputs(s + 2000, b, h, s, dh))
    bias[-1] = ta.MASK_BIAS
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    before = [fn.launches for fn in ma.KERNELS]
    out, stats = ma.masked_attention_fwd_fused(q, k, v, bias, dh ** -0.5, rate, 99 + s, with_stats=True)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(ma.KERNELS, before)] == [int(fn is ma.masked_attention_fwd_fused)
                                                                      for fn in ma.KERNELS]
    want = ma.masked_attention_dropout_reference(q, k, v, bias, 99 + s, rate, dh ** -0.5)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert max_err_of_max(out, want) <= BF16_RTOL_OF_MAX, max_err_of_max(out, want)
    m, log_l = plain_stats(q, k, bias, dh ** -0.5)
    # the fully masked row's max is -1e9 exactly (the bias swamps q . k in
    # f32), where a relative tolerance would say nothing: it is held apart
    assert torch.allclose(stats[0, :-1], m[:-1], rtol=1e-4, atol=1e-4)
    assert torch.equal(stats[0, -1], torch.full_like(stats[0, -1], ta.MASK_BIAS))
    assert torch.allclose(stats[1], log_l, rtol=1e-4, atol=1e-4)
    if rate == 0.0:
        mean_v = v[-1].float().mean(dim=-2, keepdim=True).expand(h, s, dh)
        assert max_err_of_max(out[-1], mean_v) <= BF16_RTOL_OF_MAX


@pytest.mark.gpu
@pytest.mark.parametrize("s", [36, 104, 201])
def test_fused_forward_mask_is_the_plain_philox(s):
    """The tensor-core forward's keep mask, read back in bf16 at DH = 64."""
    dev = _card()
    before = ma.masked_attention_fwd_fused.launches
    mask = read_back_mask(ma.masked_attention, 2, 3, s, 0.3, seed=98, device=dev, dh=64, dtype=torch.bfloat16)
    assert ma.masked_attention_fwd_fused.launches == before + -(-s // 64)
    assert torch.equal(mask, ta.dropout_keep_mask(98, 2, 3, s, 0.3, dev))
    assert abs(mask.float().mean().item() - 0.7) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("s", [36, 104, 201])
def test_fused_forward_stats_drive_both_backwards(s):
    """The tensor-core forward's output and statistics fed to the one-pass
    backward and to the tiled pair, both called directly on bf16 inputs:
    each gives the plain version's gradients within 1e-2 of max |ref| (rate
    0.3, a fully masked last row)."""
    dev = _card()
    b, h, dh, rate, seed = 3, 12, 64, 0.3, 4000 + s
    scale = dh ** -0.5
    q, k, v, bias = (torch.from_numpy(x).to(dev) for x in _inputs(s + 3000, b, h, s, dh))
    bias[-1] = ta.MASK_BIAS
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(s), device=dev).to(torch.bfloat16)
    out, stats = ma.masked_attention_fwd_fused(q, k, v, bias, scale, rate, seed, with_stats=True)
    one_pass = ma.masked_attention_bwd_fused(q, k, v, out, g, bias, stats, scale, rate, seed)
    dq, delta = ma.masked_attention_bwd_dq_tiled(q, k, v, out, g, bias, stats, scale, rate, seed)
    pair = (dq, *ma.masked_attention_bwd_dkv_tiled(q, k, v, g, bias, stats, delta, scale, rate, seed))
    torch.cuda.synchronize()
    want = forward_and_grads(ma.masked_attention_dropout_reference, q, k, v, bias, g, rate=rate, seed=seed)[1:]
    for route, got in (("one_pass", one_pass), ("pair", pair)):
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(a.float()).all(), (route, name)
            assert max_err_of_max(a, w) <= BF16_RTOL_OF_MAX, (route, name, max_err_of_max(a, w))
