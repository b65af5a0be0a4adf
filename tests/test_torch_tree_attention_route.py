"""The tree attention's two forward kernels: the route between them, the
tensor-core forward's wrapper contract, and the tensor-core forward against
the plain version on the card.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_tree_attention_route.py

Without a card the tests marked ``gpu`` skip. The comparisons with the JAX
package are in ``test_torch_tree_attention.py`` and
``test_torch_tree_attention_train.py``.

Tolerances on the card (bf16 inputs, the plain version in f32 on the same
inputs): out, dq, dk, dv and dlut within 1e-2 x max|ref|, as for the other
bf16 kernels (the tensor-core forward rounds p to bf16 before P V, the
backward rounds out and g before g . out, every output is rounded to bf16);
the LSE within 1e-4 x max(1, |ref|) elementwise (both sum exact bf16
products in f32, in other orders).
"""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

torch.set_num_threads(2)

BF16_RTOL_OF_MAX = 1e-2
LSE_RTOL = 1e-4

# the ends of the route's S range and the edges of its 16-key steps, 64-key
# tiles and 64-row blocks, the canonical buckets and the streaming sizes
FUSED_S = (1, 2, 17, 33, 63, 64, 65, 129, 257, 601, 1025)


def _inputs(seed, b, h, s, dh, id_low=0, id_high=ta.LUT_SIZE):
    """numpy (q, k, v, template, ids, lut) with ~15% of the template
    masked (never column 0, as the collator never does)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    template = np.where(rng.random((b, s, s)) < 0.15, ta.MASK_BIAS, 0.0).astype(np.float32)
    template[:, :, 0] = 0.0
    ids = rng.integers(id_low, id_high, (b, s, s)).astype(np.int32)
    lut = rng.standard_normal((ta.LUT_SIZE, h)).astype(np.float32)
    lut[0] = 0.0
    return q, k, v, template, ids, lut


def _card_inputs(seed, b, h, s, **kw):
    """The inputs on the card, q, k and v in bf16 at DH = 64."""
    q, k, v, template, ids, lut = (torch.from_numpy(a).cuda() for a in _inputs(seed, b, h, s, 64, **kw))
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), template, ids, lut


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def max_err_of_max(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def plain_lse(q, k, template, ids, lut, scale, double_add=True):
    """m + log(l) in f32 as the kernels store it: the row max clamped at
    -1e9, the undropped row sum clamped at 1e-30."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float()) + ta.assemble_bias(template, ids, lut, double_add)
    m = s.amax(-1).clamp_min(ta.MASK_BIAS)
    return m + torch.exp(s - m[..., None]).sum(-1).clamp_min(1e-30).log()


def forward_and_grads(fn, q, k, v, template, ids, lut, g, **kw):
    """fn's output and its gradients (dq, dk, dv, dlut) for the cotangent g."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v, lut)]
    out = fn(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], **kw)
    out.backward(g)
    return [out.detach()] + [x.grad for x in leaves]


# launches of ta.KERNELS (CUDA-core fwd, dq, dkv; tensor-core fwd, dq, dkv;
# 3xTF32 dq, dkv) for one forward and backward, by route
ROUTE_LAUNCHES = {"tensor_core": [0, 0, 0, 1, 1, 1, 0, 0], "tf32": [1, 0, 0, 0, 0, 0, 1, 1],
                  "cuda_core": [1, 1, 1, 0, 0, 0, 0, 0]}

ROUTE_CASES = [
    (torch.bfloat16, 64, "tensor_core"),  # every graph layer of the model
    (torch.bfloat16, 16, "cuda_core"),
    (torch.bfloat16, 32, "cuda_core"),
    (torch.bfloat16, 128, "cuda_core"),
    (torch.float32, 16, "tf32"),
    (torch.float32, 32, "tf32"),
    (torch.float32, 64, "tf32"),  # f32: the card-vs-CPU steps' tolerances
    (torch.float32, 128, "tf32"),
]


@pytest.mark.parametrize("dtype, dh, route", ROUTE_CASES)
def test_kernel_route(dtype, dh, route):
    assert ta.kernel_route(dtype, dh) == route


def test_model_graph_layers_route_to_tensor_cores():
    """``ModelConfig()``'s graph layers (bf16, d = 768 over 12 heads) take
    the tensor-core forward; its float32 twin takes the "tf32" route, whose
    forward is the CUDA-core one."""
    from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig

    mc = ModelConfig()
    dh = mc.encoder_embed_dim // mc.encoder_attention_heads
    assert (mc.dtype, dh) == ("bfloat16", 64)
    assert ta.kernel_route(getattr(torch, mc.dtype), dh) == "tensor_core"
    assert ta.kernel_route(torch.float32, dh) == "tf32"


def test_build_tables_name_the_tensor_core_forward():
    assert cuda_lib.SOURCES["tree_fwd_mma"] == cuda_lib.CSRC / "tree_attention_fwd_mma.cu"
    assert cuda_lib.ENTRY_POINTS["tree_fwd_mma"] == {"tree_attention_fwd_mma": cuda_lib.ENTRY_POINTS["tree_fwd"]["tree_attention_fwd"]}
    assert cuda_lib.ERROR_STRINGS["tree_fwd_mma"] == "tree_attention_fwd_mma_error_string"


def _stub_kernels(monkeypatch, calls, asked=None):
    """Stand-ins on CPU tensors for every kernel wrapper of ``ta``: each
    records its name in ``calls``; the forwards return the plain version's
    output and (when asked, recorded in ``asked``) a marked LSE that the
    backward stand-ins check they were given."""
    marker = 7.0

    def fwd(name):
        def run(q, k, v, template, ids, lut, scale, double_add, rate, seed, with_lse):
            calls.append(name)
            if asked is not None:
                asked.append(with_lse)
            out = ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, seed, rate, scale, double_add)
            return out, torch.full(q.shape[:3], marker) if with_lse else None
        return run

    def fake_dq(name):
        def run(q, k, v, out, g, template, ids, lut, lse, scale, double_add, rate, seed):
            calls.append(name)
            assert bool((lse == marker).all())
            return torch.zeros_like(q), torch.zeros_like(lut), torch.zeros(q.shape[:3])
        return run

    def fake_dkv(name):
        def run(q, k, v, g, template, ids, lut, lse, delta, scale, double_add, rate, seed):
            calls.append(name)
            assert bool((lse == marker).all())
            return torch.zeros_like(k), torch.zeros_like(v)
        return run

    for name, fn in (("tree_attention_fwd", fwd("fwd")), ("tree_attention_fwd_fused", fwd("fwd_fused")),
                     ("tree_attention_bwd_dq", fake_dq("dq")), ("tree_attention_bwd_dkv", fake_dkv("dkv")),
                     ("tree_attention_bwd_dq_fused", fake_dq("dq_fused")),
                     ("tree_attention_bwd_dkv_fused", fake_dkv("dkv_fused")),
                     ("tree_attention_bwd_dq_tf32", fake_dq("dq_tf32")),
                     ("tree_attention_bwd_dkv_tf32", fake_dkv("dkv_tf32"))):
        monkeypatch.setattr(ta, name, fn)


@pytest.mark.parametrize("with_grad", [False, True])
@pytest.mark.parametrize("dtype, dh, route", ROUTE_CASES)
def test_forward_launches_the_routed_kernel(monkeypatch, dtype, dh, route, with_grad):
    """``TreeAttention.forward`` calls the forward ``kernel_route`` names,
    asking for the LSE only when an input wants a gradient. The kernels are
    stood in for on CPU tensors."""
    calls, asked = [], []
    _stub_kernels(monkeypatch, calls, asked)
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 9, dh))
    q, k, v = (x.to(dtype).requires_grad_(with_grad) for x in (q, k, v))
    ta.TreeAttention.apply(q, k, v, template, ids, lut, 5, 0.2, dh ** -0.5, True)
    assert calls == ["fwd_fused" if route == "tensor_core" else "fwd"]
    assert asked == [with_grad]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_both_forwards_feed_one_backward(monkeypatch, dtype):
    """Each forward's LSE goes to the backward pair of its route: the
    tensor-core forward's to the tensor-core dq and dk/dv kernels, the
    CUDA-core forward's (float32) to the 3xTF32 pair."""
    calls = []
    _stub_kernels(monkeypatch, calls)
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in _inputs(4, 2, 2, 9, 64))
    q, k, v = (x.to(dtype).requires_grad_(True) for x in (q, k, v))
    ta.TreeAttention.apply(q, k, v, template, ids, lut, 5, 0.2, 0.125, True).float().sum().backward()
    want = ["fwd_fused", "dq_fused", "dkv_fused"] if dtype == torch.bfloat16 else ["fwd", "dq_tf32", "dkv_tf32"]
    assert calls == want
    assert q.grad.dtype == dtype and k.grad.shape == k.shape


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    view = buf[1 : 1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


# each fault of the tensor-core forward's inputs and the words of its error
FUSED_FAULTS = {"float32": "tensor-core", "head_dim": "tensor-core", "ids_dtype": "ids", "k_shape": "k must",
                "misaligned_q": "aligned", "misaligned_v": "aligned", "cpu": "runs on cuda"}


@pytest.mark.parametrize("fault", list(FUSED_FAULTS))
def test_fused_forward_input_checks(monkeypatch, fault):
    """What ``tree_attention_fwd_fused`` refuses: anything but bf16 at DH
    64, malformed ids or k, q, k or v off a 16-byte boundary, and tensors
    off the card. It raises before any build."""

    def no_build():
        raise AssertionError("an input check must raise before the build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    dh = 32 if fault == "head_dim" else 64
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in _inputs(8, 2, 2, 9, dh))
    dt = torch.float32 if fault == "float32" else torch.bfloat16
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if fault == "ids_dtype":
        ids = ids.long()
    elif fault == "k_shape":
        k = k[:, :, :-1].contiguous()
    elif fault == "misaligned_q":
        q = _misaligned(q)
    elif fault == "misaligned_v":
        v = _misaligned(v)
    with pytest.raises(ValueError, match=FUSED_FAULTS[fault]):
        ta.tree_attention_fwd_fused(q, k, v, template, ids, lut, dh ** -0.5, True, 0.3, 1, with_lse=True)


def test_cpu_path_never_builds_the_fused_forward(monkeypatch):
    """bf16 at DH = 64 on the CPU: the plain version and autograd, no build
    and no launch, although the card would take the tensor-core forward."""

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    before = [fn.launches for fn in ta.KERNELS]
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in _inputs(9, 1, 2, 17, 64))
    q, k, v = (x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    ta.tree_attention(q, k, v, template, ids, lut, rate=0.2, seed=3).float().sum().backward()
    assert torch.isfinite(q.grad.float()).all()
    assert [fn.launches for fn in ta.KERNELS] == before


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("s", FUSED_S)
def test_fused_forward_matches_plain_on_card(rate, s):
    """The tensor-core forward alone, with its LSE, against the plain
    version on the same bf16 inputs."""
    _card()
    b = 2 if s <= 257 else 1
    q, k, v, template, ids, lut = _card_inputs(s, b, 12, s)
    before = [fn.launches for fn in ta.KERNELS]
    out, lse = ta.tree_attention_fwd_fused(q, k, v, template, ids, lut, 0.125, True, rate, 4321, with_lse=True)
    assert [fn.launches for fn in ta.KERNELS] == [n + d for n, d in zip(before, [0, 0, 0, 1, 0, 0, 0, 0])]
    want = ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, 4321, rate, 0.125)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert max_err_of_max(out, want) <= BF16_RTOL_OF_MAX, max_err_of_max(out, want)
    ref = plain_lse(q, k, template, ids, lut, 0.125)
    torch.testing.assert_close(lse, ref, rtol=LSE_RTOL, atol=LSE_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [33, 601])
def test_fused_forward_masked_rows_and_ids_on_card(s):
    """A row whose every key the template masks gives zeros (and the LSE
    -1e9 + log 1e-30), not equal weights; ids outside [0, 32) and LUT row 0
    add nothing, bit for bit."""
    _card()
    q, k, v, template, ids, lut = _card_inputs(s + 3, 2, 12, s, id_low=-40, id_high=3 * ta.LUT_SIZE)
    template[0, s // 2] = ta.MASK_BIAS  # one row fully masked, column 0 included
    out, lse = ta.tree_attention_fwd_fused(q, k, v, template, ids, lut, 0.125, True, 0.3, 9, with_lse=True)
    assert torch.equal(out[0, :, s // 2].float(), torch.zeros_like(out[0, :, s // 2].float()))
    torch.testing.assert_close(lse[0, :, s // 2], torch.full_like(lse[0, :, s // 2], ta.MASK_BIAS + np.log(1e-30)))
    want = ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, 9, 0.3, 0.125)
    assert max_err_of_max(out, want) <= BF16_RTOL_OF_MAX
    clean = torch.where((ids >= 0) & (ids < ta.LUT_SIZE), ids, 0).to(torch.int32).contiguous()
    dirty_lut = lut.clone()
    dirty_lut[0] = 7.0
    again, _ = ta.tree_attention_fwd_fused(q, k, v, template, clean, dirty_lut, 0.125, True, 0.3, 9)
    assert torch.equal(again, out)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("s, b", [(33, 4), (129, 2), (601, 1), (1025, 1)])
def test_gradients_through_the_fused_forward_lse(rate, s, b):
    """bf16 through ``tree_attention``: the tensor-core forward, then the
    backward kernels reading its LSE and regenerating its mask, against the
    plain version's forward and autograd gradients."""
    dev = _card()
    q, k, v, template, ids, lut = _card_inputs(7 * s, b, 12, s)
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(s), device=dev).bfloat16()
    before = [fn.launches for fn in ta.KERNELS]
    got = forward_and_grads(ta.tree_attention, q, k, v, template, ids, lut, g, rate=rate, seed=1234)
    assert [fn.launches for fn in ta.KERNELS] == [n + d for n, d in zip(before, ROUTE_LAUNCHES["tensor_core"])]
    want = forward_and_grads(ta.tree_attention_dropout_reference, q, k, v, template, ids, lut, g, rate=rate, seed=1234)
    for name, a, w in zip(("out", "dq", "dk", "dv", "dlut"), got, want):
        assert a.dtype == w.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert max_err_of_max(a, w) <= BF16_RTOL_OF_MAX, (name, max_err_of_max(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [33, 601])
def test_fused_forward_mask_is_the_plain_philox(s):
    """With q = k = 0 and no bias every row weighs its keys equally, so with
    v holding one-hot columns for keys c*64 .. c*64+63, out = keep / (S (1 -
    rate)) there (within a bf16 step, far from the 0.5 the rounding cuts
    at): the tensor-core forward's mask, read back over several key tiles,
    equals the plain Philox bit for bit."""
    dev = _card()
    b, h, dh, rate = 1, 3, 64, 0.3
    zeros = torch.zeros(b, h, s, dh, device=dev, dtype=torch.bfloat16)
    template = torch.zeros(b, s, s, device=dev)
    ids = torch.zeros(b, s, s, dtype=torch.int32, device=dev)
    lut = torch.zeros(ta.LUT_SIZE, h, device=dev)
    before = ta.tree_attention_fwd_fused.launches
    chunks = []
    for c in range(-(-s // dh)):
        v = torch.zeros(s + dh, dh, device=dev)
        v[c * dh : (c + 1) * dh] = torch.eye(dh, device=dev)
        out = ta.tree_attention(zeros, zeros, v[:s].bfloat16().expand(b, h, s, dh).contiguous(), template, ids, lut,
                                rate=rate, seed=99)
        chunks.append((out.float() * s * (1 - rate)).round() > 0.5)
    assert ta.tree_attention_fwd_fused.launches == before + len(chunks)
    mask = torch.cat(chunks, dim=-1)[..., :s]
    assert torch.equal(mask, ta.dropout_keep_mask(99, b, h, s, rate, dev))
    assert abs(mask.float().mean().item() - (1 - rate)) < 0.05
