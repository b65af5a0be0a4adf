"""The tree attention's two backward pairs: the route between them, the
tensor-core pair's wrapper contract, and the tensor-core pair against the
plain version on the card.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_tree_attention_bwd_route.py

Without a card the tests marked ``gpu`` skip. The plain backward is held
against the JAX package's ``_bwd`` in ``test_torch_tree_attention_train.py``.

Tolerances on the card (bf16 inputs, the plain version in f32 on the same
inputs): out, dq, dk, dv and dlut within 1e-2 x max|ref|, as for the other
bf16 kernels (the pair rounds P and dS to bf16 before the second products
and every output to bf16); the tensor-core pair against the CUDA-core pair
K2/K3 on the same inputs likewise. The adjoint identity in bf16 within 1e-3
relative: each side rounds its output (out, dv) to bf16, 2^-9 of each
element, and the forward rounds P where the backward rounds P / (1 - rate);
with g = f(v2) the left side is ||f(v2)||^2 > 0, and those roundings add up
to ~1e-4 of it, while a wrong mask at rate 0.3 moves it by tens of percent.
The masks read back bit for bit.
"""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

torch.set_num_threads(2)

BF16_RTOL_OF_MAX = 1e-2
BF16_ADJOINT_REL = 1e-3

# the ends of the route's S range and the edges of its 16-key steps, 32-row
# and 32-key blocks, 64-key and 64-row tiles, the canonical buckets and the
# streaming sizes
FUSED_S = (1, 16, 17, 33, 63, 64, 65, 129, 257, 601, 1025)

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
# the stand-ins each route calls for one forward and backward
ROUTE_CALLS = {"tensor_core": ["fwd_fused", "dq_fused", "dkv_fused"], "tf32": ["fwd", "dq_tf32", "dkv_tf32"],
               "cuda_core": ["fwd", "dq", "dkv"]}
# launches of ta.KERNELS (CUDA-core fwd, dq, dkv; tensor-core fwd, dq, dkv;
# 3xTF32 dq, dkv)
ROUTE_LAUNCHES = {"tensor_core": [0, 0, 0, 1, 1, 1, 0, 0], "tf32": [1, 0, 0, 0, 0, 0, 1, 1],
                  "cuda_core": [1, 1, 1, 0, 0, 0, 0, 0]}


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


def _cpu_inputs(seed, b, h, s, dh, dtype):
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in _inputs(seed, b, h, s, dh))
    return q.to(dtype), k.to(dtype), v.to(dtype), template, ids, lut


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    view = buf[1 : 1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def _stub_kernels(monkeypatch, calls, seen=None):
    """Stand-ins on CPU tensors for every kernel wrapper of ``ta``: each
    records its name in ``calls``. The forwards return the plain version's
    output and an LSE filled with a marker of their own (7 for the
    CUDA-core forward, 8 for the tensor-core one); the backward stand-ins
    record (name, LSE marker, g) in ``seen``."""
    markers = {"fwd": 7.0, "fwd_fused": 8.0}

    def fwd(name):
        def run(q, k, v, template, ids, lut, scale, double_add, rate, seed, with_lse):
            calls.append(name)
            out = ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, seed, rate, scale, double_add)
            return out, torch.full(q.shape[:3], markers[name]) if with_lse else None
        return run

    def note(name, lse, g):
        calls.append(name)
        assert lse.dtype == torch.float32 and lse.shape == g.shape[:3]
        assert len(set(lse.flatten().tolist())) == 1
        if seen is not None:
            seen.append((name, lse.flatten()[0].item(), g))

    def dq(name):
        def run(q, k, v, out, g, template, ids, lut, lse, scale, double_add, rate, seed):
            note(name, lse, g)
            return torch.zeros_like(q), torch.zeros_like(lut), torch.zeros(q.shape[:3])
        return run

    def dkv(name):
        def run(q, k, v, g, template, ids, lut, lse, delta, scale, double_add, rate, seed):
            note(name, lse, g)
            return torch.zeros_like(k), torch.zeros_like(v)
        return run

    stand_ins = {
        "tree_attention_fwd": fwd("fwd"), "tree_attention_fwd_fused": fwd("fwd_fused"),
        "tree_attention_bwd_dq": dq("dq"), "tree_attention_bwd_dkv": dkv("dkv"),
        "tree_attention_bwd_dq_fused": dq("dq_fused"), "tree_attention_bwd_dkv_fused": dkv("dkv_fused"),
        "tree_attention_bwd_dq_tf32": dq("dq_tf32"), "tree_attention_bwd_dkv_tf32": dkv("dkv_tf32"),
    }
    for name, fn in stand_ins.items():
        monkeypatch.setattr(ta, name, fn)
    return stand_ins


@pytest.mark.parametrize("dtype, dh, route", ROUTE_CASES)
def test_kernel_route_picks_both_directions(monkeypatch, dtype, dh, route):
    """``kernel_route`` names the tensor-core pair for bf16 at DH 64, the
    3xTF32 pair for float32 and K2/K3 for bf16 at DH 16, 32 and 128, and
    ``TreeAttention`` calls the route's forward and then its dq and dk/dv
    kernels, never another pair's. The kernels are stood in for on CPU
    tensors."""
    assert ta.kernel_route(dtype, dh) == route
    calls = []
    _stub_kernels(monkeypatch, calls)
    q, k, v, template, ids, lut = _cpu_inputs(3, 1, 2, 9, dh, dtype)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    ta.TreeAttention.apply(q, k, v, template, ids, lut, 5, 0.2, dh ** -0.5, True).float().sum().backward()
    assert calls == ROUTE_CALLS[route]
    assert q.grad.dtype == dtype and k.grad.shape == k.shape and v.grad.shape == v.shape


@pytest.mark.parametrize("forward", ["fwd", "fwd_fused"])
def test_fused_pair_takes_either_forwards_lse(monkeypatch, forward):
    """Both forwards write one LSE contract (f32 (B, H, S)); whichever of
    them runs the bf16 forward, ``TreeAttention`` hands its LSE, unchanged,
    to both kernels of the tensor-core pair."""
    calls, seen = [], []
    stand_ins = _stub_kernels(monkeypatch, calls, seen)
    monkeypatch.setattr(ta, "tree_attention_fwd_fused", stand_ins[f"tree_attention_{forward}"])
    q, k, v, template, ids, lut = _cpu_inputs(4, 2, 2, 9, 64, torch.bfloat16)
    q = q.requires_grad_(True)
    ta.TreeAttention.apply(q, k, v, template, ids, lut, 5, 0.3, 0.125, True).float().sum().backward()
    marker = {"fwd": 7.0, "fwd_fused": 8.0}[forward]
    assert calls == [forward, "dq_fused", "dkv_fused"]
    assert [(name, m) for name, m, _ in seen] == [("dq_fused", marker), ("dkv_fused", marker)]


def test_misaligned_g_is_copied_not_rerouted(monkeypatch):
    """A cotangent off a 16-byte boundary reaches the tensor-core pair as a
    16-byte aligned copy of the same values; the backward never routes to
    K2/K3 for it."""
    calls, seen = [], []
    _stub_kernels(monkeypatch, calls, seen)
    q, k, v, template, ids, lut = _cpu_inputs(5, 1, 2, 9, 64, torch.bfloat16)
    q = q.requires_grad_(True)
    out = ta.TreeAttention.apply(q, k, v, template, ids, lut, 5, 0.3, 0.125, True)
    g = torch.randn(out.shape).to(out.dtype)
    out.backward(_misaligned(g))
    assert calls == ["fwd_fused", "dq_fused", "dkv_fused"]
    for _, _, got in seen:
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert torch.equal(got, g)


def test_build_tables_name_the_tensor_core_backward():
    """``ops/cuda_lib.py`` builds the pair as its own library, whose C
    functions take K2's and K3's arguments."""
    assert cuda_lib.SOURCES["tree_bwd_mma"] == cuda_lib.CSRC / "tree_attention_bwd_mma.cu"
    assert cuda_lib.ENTRY_POINTS["tree_bwd_mma"] == {
        "tree_attention_bwd_dq_mma": cuda_lib.ENTRY_POINTS["tree_bwd"]["tree_attention_bwd_dq"],
        "tree_attention_bwd_dkv_mma": cuda_lib.ENTRY_POINTS["tree_bwd"]["tree_attention_bwd_dkv"],
    }
    assert cuda_lib.ERROR_STRINGS["tree_bwd_mma"] == "tree_attention_bwd_mma_error_string"
    assert "tree_bwd_mma" in cuda_lib.library_paths()


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_fused_pair_passes_k2_k3_arguments(monkeypatch, which):
    """The tensor-core wrappers launch their library's C function with the
    argument list of K2 / K3 (ctypes' types, the stream aside), the LSE in
    its slot, and count one launch. The device check is stood in for, so
    that CPU tensors reach the launch."""
    launched = []
    monkeypatch.setattr(ta, "_check_tensor_core_inputs", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "launch", lambda lib, fn, dev, *args: launched.append((lib, fn, args)))
    q, k, v, template, ids, lut = _cpu_inputs(6, 2, 3, 9, 64, torch.bfloat16)
    lse, delta = torch.randn(2, 3, 9), torch.randn(2, 3, 9)
    g, out = torch.randn(q.shape).bfloat16(), torch.randn(q.shape).bfloat16()
    if which == "dq":
        wrapper = ta.tree_attention_bwd_dq_fused
        before = wrapper.launches
        dq, dlut, d = wrapper(q, k, v, out, g, template, ids, lut, lse, 0.125, True, 0.3, 11)
        assert dq.shape == q.shape and dq.dtype == q.dtype and dlut.shape == (ta.LUT_SIZE, 3) and d.shape == (2, 3, 9)
        lse_slot = 8
    else:
        wrapper = ta.tree_attention_bwd_dkv_fused
        before = wrapper.launches
        dk, dv = wrapper(q, k, v, g, template, ids, lut, lse, delta, 0.125, True, 0.3, 11)
        assert dk.shape == k.shape and dv.dtype == v.dtype
        lse_slot = 7
    (lib, fn, args), = launched
    assert (lib, fn) == ("tree_bwd_mma", f"tree_attention_bwd_{which}_mma")
    assert len(args) + 1 == len(cuda_lib.ENTRY_POINTS[lib][fn])  # + the stream
    assert args[lse_slot] == lse.data_ptr()
    assert args[-1] == ta.DTYPE_CODES[torch.bfloat16] and args[-11:-8] == (2, 3, 9)
    assert wrapper.launches == before + 1


# each fault of the tensor-core pair's inputs, the kernel it reaches, and
# the words of its error
FUSED_FAULTS = {
    "float32": ("dq", "tensor-core"), "head_dim": ("dkv", "tensor-core"), "lse_dtype": ("dq", "lse"),
    "misaligned_q": ("dq", "aligned"), "misaligned_g": ("dkv", "aligned"), "misaligned_out": ("dq", "aligned"),
    "misaligned_k": ("dkv", "aligned"), "cpu_dq": ("dq", "runs on cuda"), "cpu_dkv": ("dkv", "runs on cuda"),
}


@pytest.mark.parametrize("fault", list(FUSED_FAULTS))
def test_fused_pair_input_checks(monkeypatch, fault):
    """What ``tree_attention_bwd_dq_fused`` and ``_dkv_fused`` refuse:
    anything but bf16 at DH 64, a malformed LSE, q, k, v, g or out off a
    16-byte boundary, and tensors off the card. They raise before any
    build."""

    def no_build():
        raise AssertionError("an input check must raise before the build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    which, words = FUSED_FAULTS[fault]
    dh = 32 if fault == "head_dim" else 64
    dt = torch.float32 if fault == "float32" else torch.bfloat16
    q, k, v, template, ids, lut = _cpu_inputs(8, 2, 2, 9, dh, dt)
    g, out = torch.randn(q.shape).to(dt), torch.randn(q.shape).to(dt)
    lse, delta = torch.randn(2, 2, 9), torch.randn(2, 2, 9)
    if fault == "lse_dtype":
        lse = lse.double()
    tensors = {"q": q, "k": k, "g": g, "out": out}
    name = fault.split("_")[-1]
    if fault.startswith("misaligned"):
        tensors[name] = _misaligned(tensors[name])
    q, k, g, out = (tensors[n] for n in ("q", "k", "g", "out"))
    with pytest.raises(ValueError, match=words):
        if which == "dq":
            ta.tree_attention_bwd_dq_fused(q, k, v, out, g, template, ids, lut, lse, dh ** -0.5, True, 0.3, 1)
        else:
            ta.tree_attention_bwd_dkv_fused(q, k, v, g, template, ids, lut, lse, delta, dh ** -0.5, True, 0.3, 1)


def test_cpu_path_never_builds_the_fused_backward(monkeypatch):
    """bf16 at DH = 64 on the CPU: the plain version and autograd, no build
    and no launch, although the card would take the tensor-core pair."""

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    monkeypatch.setattr(cuda_lib, "load_library", no_build)
    before = [fn.launches for fn in ta.KERNELS]
    q, k, v, template, ids, lut = _cpu_inputs(9, 1, 2, 17, 64, torch.bfloat16)
    q, k, v, lut = (x.requires_grad_(True) for x in (q, k, v, lut))
    ta.tree_attention(q, k, v, template, ids, lut, rate=0.2, seed=3).float().sum().backward()
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v, lut))
    assert [fn.launches for fn in ta.KERNELS] == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(seed, b, h, s, **kw):
    """The inputs on the card, q, k and v in bf16 at DH = 64, and a bf16
    cotangent."""
    q, k, v, template, ids, lut = (torch.from_numpy(a).cuda() for a in _inputs(seed, b, h, s, 64, **kw))
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), template, ids, lut, g.bfloat16()


def max_err_of_max(got, want, floor=1e-30):
    """max |got - want| over max(max |want|, floor)."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(floor)).item()


def forward_and_grads(fn, q, k, v, template, ids, lut, g, **kw):
    """fn's output and its gradients (dq, dk, dv, dlut) for the cotangent g."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v, lut)]
    out = fn(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], **kw)
    out.backward(g)
    return [out.detach()] + [x.grad for x in leaves]


def _assert_close_of_max(got, want, names, floor=1e-30):
    for name, a, w in zip(names, got, want):
        assert a.dtype == w.dtype, name
        assert torch.isfinite(a.float()).all(), name
        err = max_err_of_max(a, w, floor)
        assert err <= BF16_RTOL_OF_MAX, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("s", FUSED_S)
def test_fused_pair_matches_plain_on_card(rate, s):
    """bf16 through ``tree_attention``: the tensor-core forward, then the
    tensor-core pair, against the plain version's forward and autograd
    gradients on the same inputs."""
    _card()
    b = 2 if s <= 257 else 1
    q, k, v, template, ids, lut, g = _card_inputs(s, b, 12, s)
    before = [fn.launches for fn in ta.KERNELS]
    got = forward_and_grads(ta.tree_attention, q, k, v, template, ids, lut, g, rate=rate, seed=2468)
    torch.cuda.synchronize()
    assert [fn.launches for fn in ta.KERNELS] == [n + d for n, d in zip(before, ROUTE_LAUNCHES["tensor_core"])]
    want = forward_and_grads(ta.tree_attention_dropout_reference, q, k, v, template, ids, lut, g, rate=rate, seed=2468)
    _assert_close_of_max(got[:1] + got[3:4], want[:1] + want[3:4], ("out", "dv"))
    # at S = 1 dq, dk and dlut are 0 in exact arithmetic (softmax over one
    # key has no gradient): what remains is the rounding of g . v / (1 -
    # rate) - g . out (out in bf16), terms of the size of dv
    floor = want[3].float().abs().max().item() if s == 1 else 1e-30
    _assert_close_of_max(got[1:3] + got[4:], want[1:3] + want[4:], ("dq", "dk", "dlut"), floor)
    assert torch.equal(got[4][0], torch.zeros_like(got[4][0]))  # LUT row 0 gets nothing


def _pair(q, k, v, template, ids, lut, g, rate, seed, fused: bool, lse_from_fused: bool = True):
    """dq, dk, dv, dlut of one backward pair from the LSE of one forward."""
    fwd = ta.tree_attention_fwd_fused if lse_from_fused else ta.tree_attention_fwd
    out, lse = fwd(q, k, v, template, ids, lut, 0.125, True, rate, seed, with_lse=True)
    dq_fn, dkv_fn = ((ta.tree_attention_bwd_dq_fused, ta.tree_attention_bwd_dkv_fused) if fused
                     else (ta.tree_attention_bwd_dq, ta.tree_attention_bwd_dkv))
    dq, dlut, delta = dq_fn(q, k, v, out, g, template, ids, lut, lse, 0.125, True, rate, seed)
    dk, dv = dkv_fn(q, k, v, g, template, ids, lut, lse, delta, 0.125, True, rate, seed)
    return [dq, dk, dv, dlut]


@pytest.mark.gpu
@pytest.mark.parametrize("s, b", [(33, 12), (129, 4), (601, 1)])
def test_fused_pair_matches_k2_k3_on_card(s, b):
    """The tensor-core pair against the CUDA-core pair K2/K3 on the same
    bf16 inputs and LSE, and the tensor-core pair from K1's LSE against it
    from the tensor-core forward's: either forward feeds it."""
    _card()
    q, k, v, template, ids, lut, g = _card_inputs(3 * s, b, 12, s)
    names = ("dq", "dk", "dv", "dlut")
    fused = _pair(q, k, v, template, ids, lut, g, 0.3, 77, fused=True)
    _assert_close_of_max(fused, _pair(q, k, v, template, ids, lut, g, 0.3, 77, fused=False), names)
    _assert_close_of_max(_pair(q, k, v, template, ids, lut, g, 0.3, 77, fused=True, lse_from_fused=False), fused, names)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [33, 601])
def test_fused_pair_masked_rows_and_ids_on_card(s):
    """A row whose every key the template masks has p = 0: its dq is zero
    and it adds nothing to dk, dv or dlut. ids outside [0, 32) and LUT row 0
    add nothing (dq, dk and dv bit for bit; dlut up to the order of its
    atomic sums), and dlut's row 0 stays zero."""
    _card()
    q, k, v, template, ids, lut, g = _card_inputs(s + 5, 2, 12, s, id_low=-40, id_high=3 * ta.LUT_SIZE)
    template[0, s // 2] = ta.MASK_BIAS  # one row fully masked, column 0 included
    got = _pair(q, k, v, template, ids, lut, g, 0.3, 9, fused=True)
    assert torch.equal(got[0][0, :, s // 2].float(), torch.zeros_like(got[0][0, :, s // 2].float()))
    assert torch.equal(got[3][0], torch.zeros_like(got[3][0]))
    want = forward_and_grads(ta.tree_attention_dropout_reference, q, k, v, template, ids, lut, g, rate=0.3, seed=9)
    _assert_close_of_max(got, want[1:], ("dq", "dk", "dv", "dlut"))
    # the masked row's g changes nothing else
    g2 = g.clone()
    g2[0, :, s // 2] = 100.0
    again = _pair(q, k, v, template, ids, lut, g2, 0.3, 9, fused=True)
    for a, w in zip(again[:3], got[:3]):
        assert torch.equal(a, w)
    torch.testing.assert_close(again[3], got[3], rtol=1e-5, atol=1e-6)
    clean = torch.where((ids >= 0) & (ids < ta.LUT_SIZE), ids, 0).to(torch.int32).contiguous()
    dirty_lut = lut.clone()
    dirty_lut[0] = 7.0
    again = _pair(q, k, v, template, clean, dirty_lut, g, 0.3, 9, fused=True)
    for a, w in zip(again[:3], got[:3]):
        assert torch.equal(a, w)
    torch.testing.assert_close(again[3], got[3], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("s, b", [(33, 4), (257, 1), (601, 1)])
def test_fused_pair_adjoint_identity_in_v(s, b):
    """<g, f(v2)> = <vjp_v(g), v2> in bf16 through the tensor-core forward
    and pair, with g = f(v2): it holds only if the backward regenerates the
    forward's mask."""
    _card()
    q, k, v, template, ids, lut, _ = _card_inputs(s + 1, b, 12, s)
    v2 = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda").bfloat16()
    g = ta.tree_attention(q, k, v2, template, ids, lut, rate=0.3, seed=77)
    vv = v.clone().requires_grad_(True)
    ta.tree_attention(q, k, vv, template, ids, lut, rate=0.3, seed=77).backward(g)
    lhs = (g.double() * g.double()).sum().item()
    rhs = (vv.grad.double() * v2.double()).sum().item()
    assert abs(lhs - rhs) <= BF16_ADJOINT_REL * abs(lhs), (lhs, rhs)


def read_back_bwd_masks(b, h, s, rate, seed):
    """The tensor-core pair's keep masks, read back in bf16 with q = 0 and
    no bias (every weight 1/S), one 64-row or 64-key chunk c at a time:
    - the dk/dv kernel's, through dv: with g one-hot in rows c*64 ..
      c*64+63, dv[j, d] = keep[c*64 + d, j] / (S (1 - rate));
    - the dq kernel's, through dq: with v and g = e_0 on every row, ds_ij =
      (keep_ij / (1 - rate) - D_i) / S where D_i, the kept share over 1 -
      rate, is below 1 / (1 - rate), so ds > 0 exactly where kept; with k
      one-hot in keys c*64 .. c*64+63, dq[i, d] = ds[i, c*64 + d] / 8."""
    dh = 64
    zeros = torch.zeros(b, h, s, dh, device="cuda", dtype=torch.bfloat16)
    template = torch.zeros(b, s, s, device="cuda")
    ids = torch.zeros(b, s, s, dtype=torch.int32, device="cuda")
    lut = torch.zeros(ta.LUT_SIZE, h, device="cuda")
    e0 = zeros.clone()
    e0[..., 0] = 1.0
    by_dv, by_dq = [], []
    for c in range(-(-s // dh)):
        onehot = torch.zeros(s + dh, dh, device="cuda")
        onehot[c * dh : (c + 1) * dh] = torch.eye(dh, device="cuda")
        onehot = onehot[:s].bfloat16().expand(b, h, s, dh).contiguous()
        v = zeros.clone().requires_grad_(True)
        ta.tree_attention(zeros, zeros, v, template, ids, lut, rate=rate, seed=seed).backward(onehot)
        by_dv.append(v.grad.float().transpose(-1, -2) != 0)
        q = zeros.clone().requires_grad_(True)
        ta.tree_attention(q, onehot, e0, template, ids, lut, rate=rate, seed=seed).backward(e0)
        by_dq.append(q.grad.float() > 0)
    return torch.cat(by_dv, dim=-2)[..., :s, :], torch.cat(by_dq, dim=-1)[..., :s]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [33, 601])
def test_fused_pair_mask_is_the_plain_philox(s):
    """Both kernels of the tensor-core pair regenerate the plain Philox mask
    bit for bit, read back through dv (the dk/dv kernel) and dq (the dq
    kernel) over several 64-row and 64-key chunks."""
    _card()
    b, h, rate = 1, 3, 0.3
    before = [fn.launches for fn in ta.KERNELS]
    by_dv, by_dq = read_back_bwd_masks(b, h, s, rate, 99)
    chunks = -(-s // 64)
    assert [fn.launches for fn in ta.KERNELS] == [n + 2 * chunks * d for n, d in zip(before, ROUTE_LAUNCHES["tensor_core"])]
    want = ta.dropout_keep_mask(99, b, h, s, rate, "cuda")
    assert torch.equal(by_dv, want)
    assert torch.equal(by_dq, want)
    assert abs(want.float().mean().item() - (1 - rate)) < 0.05
