"""The tree attention's 3xTF32 backward pair (the float32 route): the route
to it, its wrappers' contract, and the pair against the plain version and
against K2/K3 on the card.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_tree_attention_bwd_tf32.py

Without a card the tests marked ``gpu`` skip. The plain backward is held
against the JAX package's ``_bwd`` in ``test_torch_tree_attention_train.py``
(DH 8, 16 and 128).

Tolerances on the card (float32 inputs, TF32 off for PyTorch's own
products): dq, dk, dv and dlut within 1e-4 x max|ref| of the plain version
on the same inputs, as for K2/K3. 3xTF32 drops the small x small term of
each product (~2^-22 of it) and the tensor cores sum in another order than
the plain version, a few float32 roundings per product; dlut's atomics add
in an order that changes between runs. The pair against K2/K3 on the same
inputs and LSE likewise. The adjoint identity in v within 1e-4 relative,
as K2/K3's. The masks read back bit for bit.
"""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

torch.set_num_threads(2)

F32_RTOL_OF_MAX = 1e-4
ADJOINT_REL = 1e-4

# the ends of the route's S range and the edges of its 8-key n-tiles, 16-row
# steps, 32-row and 32-key blocks, 32- and 64-key and -row tiles, the
# canonical buckets and the streaming sizes
TF32_S = (1, 8, 9, 16, 17, 33, 63, 64, 65, 129, 257, 601, 1025)

ROUTE_CASES = [
    (torch.float32, 16, "tf32"),  # the tiny configs and the workflows
    (torch.float32, 32, "tf32"),
    (torch.float32, 64, "tf32"),  # the full-width float32 card steps
    (torch.float32, 128, "tf32"),
    (torch.bfloat16, 64, "tensor_core"),  # every graph layer of the model
    (torch.bfloat16, 16, "cuda_core"),
    (torch.bfloat16, 32, "cuda_core"),
    (torch.bfloat16, 128, "cuda_core"),
]


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


def _cpu_inputs(seed, b, h, s, dh, dtype=torch.float32):
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in _inputs(seed, b, h, s, dh))
    return q.to(dtype), k.to(dtype), v.to(dtype), template, ids, lut


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    view = buf[1 : 1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def _stub_kernels(monkeypatch, calls, seen):
    """Stand-ins on CPU tensors for the kernel wrappers ``TreeAttention``
    calls: each records its name in ``calls``; the backward stand-ins also
    record (name, q, g, out) in ``seen``."""

    def fwd(name):
        def run(q, k, v, template, ids, lut, scale, double_add, rate, seed, with_lse):
            calls.append(name)
            out = ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, seed, rate, scale, double_add)
            return out, torch.zeros(q.shape[:3]) if with_lse else None
        return run

    def dq(name):
        def run(q, k, v, out, g, template, ids, lut, lse, scale, double_add, rate, seed):
            calls.append(name)
            seen.append((name, q, g, out))
            return torch.zeros_like(q), torch.zeros_like(lut), torch.zeros(q.shape[:3])
        return run

    def dkv(name):
        def run(q, k, v, g, template, ids, lut, lse, delta, scale, double_add, rate, seed):
            calls.append(name)
            seen.append((name, q, g, None))
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


ROUTE_CALLS = {"tf32": ["fwd", "dq_tf32", "dkv_tf32"], "tensor_core": ["fwd_fused", "dq_fused", "dkv_fused"],
               "cuda_core": ["fwd", "dq", "dkv"]}


@pytest.mark.parametrize("dtype, dh, route", ROUTE_CASES)
def test_route_sends_float32_backward_to_the_tf32_pair(monkeypatch, dtype, dh, route):
    """``kernel_route`` for every (dtype, DH): float32 takes the 3xTF32 pair
    (after the CUDA-core forward), bf16 at DH 64 the tensor-core kernels and
    bf16 at DH 16, 32, 128 K2/K3; ``TreeAttention`` calls exactly those."""
    assert ta.kernel_route(dtype, dh) == route
    calls, seen = [], []
    _stub_kernels(monkeypatch, calls, seen)
    q, k, v, template, ids, lut = _cpu_inputs(3, 1, 2, 9, dh, dtype)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    ta.TreeAttention.apply(q, k, v, template, ids, lut, 5, 0.2, dh ** -0.5, True).float().sum().backward()
    assert calls == ROUTE_CALLS[route]


def test_misaligned_views_reach_the_tf32_pair_as_aligned_copies(monkeypatch):
    """q, k, v (which K1 takes as they are) and g off a 16-byte boundary
    reach the 3xTF32 pair as 16-byte aligned copies of the same values."""
    calls, seen = [], []
    _stub_kernels(monkeypatch, calls, seen)
    q, k, v, template, ids, lut = _cpu_inputs(5, 1, 2, 9, 16)
    q = _misaligned(q).requires_grad_(True)
    out = ta.TreeAttention.apply(q, k, v, template, ids, lut, 5, 0.3, 0.25, True)
    g = torch.randn(out.shape)
    out.backward(_misaligned(g))
    assert calls == ["fwd", "dq_tf32", "dkv_tf32"]
    for _, q_got, g_got, out_got in seen:
        for t in (q_got, g_got) + ((out_got,) if out_got is not None else ()):
            assert t.data_ptr() % 16 == 0 and t.is_contiguous()
        assert torch.equal(q_got, q.detach()) and torch.equal(g_got, g)


def test_build_tables_name_the_tf32_backward():
    """``ops/cuda_lib.py`` builds the pair as its own library in the one
    parallel nvcc pass, whose C functions take K2's and K3's arguments."""
    assert cuda_lib.SOURCES["tree_bwd_tf32"] == cuda_lib.CSRC / "tree_attention_bwd_tf32.cu"
    assert cuda_lib.SOURCES["tree_bwd_tf32"].is_file()
    assert cuda_lib.ENTRY_POINTS["tree_bwd_tf32"] == {
        "tree_attention_bwd_dq_tf32": cuda_lib.ENTRY_POINTS["tree_bwd"]["tree_attention_bwd_dq"],
        "tree_attention_bwd_dkv_tf32": cuda_lib.ENTRY_POINTS["tree_bwd"]["tree_attention_bwd_dkv"],
    }
    assert cuda_lib.ERROR_STRINGS["tree_bwd_tf32"] == "tree_attention_bwd_tf32_error_string"
    assert cuda_lib.library_paths()["tree_bwd_tf32"].parent == cuda_lib.BUILD_DIR
    assert ta.tree_attention_bwd_dq_tf32 in ta.KERNELS and ta.tree_attention_bwd_dkv_tf32 in ta.KERNELS


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_tf32_pair_passes_k2_k3_arguments(monkeypatch, which):
    """Each wrapper launches its library's C function with the arguments
    K2 / K3's wrapper passes, in K2 / K3's order (the outputs it allocates
    aside), and counts one launch. The device check is stood in for, so
    that CPU tensors reach the launch."""
    launched = []
    monkeypatch.setattr(ta, "_check_tensor_core_inputs", lambda *a, **kw: None)
    monkeypatch.setattr(cuda_lib, "launch", lambda lib, fn, dev, *args: launched.append((lib, fn, args)))
    q, k, v, template, ids, lut = _cpu_inputs(6, 2, 3, 9, 32)
    lse, delta = torch.randn(2, 3, 9), torch.randn(2, 3, 9)
    g, out = torch.randn(q.shape), torch.randn(q.shape)
    if which == "dq":
        args = (q, k, v, out, g, template, ids, lut, lse, 32 ** -0.5, True, 0.3, 11)
        wrapper, k2 = ta.tree_attention_bwd_dq_tf32, ta.tree_attention_bwd_dq
        outputs = slice(9, 12)  # dq, dlut, delta
    else:
        args = (q, k, v, g, template, ids, lut, lse, delta, 32 ** -0.5, True, 0.3, 11)
        wrapper, k2 = ta.tree_attention_bwd_dkv_tf32, ta.tree_attention_bwd_dkv
        outputs = slice(9, 11)  # dk, dv
    before = wrapper.launches
    got = wrapper(*args)
    k2(*args)
    assert wrapper.launches == before + 1
    (lib, fn, mine), (lib2, fn2, theirs) = launched
    assert (lib, fn) == ("tree_bwd_tf32", f"tree_attention_bwd_{which}_tf32")
    assert (lib2, fn2) == ("tree_bwd", f"tree_attention_bwd_{which}")
    assert len(mine) + 1 == len(cuda_lib.ENTRY_POINTS[lib][fn])  # + the stream
    assert [x for i, x in enumerate(mine) if i not in range(outputs.start, outputs.stop)] == \
           [x for i, x in enumerate(theirs) if i not in range(outputs.start, outputs.stop)]
    assert list(mine[outputs]) == [t.data_ptr() for t in got]
    assert mine[-1] == ta.DTYPE_CODES[torch.float32] and mine[-11:-7] == (2, 3, 9, 32)
    if which == "dq":
        assert got[0].shape == q.shape and got[0].dtype == torch.float32
        assert got[1].shape == (ta.LUT_SIZE, 3) and not got[1].any() and got[2].shape == (2, 3, 9)
    else:
        assert got[0].shape == k.shape and got[1].dtype == torch.float32


# each fault of the pair's inputs, the kernel it reaches, and the words of
# its error
TF32_FAULTS = {
    "bfloat16": ("dq", "3xTF32"), "bfloat16_dkv": ("dkv", "3xTF32"), "lse_dtype": ("dq", "lse"),
    "delta_shape": ("dkv", "delta"), "misaligned_q": ("dq", "aligned"), "misaligned_g": ("dkv", "aligned"),
    "misaligned_out": ("dq", "aligned"), "misaligned_v": ("dkv", "aligned"), "cpu_dq": ("dq", "runs on cuda"),
    "cpu_dkv": ("dkv", "runs on cuda"),
}


@pytest.mark.parametrize("fault", list(TF32_FAULTS))
def test_tf32_pair_input_checks(monkeypatch, fault):
    """What ``tree_attention_bwd_dq_tf32`` and ``_dkv_tf32`` refuse:
    anything but float32, a malformed LSE or delta, q, v, g or out off a
    16-byte boundary, and tensors off the card. They raise before any
    build."""

    def no_build():
        raise AssertionError("an input check must raise before the build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    monkeypatch.setattr(cuda_lib, "load_library", no_build)
    which, words = TF32_FAULTS[fault]
    dt = torch.bfloat16 if fault.startswith("bfloat16") else torch.float32
    q, k, v, template, ids, lut = _cpu_inputs(8, 2, 2, 9, 64, dt)
    g, out = torch.randn(q.shape).to(dt), torch.randn(q.shape).to(dt)
    lse, delta = torch.randn(2, 2, 9), torch.randn(2, 2, 9)
    if fault == "lse_dtype":
        lse = lse.double()
    if fault == "delta_shape":
        delta = delta[..., :8].contiguous()
    tensors = {"q": q, "v": v, "g": g, "out": out}
    if fault.startswith("misaligned"):
        name = fault.split("_")[-1]
        tensors[name] = _misaligned(tensors[name])
    q, v, g, out = (tensors[n] for n in ("q", "v", "g", "out"))
    with pytest.raises(ValueError, match=words):
        if which == "dq":
            ta.tree_attention_bwd_dq_tf32(q, k, v, out, g, template, ids, lut, lse, 0.125, True, 0.3, 1)
        else:
            ta.tree_attention_bwd_dkv_tf32(q, k, v, g, template, ids, lut, lse, delta, 0.125, True, 0.3, 1)


@pytest.mark.parametrize("dh", [16, 64])
def test_cpu_path_never_builds_the_tf32_backward(monkeypatch, dh):
    """float32 on the CPU: the plain version and autograd, no build and no
    launch, although the card would take the 3xTF32 pair."""

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    monkeypatch.setattr(cuda_lib, "load_library", no_build)
    before = [fn.launches for fn in ta.KERNELS]
    q, k, v, template, ids, lut = _cpu_inputs(9, 1, 2, 17, dh)
    q, k, v, lut = (x.requires_grad_(True) for x in (q, k, v, lut))
    ta.tree_attention(q, k, v, template, ids, lut, rate=0.2, seed=3).sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v, lut))
    assert [fn.launches for fn in ta.KERNELS] == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(seed, b, h, s, dh, **kw):
    """The inputs on the card in float32, and a cotangent."""
    q, k, v, template, ids, lut = (torch.from_numpy(a).cuda() for a in _inputs(seed, b, h, s, dh, **kw))
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    return q, k, v, template, ids, lut, g


def forward_and_grads(fn, q, k, v, template, ids, lut, g, **kw):
    """fn's output and its gradients (dq, dk, dv, dlut) for the cotangent g."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v, lut)]
    out = fn(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], **kw)
    out.backward(g)
    return [out.detach()] + [x.grad for x in leaves]


def _assert_close_of_max(got, want, names, floor=1e-30):
    for name, a, w in zip(names, got, want):
        assert a.dtype == w.dtype == torch.float32, name
        assert torch.isfinite(a).all(), name
        err = ((a - w).abs().max() / w.abs().max().clamp_min(floor)).item()
        assert err <= F32_RTOL_OF_MAX, (name, err)


def _pair(q, k, v, template, ids, lut, g, rate, seed, tf32: bool):
    """dq, dk, dv, dlut of one backward pair from K1's LSE and output."""
    scale = q.shape[-1] ** -0.5
    out, lse = ta.tree_attention_fwd(q, k, v, template, ids, lut, scale, True, rate, seed, with_lse=True)
    dq_fn, dkv_fn = ((ta.tree_attention_bwd_dq_tf32, ta.tree_attention_bwd_dkv_tf32) if tf32
                     else (ta.tree_attention_bwd_dq, ta.tree_attention_bwd_dkv))
    dq, dlut, delta = dq_fn(q, k, v, out, g, template, ids, lut, lse, scale, True, rate, seed)
    dk, dv = dkv_fn(q, k, v, g, template, ids, lut, lse, delta, scale, True, rate, seed)
    return [dq, dk, dv, dlut]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("s", TF32_S)
def test_tf32_pair_matches_plain_on_card(s, dh, rate):
    """float32 through ``tree_attention``: K1, then the 3xTF32 pair, against
    the plain version's forward and autograd gradients on the same inputs;
    K2/K3 launch no time."""
    _card()
    b = 2 if s <= 257 else 1
    q, k, v, template, ids, lut, g = _card_inputs(s + dh, b, 4, s, dh)
    before = [fn.launches for fn in ta.KERNELS]
    got = forward_and_grads(ta.tree_attention, q, k, v, template, ids, lut, g, rate=rate, seed=2468)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(ta.KERNELS, before)] == [1, 0, 0, 0, 0, 0, 1, 1]
    want = forward_and_grads(ta.tree_attention_dropout_reference, q, k, v, template, ids, lut, g, rate=rate, seed=2468)
    _assert_close_of_max(got[:1] + got[3:4], want[:1] + want[3:4], ("out", "dv"))
    # at S = 1 dq, dk and dlut are 0 in exact arithmetic (softmax over one
    # key has no gradient): what remains is the rounding of g . v / (1 -
    # rate) - g . out, terms of the size of dv
    floor = want[3].abs().max().item() if s == 1 else 1e-30
    _assert_close_of_max(got[1:3] + got[4:], want[1:3] + want[4:], ("dq", "dk", "dlut"), floor)
    assert torch.equal(got[4][0], torch.zeros_like(got[4][0]))  # LUT row 0 gets nothing


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("s, b", [(33, 12), (129, 4), (601, 1)])
def test_tf32_pair_matches_k2_k3_on_card(s, b, dh):
    """The 3xTF32 pair against K2/K3 on the same float32 inputs, from one
    K1 LSE."""
    _card()
    q, k, v, template, ids, lut, g = _card_inputs(3 * s + dh, b, 4, s, dh)
    tf32 = _pair(q, k, v, template, ids, lut, g, 0.3, 77, tf32=True)
    k23 = _pair(q, k, v, template, ids, lut, g, 0.3, 77, tf32=False)
    _assert_close_of_max(tf32, k23, ("dq", "dk", "dv", "dlut"))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [33, 601])
def test_tf32_pair_masked_rows_and_ids_on_card(s, dh):
    """A row whose every key the template masks has p = 0: its dq is zero
    and it adds nothing to dk, dv or dlut. ids outside [0, 32) and LUT row 0
    add nothing (dq, dk and dv bit for bit; dlut up to the order of its
    atomic sums), and dlut's row 0 stays zero."""
    _card()
    q, k, v, template, ids, lut, g = _card_inputs(s + 5, 2, 4, s, dh, id_low=-40, id_high=3 * ta.LUT_SIZE)
    template[0, s // 2] = ta.MASK_BIAS  # one row fully masked, column 0 included
    got = _pair(q, k, v, template, ids, lut, g, 0.3, 9, tf32=True)
    assert torch.equal(got[0][0, :, s // 2], torch.zeros_like(got[0][0, :, s // 2]))
    assert torch.equal(got[3][0], torch.zeros_like(got[3][0]))
    want = forward_and_grads(ta.tree_attention_dropout_reference, q, k, v, template, ids, lut, g, rate=0.3, seed=9)
    _assert_close_of_max(got, want[1:], ("dq", "dk", "dv", "dlut"))
    # the masked row's g changes nothing else
    g2 = g.clone()
    g2[0, :, s // 2] = 100.0
    again = _pair(q, k, v, template, ids, lut, g2, 0.3, 9, tf32=True)
    for a, w in zip(again[:3], got[:3]):
        assert torch.equal(a, w)
    torch.testing.assert_close(again[3], got[3], rtol=1e-5, atol=1e-6)
    clean = torch.where((ids >= 0) & (ids < ta.LUT_SIZE), ids, 0).to(torch.int32).contiguous()
    dirty_lut = lut.clone()
    dirty_lut[0] = 7.0
    again = _pair(q, k, v, template, clean, dirty_lut, g, 0.3, 9, tf32=True)
    for a, w in zip(again[:3], got[:3]):
        assert torch.equal(a, w)
    torch.testing.assert_close(again[3], got[3], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s, b", [(33, 4), (257, 1), (601, 1)])
def test_tf32_pair_adjoint_identity_in_v(s, b, dh):
    """<g, f(v2)> = <vjp_v(g), v2> through K1 and the 3xTF32 pair: it holds
    only if the backward regenerates the forward's mask (relative 1e-4)."""
    _card()
    q, k, v, template, ids, lut, g = _card_inputs(s + 1, b, 12, s, dh)
    v2 = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    before = ta.tree_attention_bwd_dkv_tf32.launches
    vv = v.clone().requires_grad_(True)
    ta.tree_attention(q, k, vv, template, ids, lut, rate=0.3, seed=77).backward(g)
    assert ta.tree_attention_bwd_dkv_tf32.launches == before + 1
    lhs = (g.double() * ta.tree_attention(q, k, v2, template, ids, lut, rate=0.3, seed=77).double()).sum().item()
    rhs = (vv.grad.double() * v2.double()).sum().item()
    assert abs(lhs - rhs) <= ADJOINT_REL * max(abs(lhs), 1.0), (lhs, rhs)


def read_back_tf32_masks(b, h, s, dh, rate, seed):
    """The 3xTF32 pair's keep masks, read back with q = 0 and no bias
    (every weight 1/S), one DH-row or DH-key chunk c at a time:
    - the dk/dv kernel's, through dv: with g one-hot in rows c*DH ..
      c*DH+DH-1, dv[j, d] = keep[c*DH + d, j] / (S (1 - rate));
    - the dq kernel's, through dq: with v and g = e_0 on every row, ds_ij =
      (keep_ij / (1 - rate) - D_i) / S where D_i, the kept share over 1 -
      rate, is below 1 / (1 - rate) unless the row keeps every key, so ds >
      0 exactly where kept; with k one-hot in keys c*DH .. c*DH+DH-1,
      dq[i, d] = scale ds[i, c*DH + d]."""
    zeros = torch.zeros(b, h, s, dh, device="cuda")
    template = torch.zeros(b, s, s, device="cuda")
    ids = torch.zeros(b, s, s, dtype=torch.int32, device="cuda")
    lut = torch.zeros(ta.LUT_SIZE, h, device="cuda")
    e0 = zeros.clone()
    e0[..., 0] = 1.0
    by_dv, by_dq = [], []
    for c in range(-(-s // dh)):
        onehot = torch.zeros(s + dh, dh, device="cuda")
        onehot[c * dh : (c + 1) * dh] = torch.eye(dh, device="cuda")
        onehot = onehot[:s].expand(b, h, s, dh).contiguous()
        v = zeros.clone().requires_grad_(True)
        ta.tree_attention(zeros, zeros, v, template, ids, lut, rate=rate, seed=seed).backward(onehot)
        by_dv.append(v.grad.transpose(-1, -2) != 0)
        q = zeros.clone().requires_grad_(True)
        ta.tree_attention(q, onehot, e0, template, ids, lut, rate=rate, seed=seed).backward(e0)
        by_dq.append(q.grad > 0)
    return torch.cat(by_dv, dim=-2)[..., :s, :], torch.cat(by_dq, dim=-1)[..., :s]


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [33, 601])
def test_tf32_pair_mask_is_the_plain_philox(s, dh):
    """Both kernels of the 3xTF32 pair regenerate the plain Philox mask bit
    for bit, read back through dv (the dk/dv kernel) and dq (the dq kernel)
    over several row and key chunks."""
    _card()
    b, h, rate = 1, 3, 0.3
    before = [fn.launches for fn in ta.KERNELS]
    by_dv, by_dq = read_back_tf32_masks(b, h, s, dh, rate, 99)
    chunks = -(-s // dh)
    assert [fn.launches - n for fn, n in zip(ta.KERNELS, before)] == [2 * chunks * d for d in (1, 0, 0, 0, 0, 0, 1, 1)]
    want = ta.dropout_keep_mask(99, b, h, s, rate, "cuda")
    assert torch.equal(by_dv, want)
    assert torch.equal(by_dq, want)
    assert abs(want.float().mean().item() - (1 - rate)) < 0.05
