"""The float32 tower backward pair (``masked_attention_bwd_dq_tf32``,
``masked_attention_bwd_dkv_tf32``) and the float32 dense-bias forward
(``biased_attention_fwd_tf32``) on tensor cores in 3xTF32, on the CPU: the
routes to them, their wrappers' contract and build tables, and their
arithmetic, emulated in torch, against the JAX package.

The kernels run only on the card (``test_torch_tf32_tower_bwd_dense_fwd_card.py``
holds them against their plain versions there). Here the kernel wrappers
are stood in for, or reached with the launch itself stood in for, and the
precision argument is checked before any card: the torch emulation of the
3xTF32 products of ``test_torch_forward_tf32.py`` (each float32 operand
split into two TF32 parts, the small x small term dropped) computes

- the tower backward as the pair forms it (the forward's row statistics,
  s recomputed with the product first and the clamped key bias after,
  D = g . out, dS, then dQ, dK and dV), against ``jax.vjp`` of the JAX
  package's ``masked_attention`` at rate 0, capacity-padding rows and S =
  300 included (on the CPU it dispatches to its XLA reference; one case
  runs its Pallas forward and backward in interpret mode, without a
  capacity-padding row, which its 8-padded S spreads otherwise);
- the dense-bias forward against the JAX ``_fused_kernel`` in interpret
  mode (``_biased_attention_fused``) at S = 17 and 33, per-head,
  head-shared and no bias, with -inf entries and key padding;

each within 1e-4 of max |ref|, the float32 route's tolerance.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.ops import masked_attention as jma
from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
from test_torch_biased_attention_card import make_inputs, to_torch
from test_torch_forward_tf32 import TOWER_CALLS, _stub_tower, _tower_inputs, emulated_forward, matmul_3xtf32
from test_torch_tree_attention_bwd_tf32 import _misaligned

jba = importlib.import_module("multimodaldiscussiontransformer_tpu.ops.biased_attention")
ba = importlib.import_module("multimodaldiscussiontransformer_tpu_torch.ops.biased_attention")

torch.set_num_threads(2)

F32_RTOL_OF_MAX = 1e-4

# (op, dtype, DH, S, route): the tower's route takes S into account, the
# dense-bias op's does not
ROUTE_CASES = [
    ("tower", torch.float32, 16, 104, "tf32"), ("tower", torch.float32, 32, 36, "tf32"),
    ("tower", torch.float32, 64, 104, "tf32"), ("tower", torch.float32, 128, 17, "tf32"),
    ("tower", torch.float32, 64, 300, "tf32"), ("tower", torch.bfloat16, 64, 104, "tensor_core"),
    ("tower", torch.bfloat16, 64, 300, "tensor_core_tiled"), ("tower", torch.bfloat16, 16, 104, "tensor_core_tiled"),
    ("dense", torch.float32, 16, 33, "tf32"), ("dense", torch.float32, 32, 129, "tf32"),
    ("dense", torch.float32, 64, 33, "tf32"), ("dense", torch.float32, 128, 601, "tf32"),
    ("dense", torch.bfloat16, 64, 33, "tensor_core"), ("dense", torch.bfloat16, 16, 33, "cuda_core"),
    ("dense", torch.bfloat16, 32, 129, "cuda_core"), ("dense", torch.bfloat16, 128, 33, "cuda_core"),
]
DENSE_CALLS = {"tf32": "fwd_tf32", "tensor_core": "fwd_fused", "cuda_core": "fwd"}


def _stub_dense(monkeypatch, calls, seen):
    """Stand-ins on CPU tensors for the dense-bias forwards ``routed_forward``
    picks: each records its name in ``calls`` and (q, k, v) in ``seen``."""

    def fwd(name):
        def run(q, k, v, bias, key_padding_mask, scale):
            calls.append(name)
            seen.append((q, k, v))
            return ba.biased_attention_reference(q, k, v, bias, key_padding_mask, scale)
        return run

    for route, name in DENSE_CALLS.items():
        monkeypatch.setitem(ba.FORWARDS, route, fwd(name))


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op, dtype, dh, s, route", ROUTE_CASES)
def test_float32_routes_to_the_tf32_kernels(monkeypatch, op, dtype, dh, s, route):
    """float32 takes the 3xTF32 tower forward and pair at every DH and S,
    and the 3xTF32 dense-bias forward at every DH; bf16 the tensor-core or
    the CUDA-core kernels as before."""
    calls, seen = [], []
    if op == "tower":
        assert ma.kernel_route(dtype, dh, s) == route
        _stub_tower(monkeypatch, calls, seen)
        q, k, v, bias = (torch.from_numpy(x) for x in _tower_inputs(4, 1, 2, s, dh))
        q, k, v = (x.to(dtype).requires_grad_(True) for x in (q, k, v))
        ma.MaskedAttention.apply(q, k, v, bias, 3, 0.2, dh ** -0.5).float().sum().backward()
        assert calls == TOWER_CALLS[route]
    else:
        assert ba.kernel_route(dtype, dh) == route
        _stub_dense(monkeypatch, calls, seen)
        q, k, v, bias, mask = to_torch(make_inputs(5, 1, 2, s, dh), dtype=dtype)
        ba.routed_forward(q, k, v, bias, mask, dh ** -0.5)
        assert calls == [DENSE_CALLS[route]]


@pytest.mark.parametrize("op", ["tower", "dense"])
def test_misaligned_views_reach_the_tf32_kernels_as_aligned_copies(monkeypatch, op):
    """A cotangent and an output off a 16-byte boundary reach the 3xTF32
    tower pair as aligned copies of the same values; q, k and v off it reach
    the 3xTF32 dense-bias forward so."""
    calls, seen = [], []
    if op == "tower":
        q, k, v, bias = (torch.from_numpy(x) for x in _tower_inputs(6, 1, 2, 9, 16))
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(6))
        out_view = _misaligned(ma.masked_attention_reference(q, k, v, bias))
        got = {}

        def fwd(q_, k_, v_, key_bias, scale, rate, seed, with_stats):
            return out_view, torch.zeros((2,) + q_.shape[:3])

        def dq(q_, k_, v_, out, g_, key_bias, stats, scale, rate, seed):
            got["dq"] = (out, g_)
            return torch.zeros_like(q_), torch.zeros(q_.shape[:3])

        def dkv(q_, k_, v_, g_, key_bias, stats, delta, scale, rate, seed):
            got["dkv"] = (None, g_)
            return torch.zeros_like(k_), torch.zeros_like(v_)

        for name, fn in (("masked_attention_fwd_tf32", fwd), ("masked_attention_bwd_dq_tf32", dq),
                         ("masked_attention_bwd_dkv_tf32", dkv)):
            monkeypatch.setattr(ma, name, fn)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ma.MaskedAttention.apply(*leaves, bias, 5, 0.3, 0.25).backward(_misaligned(g))
        for name, (out, g_) in got.items():
            for t, want in ((out, out_view), (g_, g)):
                if t is not None:
                    assert t.data_ptr() % 16 == 0 and t.is_contiguous() and torch.equal(t, want), name
    else:
        _stub_dense(monkeypatch, calls, seen)
        q, k, v, bias, mask = to_torch(make_inputs(7, 1, 2, 9, 16))
        ba.routed_forward(*(_misaligned(x) for x in (q, k, v)), bias, mask, 0.25)
        assert calls == ["fwd_tf32"]
        for t, want in zip(seen[0], (q, k, v)):
            assert t.data_ptr() % 16 == 0 and t.is_contiguous() and torch.equal(t, want)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _tower_args(seed, which):
    """The arguments of the tower pair's ``which`` kernel (dq or dkv) on
    CPU tensors at DH 32."""
    q, k, v, bias = (torch.from_numpy(x) for x in _tower_inputs(seed, 2, 3, 9, 32))
    out, g = torch.randn(q.shape), torch.randn(q.shape)
    stats, delta = torch.zeros(2, 2, 3, 9), torch.zeros(2, 3, 9)
    if which == "dq":
        return (q, k, v, out, g, bias, stats, 32 ** -0.5, 0.3, 11)
    return (q, k, v, g, bias, stats, delta, 32 ** -0.5, 0.3, 11)


@pytest.mark.parametrize("which", ["dq", "dkv", "dense"])
def test_tf32_kernels_pass_the_cuda_core_arguments(monkeypatch, which):
    """Each wrapper launches its library's C function with the arguments
    the other route's kernel passes (the tower's tiled tensor-core pair, the
    dense-bias op's CUDA-core forward), in its order (the outputs it
    allocates aside), and counts one launch. The device check is stood in
    for, so that CPU tensors reach the launch."""
    launched = []
    monkeypatch.setattr(cuda_lib, "launch", lambda lib, fn, dev, *args: launched.append((lib, fn, args)))
    if which == "dense":
        monkeypatch.setattr(ba, "_check_tensor_core_inputs", lambda *a, **kw: None)
        q, k, v, bias, mask = to_torch(make_inputs(8, 2, 3, 9, 32))
        args = (q, k, v, bias, mask, 32 ** -0.5)
        wrapper, old, outputs = ba.biased_attention_fwd_tf32, ba.biased_attention_fwd, (5,)
        names = ("biased_fwd_tf32", "biased_attention_fwd_tf32"), ("biased_fwd", "biased_attention_fwd")
    else:
        monkeypatch.setattr(ma, "_check_tensor_core_inputs", lambda *a, **kw: None)
        args = _tower_args(9, which)
        wrapper = getattr(ma, f"masked_attention_bwd_{which}_tf32")
        old, outputs = getattr(ma, f"masked_attention_bwd_{which}_tiled"), (7, 8)
        names = (("masked_bwd_tf32", f"masked_attention_bwd_{which}_tf32"),
                 ("masked_bwd_tiled", f"masked_attention_bwd_{which}_tiled"))
    before, before_old = wrapper.launches, old.launches
    got = wrapper(*args)
    old(*args)
    assert wrapper.launches == before + 1 and old.launches == before_old + 1
    (lib_t, fn_t, mine), (lib_o, fn_o, theirs) = launched
    assert ((lib_t, fn_t), (lib_o, fn_o)) == names
    assert len(mine) + 1 == len(cuda_lib.ENTRY_POINTS[lib_t][fn_t])  # + the stream
    assert [x for i, x in enumerate(mine) if i not in outputs] == [x for i, x in enumerate(theirs) if i not in outputs]
    got = (got,) if which == "dense" else got
    assert [mine[i] for i in outputs] == [t.data_ptr() for t in got]
    assert got[0].shape == args[0].shape and got[0].dtype == torch.float32


# each fault of the new kernels' inputs: (kernel, the words of its error)
TF32_FAULTS = {
    "dq_bfloat16": ("dq", "3xTF32"), "dq_misaligned_g": ("dq", "aligned"), "dq_misaligned_out": ("dq", "aligned"),
    "dq_stats_shape": ("dq", "stats"), "dq_cpu": ("dq", "runs on cuda"),
    "dkv_bfloat16": ("dkv", "3xTF32"), "dkv_misaligned_g": ("dkv", "aligned"), "dkv_delta_shape": ("dkv", "delta"),
    "dkv_cpu": ("dkv", "runs on cuda"),
    "dense_bfloat16": ("dense", "3xTF32"), "dense_misaligned_q": ("dense", "aligned"),
    "dense_misaligned_v": ("dense", "aligned"), "dense_bias_shape": ("dense", "bias must"),
    "dense_cpu": ("dense", "runs on cuda"),
}


@pytest.mark.parametrize("fault", list(TF32_FAULTS))
def test_tf32_kernel_input_checks(monkeypatch, fault):
    """What the new wrappers refuse: anything but float32 q, a tensor they
    copy in 16-byte pieces off a 16-byte boundary, malformed statistics,
    delta or bias, and tensors off the card. They raise before any build."""

    def no_build():
        raise AssertionError("an input check must raise before the build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    monkeypatch.setattr(cuda_lib, "load_library", no_build)
    which, words = TF32_FAULTS[fault]
    if which == "dense":
        dt = torch.bfloat16 if fault.endswith("bfloat16") else torch.float32
        q, k, v, bias, mask = to_torch(make_inputs(10, 2, 2, 9, 64), dtype=dt)
        if fault.endswith("bias_shape"):
            bias = bias[:, :, :8].contiguous()
        if fault.endswith("_q"):
            q = _misaligned(q)
        if fault.endswith("_v"):
            v = _misaligned(v)
        with pytest.raises(ValueError, match=words):
            ba.biased_attention_fwd_tf32(q, k, v, bias, mask, 0.125)
        return
    args = list(_tower_args(11, which))
    names = ["q", "k", "v", "out", "g", "bias", "stats"] if which == "dq" else ["q", "k", "v", "g", "bias", "stats", "delta"]
    if fault.endswith("bfloat16"):
        for n in ("q", "k", "v", "out", "g"):
            if n in names:
                args[names.index(n)] = args[names.index(n)].to(torch.bfloat16)
    if "misaligned" in fault:
        n = fault.split("_")[-1]
        args[names.index(n)] = _misaligned(args[names.index(n)])
    if fault.endswith("stats_shape"):
        args[names.index("stats")] = args[names.index("stats")][:, :, :, :-1].contiguous()
    if fault.endswith("delta_shape"):
        args[names.index("delta")] = args[names.index("delta")][:, :, :-1].contiguous()
    with pytest.raises(ValueError, match=words):
        getattr(ma, f"masked_attention_bwd_{which}_tf32")(*args)


def test_build_tables_name_the_new_libraries():
    """``ops/cuda_lib.py`` builds the 3xTF32 tower pair and the 3xTF32
    dense-bias forward each as a library of its own in the one parallel
    nvcc pass, whose C functions take the arguments of the other route's
    kernels (the tiled tensor-core tower pair, the CUDA-core dense forward); both
    take their helpers from the shared 3xTF32 header, and their wrappers
    count launches."""
    tables = (("masked_bwd_tf32", "masked_attention_bwd_tf32", "masked_bwd_tiled",
               {"masked_attention_bwd_dq_tf32": "masked_attention_bwd_dq_tiled",
                "masked_attention_bwd_dkv_tf32": "masked_attention_bwd_dkv_tiled"}),
              ("biased_fwd_tf32", "biased_attention_fwd_tf32", "biased_fwd",
               {"biased_attention_fwd_tf32": "biased_attention_fwd"}))
    for lib, source, old_lib, functions in tables:
        assert cuda_lib.SOURCES[lib] == cuda_lib.CSRC / f"{source}.cu" and cuda_lib.SOURCES[lib].is_file()
        assert cuda_lib.ENTRY_POINTS[lib] == {fn: cuda_lib.ENTRY_POINTS[old_lib][old] for fn, old in functions.items()}
        assert cuda_lib.ERROR_STRINGS[lib] == f"{source}_error_string"
        text = cuda_lib.SOURCES[lib].read_text()
        assert '#include "tf32_common.cuh"' in text and "cvt.rna.tf32" not in text
        assert all(f'extern "C" int {fn}(' in text for fn in functions)
        assert lib in cuda_lib.library_paths()
    assert ma.masked_attention_bwd_dq_tf32 in ma.KERNELS and ma.masked_attention_bwd_dkv_tf32 in ma.KERNELS
    assert ba.KERNELS[-1] is ba.biased_attention_fwd_tf32 and ba.FORWARDS["tf32"] is ba.biased_attention_fwd_tf32


def test_cpu_path_never_builds_or_counts_the_tf32_kernels(monkeypatch):
    """float32 on the CPU: the plain versions and autograd (the dense-bias
    op's torch backward), no build and no launch, although the card would
    take the 3xTF32 pair and dense-bias forward."""

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    monkeypatch.setattr(cuda_lib, "load_library", no_build)
    before = [fn.launches for fn in ma.KERNELS + ba.KERNELS]
    q, k, v, bias = (torch.from_numpy(x) for x in _tower_inputs(12, 2, 2, 17, 16))
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    ma.masked_attention(*leaves, bias, rate=0.2, seed=3).sum().backward()
    q2, k2, v2, dense, mask = to_torch(make_inputs(13, 2, 2, 17, 16))
    leaves2 = [x.requires_grad_(True) for x in (q2, k2, v2, dense)]
    ba.biased_attention(*leaves2, mask).sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in leaves + leaves2)
    assert [fn.launches for fn in ma.KERNELS + ba.KERNELS] == before


# ---------------------------------------------------------------------------
# the 3xTF32 arithmetic, emulated, against the JAX package
# ---------------------------------------------------------------------------


def emulated_tower_backward(q, k, v, bias, g, scale):
    """out, dq, dk, dv at rate 0 as the 3xTF32 tower forward and pair form
    them: the forward's row max m and log-sum log l (q scaled in f32, the
    clamped key bias after the product), then s = scale (Q K^T) + bias
    recomputed, p = exp((s - m) - log l), D = g . out, dS = p (G V^T - D),
    dQ = scale dS K, dK = scale dS^T Q, dV = P^T G, every product in 3xTF32."""
    kb = bias.clamp_min(ma.MASK_BIAS)[:, None, None, :]
    s_fwd = matmul_3xtf32(q * scale, k.transpose(-1, -2)) + kb
    m = s_fwd.amax(-1, keepdim=True).clamp_min(ma.MASK_BIAS)
    e = torch.exp(s_fwd - m)
    denom = e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = matmul_3xtf32(e, v) / denom
    s = matmul_3xtf32(q, k.transpose(-1, -2)) * scale + kb
    p = torch.exp((s - m) - torch.log(denom))
    d = (g * out).sum(-1, keepdim=True)
    ds = p * (matmul_3xtf32(g, v.transpose(-1, -2)) - d)
    dq = matmul_3xtf32(ds, k) * scale
    dk = matmul_3xtf32(ds.transpose(-1, -2), q) * scale
    dv = matmul_3xtf32(p.transpose(-1, -2), g)
    return out, dq, dk, dv


def _assert_within_of_max(got, want, name):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert np.isfinite(got).all() and err <= F32_RTOL_OF_MAX, (name, err)


@pytest.mark.parametrize("s, dh, kernel", [(33, 16, True), (104, 64, False), (300, 16, False)])
def test_emulated_3xtf32_tower_backward_matches_jax(monkeypatch, s, dh, kernel):
    """The pair's 3xTF32 arithmetic on the CPU against ``jax.vjp`` of the
    JAX package's ``masked_attention`` at rate 0: its Pallas forward and
    backward in interpret mode at S = 33 (the capacity-padding row left
    out), its XLA route at S = 104 and 300 (a capacity-padding row
    included: equal weights over its keys in both)."""
    q, k, v, bias = _tower_inputs(60 + s + dh, 3, 2, s, dh)
    if kernel:
        monkeypatch.setattr(jma, "FORCE_KERNEL", True)
        q, k, v, bias = (x[:-1] for x in (q, k, v, bias))
    g = np.random.default_rng(s).standard_normal(q.shape).astype(np.float32)
    def run(q_, k_, v_, g_):  # one jit: the eager vjp compiles op by op
        out, vjp = jax.vjp(lambda *a: jma.masked_attention(*a, jnp.asarray(bias)), q_, k_, v_)
        return (out, *vjp(g_))

    want = jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, g)))
    got = emulated_tower_backward(*(torch.from_numpy(x) for x in (q, k, v, bias, g)), dh ** -0.5)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        _assert_within_of_max(a.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("kind", ["head", "shared", "none"])
@pytest.mark.parametrize("s", [17, 33])
def test_emulated_3xtf32_dense_forward_matches_jax_kernel(s, kind):
    """The dense-bias forward's 3xTF32 arithmetic (q scaled in f32, S = Q
    K^T and O = P V in 3xTF32, the combined bias max(bias + pad, -1e9)
    folded after the product) on the CPU against the JAX ``_fused_kernel``
    in interpret mode: per-head, head-shared and no bias, ~15% of it -inf,
    ~20% of the keys padded (never key 0: no row is fully masked)."""
    dh = 16
    q, k, v, bias, mask = make_inputs(70 + s, 2, 3, s, dh, kind)
    want = jba._biased_attention_fused(*(jnp.asarray(x) for x in (q, k, v)),
                                       None if bias is None else jnp.asarray(bias), jnp.asarray(mask), dh ** -0.5)
    tq, tk, tv, tbias, tmask = to_torch((q, k, v, bias, mask))
    got = emulated_forward(tq, tk, tv, ba.combined_bias(tq, tbias, tmask), dh ** -0.5)
    _assert_within_of_max(got.numpy(), np.asarray(want), "out")
