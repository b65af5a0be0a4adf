"""The float32 forwards on tensor cores in 3xTF32 (the tree attention's
``tree_attention_fwd_tf32``, the tower attention's
``masked_attention_fwd_tf32``), on the CPU: the routes to them, their
wrappers' contract and build tables, and their arithmetic, emulated in
torch, against the JAX package's references.

The kernels run only on the card (``test_torch_forward_tf32_card.py``
holds them against their plain versions there). Here the kernel wrappers
are stood in for, or reached with the launch itself stood in for, and the
precision argument is checked before any card: a torch emulation of the
3xTF32 products (each float32 operand split into two TF32 parts, rounded
to a 10-bit mantissa to nearest with ties away from zero as
``cvt.rna.tf32.f32`` rounds; the small x small term dropped) computes
both forwards and stays within 1e-4 of max |ref| of the JAX package's
reference, the float32 route's tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.ops import masked_attention as jma
from multimodaldiscussiontransformer_tpu.ops import tree_attention as jta
from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from test_torch_tree_attention_bwd_tf32 import _cpu_inputs, _misaligned

torch.set_num_threads(2)

F32_RTOL_OF_MAX = 1e-4

TREE_ROUTES = [
    (torch.float32, 16, "tf32"), (torch.float32, 32, "tf32"), (torch.float32, 64, "tf32"),
    (torch.float32, 128, "tf32"),
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 16, "tensor_core"), (torch.bfloat16, 32, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"),
]
TREE_FORWARD = {"tf32": "fwd_tf32", "tensor_core": "fwd_fused"}
TOWER_ROUTES = [
    (torch.float32, 16, 104, "tf32"), (torch.float32, 32, 104, "tf32"), (torch.float32, 64, 104, "tf32"),
    (torch.float32, 128, 104, "tf32"), (torch.float32, 64, 300, "tf32"),
    (torch.bfloat16, 64, 104, "tensor_core"), (torch.bfloat16, 64, 300, "tensor_core_tiled"),
    (torch.bfloat16, 32, 104, "tensor_core_tiled"),
]
TOWER_CALLS = {"tf32": ["fwd_tf32", "dq_tf32", "dkv_tf32"], "tensor_core": ["fwd_fused", "bwd_fused"],
               "tensor_core_tiled": ["fwd_tiled", "dq_tiled", "dkv_tiled"]}


def _tower_inputs(seed, b, h, s, dh):
    """numpy (q, k, v, key bias): ~30% of each row's keys padded (key 0
    never), the last row a capacity-padding row."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    bias = np.where(rng.random((b, s)) < 0.3, ta.MASK_BIAS, 0.0).astype(np.float32)
    bias[:, 0] = 0.0
    bias[-1] = ta.MASK_BIAS
    return q, k, v, bias


def _stub_tree(monkeypatch, calls, seen):
    """Stand-ins on CPU tensors for every tree kernel wrapper: each records
    its name in ``calls``, the forwards also (name, q, k, v) in ``seen``."""

    def fwd(name):
        def run(q, k, v, template, ids, lut, scale, double_add, rate, seed, with_lse):
            calls.append(name)
            seen.append((name, q, k, v))
            out = ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, seed, rate, scale, double_add)
            return out, torch.zeros(q.shape[:3]) if with_lse else None
        return run

    def dq(name):
        def run(q, k, v, out, g, template, ids, lut, lse, scale, double_add, rate, seed):
            calls.append(name)
            return torch.zeros_like(q), torch.zeros_like(lut), torch.zeros(q.shape[:3])
        return run

    def dkv(name):
        def run(q, k, v, g, template, ids, lut, lse, delta, scale, double_add, rate, seed):
            calls.append(name)
            return torch.zeros_like(k), torch.zeros_like(v)
        return run

    for name, fn in (("tree_attention_fwd_fused", fwd("fwd_fused")), ("tree_attention_fwd_tf32", fwd("fwd_tf32")),
                     ("tree_attention_bwd_dq_fused", dq("dq_fused")),
                     ("tree_attention_bwd_dkv_fused", dkv("dkv_fused")), ("tree_attention_bwd_dq_tf32", dq("dq_tf32")),
                     ("tree_attention_bwd_dkv_tf32", dkv("dkv_tf32"))):
        monkeypatch.setattr(ta, name, fn)


def _stub_tower(monkeypatch, calls, seen):
    """Stand-ins on CPU tensors for every tower kernel wrapper, recording as
    ``_stub_tree`` does."""

    def fwd(name):
        def run(q, k, v, key_bias, scale, rate, seed, with_stats):
            calls.append(name)
            seen.append((name, q, k, v))
            out = ma.masked_attention_dropout_reference(q, k, v, key_bias, seed, rate, scale)
            return out, torch.zeros((2,) + q.shape[:3]) if with_stats else None
        return run

    def bwd_fused(q, k, v, out, g, key_bias, stats, scale, rate, seed):
        calls.append("bwd_fused")
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def dq(name):
        def run(q, k, v, out, g, key_bias, stats, scale, rate, seed):
            calls.append(name)
            return torch.zeros_like(q), torch.zeros(q.shape[:3])
        return run

    def dkv(name):
        def run(q, k, v, g, key_bias, stats, delta, scale, rate, seed):
            calls.append(name)
            return torch.zeros_like(k), torch.zeros_like(v)
        return run

    for name, fn in (("masked_attention_fwd_tiled", fwd("fwd_tiled")), ("masked_attention_fwd_fused", fwd("fwd_fused")),
                     ("masked_attention_fwd_tf32", fwd("fwd_tf32")), ("masked_attention_bwd_fused", bwd_fused),
                     ("masked_attention_bwd_dq_tiled", dq("dq_tiled")), ("masked_attention_bwd_dkv_tiled", dkv("dkv_tiled")),
                     ("masked_attention_bwd_dq_tf32", dq("dq_tf32")), ("masked_attention_bwd_dkv_tf32", dkv("dkv_tf32"))):
        monkeypatch.setattr(ma, name, fn)


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, dh, route", TREE_ROUTES)
def test_tree_route_sends_float32_to_the_tf32_forward(monkeypatch, dtype, dh, route):
    """float32 at every DH takes the 3xTF32 forward (then the 3xTF32 pair);
    bf16 the tensor-core forward (then the tensor-core pair) at every DH."""
    assert ta.kernel_route(dtype, dh) == route
    calls, seen = [], []
    _stub_tree(monkeypatch, calls, seen)
    q, k, v, template, ids, lut = _cpu_inputs(3, 1, 2, 9, dh, dtype)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    ta.TreeAttention.apply(q, k, v, template, ids, lut, 5, 0.2, dh ** -0.5, True).float().sum().backward()
    pair = {"tf32": ["dq_tf32", "dkv_tf32"], "tensor_core": ["dq_fused", "dkv_fused"]}
    assert calls == [TREE_FORWARD[route]] + pair[route]


@pytest.mark.parametrize("dtype, dh, s, route", TOWER_ROUTES)
def test_tower_route_sends_float32_to_the_tf32_forward(monkeypatch, dtype, dh, s, route):
    """float32 at every DH and S takes the 3xTF32 forward, then the 3xTF32
    pair; bf16 the one-pass tensor-core kernels or the tiled tensor-core
    forward and pair."""
    assert ma.kernel_route(dtype, dh, s) == route
    calls, seen = [], []
    _stub_tower(monkeypatch, calls, seen)
    q, k, v, bias = (torch.from_numpy(x) for x in _tower_inputs(4, 1, 2, s, dh))
    q, k, v = (x.to(dtype).requires_grad_(True) for x in (q, k, v))
    ma.MaskedAttention.apply(q, k, v, bias, 3, 0.2, dh ** -0.5).float().sum().backward()
    assert calls == TOWER_CALLS[route]


@pytest.mark.parametrize("op", ["tree", "tower", "ring"])
def test_misaligned_views_reach_the_tf32_forward_as_aligned_copies(monkeypatch, op):
    """q, k and v off a 16-byte boundary reach the 3xTF32 forward as 16-byte
    aligned copies of the same values (the ring's tile forward too)."""
    from multimodaldiscussiontransformer_tpu_torch.ops import ring_attention as ra

    calls, seen = [], []
    q, k, v, template, ids, lut = _cpu_inputs(5, 1, 2, 9, 16)
    views = [_misaligned(x) for x in (q, k, v)]
    if op == "tree":
        _stub_tree(monkeypatch, calls, seen)
        ta.TreeAttention.apply(*views, template, ids, lut, 5, 0.3, 0.25, True)
    elif op == "tower":
        _stub_tower(monkeypatch, calls, seen)
        ma.MaskedAttention.apply(*views, None, 5, 0.3, 0.25)
    else:
        _stub_tree(monkeypatch, calls, seen)
        def tile_forward(*args):  # the tile forward ``tile_ops`` gives the "tf32" route on the card
            return ta.tree_attention_fwd_tf32(*args, with_lse=True)

        monkeypatch.setattr(ra, "tile_ops", lambda q_: (tile_forward, None, None))
        monkeypatch.setattr(ra.dist, "get_world_size", lambda group: 1)
        monkeypatch.setattr(ra.dist, "get_rank", lambda group: 0)
        ra.RingTreeAttention.apply(*views, template, ids, lut, None, 5, 0.0, 0.25, True, 0)
    assert calls[0] == "fwd_tf32"
    for got, want in zip(seen[0][1:], (q, k, v)):
        assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["tree", "tower"])
def test_tf32_forward_passes_the_replaced_kernels_arguments(monkeypatch, op):
    """Each wrapper launches its library's C function with the arguments
    the other route's forward passes (the tree's tensor-core forward, the
    tower's tiled tensor-core forward), in its order (the outputs it allocates
    aside), and counts one launch. The device check is stood in for, so
    that CPU tensors reach the launch."""
    launched = []
    monkeypatch.setattr(cuda_lib, "launch", lambda lib, fn, dev, *args: launched.append((lib, fn, args)))
    if op == "tree":
        monkeypatch.setattr(ta, "_check_tensor_core_inputs", lambda *a, **kw: None)
        q, k, v, template, ids, lut = _cpu_inputs(6, 2, 3, 9, 32)
        args = (q, k, v, template, ids, lut, 32 ** -0.5, True, 0.3, 11, True)
        wrapper, old, outputs = ta.tree_attention_fwd_tf32, ta.tree_attention_fwd_fused, (6, 7)
        names = ("tree_fwd_tf32", "tree_attention_fwd_tf32"), ("tree_fwd_mma", "tree_attention_fwd_mma")
    else:
        monkeypatch.setattr(ma, "_check_tensor_core_inputs", lambda *a, **kw: None)
        q, k, v, bias = (torch.from_numpy(x) for x in _tower_inputs(6, 2, 3, 9, 32))
        args = (q, k, v, bias, 32 ** -0.5, 0.3, 11, True)
        wrapper, old, outputs = ma.masked_attention_fwd_tf32, ma.masked_attention_fwd_tiled, (4, 5)
        names = ("masked_fwd_tf32", "masked_attention_fwd_tf32"), ("masked_fwd_tiled", "masked_attention_fwd_tiled")
    before, before_old = wrapper.launches, old.launches
    got = wrapper(*args)
    old(*args)
    assert wrapper.launches == before + 1 and old.launches == before_old + 1
    (lib_t, fn_t, mine), (lib_o, fn_o, theirs) = launched
    assert ((lib_t, fn_t), (lib_o, fn_o)) == names
    assert len(mine) + 1 == len(cuda_lib.ENTRY_POINTS[lib_t][fn_t])  # + the stream
    assert [x for i, x in enumerate(mine) if i not in outputs] == [x for i, x in enumerate(theirs) if i not in outputs]
    assert [mine[i] for i in outputs] == [t.data_ptr() for t in got]
    assert mine[-1] == ta.DTYPE_CODES[torch.float32]
    assert got[0].shape == q.shape and got[0].dtype == torch.float32
    assert got[1].shape == ((2, 3, 9) if op == "tree" else (2, 2, 3, 9))


# each fault of the 3xTF32 forwards' inputs: (op, the words of its error)
TF32_FWD_FAULTS = {
    "tree_bfloat16": ("tree", "3xTF32"), "tree_misaligned_q": ("tree", "aligned"),
    "tree_misaligned_k": ("tree", "aligned"), "tree_misaligned_v": ("tree", "aligned"),
    "tree_ids_dtype": ("tree", "ids"), "tree_cpu": ("tree", "runs on cuda"),
    "tower_bfloat16": ("tower", "3xTF32"), "tower_misaligned_q": ("tower", "aligned"),
    "tower_misaligned_v": ("tower", "aligned"), "tower_bias_shape": ("tower", "key bias"),
    "tower_head_dim": ("tower", "head dim"), "tower_cpu": ("tower", "runs on cuda"),
}


@pytest.mark.parametrize("fault", list(TF32_FWD_FAULTS))
def test_tf32_forward_input_checks(monkeypatch, fault):
    """What the 3xTF32 forwards refuse: anything but float32, q, k or v off
    a 16-byte boundary, malformed ids or key bias, a head dim they were not
    built for, and tensors off the card. They raise before any build."""

    def no_build():
        raise AssertionError("an input check must raise before the build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    monkeypatch.setattr(cuda_lib, "load_library", no_build)
    op, words = TF32_FWD_FAULTS[fault]
    dt = torch.bfloat16 if fault.endswith("bfloat16") else torch.float32
    dh = 48 if fault.endswith("head_dim") else 64
    q, k, v, template, ids, lut = _cpu_inputs(8, 2, 2, 9, 64)
    bias = torch.from_numpy(_tower_inputs(8, 2, 2, 9, 64)[3])
    q, k, v = (x[..., :dh].to(dt).contiguous() for x in (q, k, v))
    tensors = {"q": q, "k": k, "v": v}
    if "misaligned" in fault:
        name = fault.split("_")[-1]
        tensors[name] = _misaligned(tensors[name])
    q, k, v = (tensors[n] for n in ("q", "k", "v"))
    if fault.endswith("ids_dtype"):
        ids = ids.long()
    if fault.endswith("bias_shape"):
        bias = bias[:, :-1].contiguous()
    with pytest.raises(ValueError, match=words):
        if op == "tree":
            ta.tree_attention_fwd_tf32(q, k, v, template, ids, lut, 0.125, True, 0.3, 1, with_lse=True)
        else:
            ma.masked_attention_fwd_tf32(q, k, v, bias, 0.125, 0.3, 1, with_stats=True)


@pytest.mark.parametrize("dh", [16, 64])
def test_cpu_path_never_builds_or_counts_the_tf32_forwards(monkeypatch, dh):
    """float32 on the CPU: the plain versions and autograd, no build and no
    launch, although the card would take the 3xTF32 forwards."""

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    monkeypatch.setattr(cuda_lib, "load_library", no_build)
    before = [fn.launches for fn in ta.KERNELS + ma.KERNELS]
    q, k, v, template, ids, lut = _cpu_inputs(9, 1, 2, 17, dh)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    ta.tree_attention(q, k, v, template, ids, lut, rate=0.2, seed=3).sum().backward()
    ma.masked_attention(q, k, v, None, rate=0.2, seed=3).sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    assert [fn.launches for fn in ta.KERNELS + ma.KERNELS] == before


def test_build_tables_name_the_tf32_forwards():
    """``ops/cuda_lib.py`` builds each 3xTF32 forward as its own library in
    the one parallel nvcc pass, whose C function takes the replaced
    kernel's arguments; the shared 3xTF32 header is in ``HEADERS`` (its
    change rebuilds every library), and the backward pair takes its
    helpers from it."""
    tables = (("tree_fwd_tf32", "tree_attention_fwd_tf32", "tree_fwd_mma", "tree_attention_fwd_mma"),
              ("masked_fwd_tf32", "masked_attention_fwd_tf32", "masked_fwd_tiled", "masked_attention_fwd_tiled"))
    for lib, fn, old_lib, old_fn in tables:
        assert cuda_lib.SOURCES[lib] == cuda_lib.CSRC / f"{fn}.cu" and cuda_lib.SOURCES[lib].is_file()
        assert cuda_lib.ENTRY_POINTS[lib] == {fn: cuda_lib.ENTRY_POINTS[old_lib][old_fn]}
        assert cuda_lib.ERROR_STRINGS[lib] == f"{fn}_error_string"
        assert '#include "tf32_common.cuh"' in cuda_lib.SOURCES[lib].read_text()
    header = cuda_lib.CSRC / "tf32_common.cuh"
    assert header in cuda_lib.HEADERS and header.is_file()
    bwd = cuda_lib.SOURCES["tree_bwd_tf32"].read_text()
    assert '#include "tf32_common.cuh"' in bwd and "cvt.rna.tf32" not in bwd
    assert ta.tree_attention_fwd_tf32 in ta.KERNELS and ma.masked_attention_fwd_tf32 in ma.KERNELS


# ---------------------------------------------------------------------------
# the 3xTF32 arithmetic, emulated, against the JAX package's references
# ---------------------------------------------------------------------------


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (a 10-bit mantissa) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: half of the dropped 13 bits added
    to the magnitude, then the 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with each operand split into big = tf32(x) and small =
    tf32(x - big) and the three larger cross products summed (small x small
    dropped), each product exact in float64, the sum rounded to float32."""
    a_big, b_big = to_tf32(a), to_tf32(b)
    a_small, b_small = to_tf32(a - a_big), to_tf32(b - b_big)
    terms = ((a_small, b_big), (a_big, b_small), (a_big, b_big))
    return sum(torch.matmul(x.double(), y.double()) for x, y in terms).float()


def emulated_forward(q, k, v, bias, scale):
    """The 3xTF32 forwards' function at rate 0 (q scaled in f32, S = Q K^T
    and O = P V in 3xTF32, P in f32, the row max clamped at -1e9 and the
    undropped sum at 1e-30); ``bias`` broadcasts to (B, H, S, S)."""
    s = matmul_3xtf32(q * scale, k.transpose(-1, -2)) + bias
    m = s.amax(-1, keepdim=True).clamp_min(ta.MASK_BIAS)
    p = torch.exp(s - m)
    return matmul_3xtf32(p, v) / p.sum(-1, keepdim=True).clamp_min(1e-30)


def _assert_within_of_max(got, want):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert np.isfinite(got).all() and err <= F32_RTOL_OF_MAX, err


@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [33, 129])
def test_emulated_3xtf32_tree_forward_matches_jax_reference(s, dh):
    """The tree forward's 3xTF32 arithmetic on the CPU against the JAX
    package's ``tree_attention_reference`` (rate 0, the double-added
    template, ~15% of it masked)."""
    q, k, v, template, ids, lut = _cpu_inputs(40 + s + dh, 2, 3, s, dh)
    want = np.asarray(jta.tree_attention_reference(*(jnp.asarray(x.numpy()) for x in (q, k, v, template, ids, lut)),
                                                   dh ** -0.5, True))
    got = emulated_forward(q, k, v, ta.assemble_bias(template, ids, lut, True), dh ** -0.5).numpy()
    _assert_within_of_max(got, want)


@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [33, 129])
def test_emulated_3xtf32_tower_forward_matches_jax_reference(s, dh):
    """The tower forward's 3xTF32 arithmetic on the CPU against the JAX
    package's ``masked_attention_reference`` (rate 0, a key bias with a
    capacity-padding row: equal weights over its keys in both)."""
    q, k, v, bias = _tower_inputs(50 + s + dh, 3, 2, s, dh)
    want = np.asarray(jma.masked_attention_reference(*(jnp.asarray(x) for x in (q, k, v, bias))))
    q, k, v, bias = (torch.from_numpy(x) for x in (q, k, v, bias))
    got = emulated_forward(q, k, v, bias.clamp_min(ta.MASK_BIAS)[:, None, None, :], dh ** -0.5).numpy()
    _assert_within_of_max(got, want)
