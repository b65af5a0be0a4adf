"""The float32 tower backward pair (``masked_attention_bwd_dq_tf32``,
``masked_attention_bwd_dkv_tf32``) and the float32 dense-bias forward
(``biased_attention_fwd_tf32``), 3xTF32 on tensor cores, on the card:
against their plain versions, the dense-bias forward also against the
CUDA-core kernel it replaces on the float32 route, their masks read back,
and the adjoint identity.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_tf32_tower_bwd_dense_fwd_card.py

Without a card every test skips. The routes, the wrappers' contract and the
3xTF32 arithmetic against the JAX package are held on the CPU in
``test_torch_tf32_tower_bwd_dense_fwd.py``.

Tolerances (float32 inputs, TF32 off for PyTorch's own products): out and
every gradient within 1e-4 x max|ref| of the plain version on the same
inputs, as for the float32 kernels they replace (the dense-bias forward
also within 1e-4 absolute, as the CUDA-core one was held). 3xTF32 drops the
small x small term of each product (~2^-22 of it) and the tensor cores sum
in another order than the plain version. The adjoint identity in v within
1e-4 relative. Masks read back bit for bit.
"""

import importlib

import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from test_torch_biased_attention_card import make_inputs, to_torch
from test_torch_forward_tf32_card import _tower_inputs

ba = importlib.import_module("multimodaldiscussiontransformer_tpu_torch.ops.biased_attention")

torch.set_num_threads(2)

F32_RTOL_OF_MAX = 1e-4
F32_ATOL = 1e-4
ADJOINT_REL = 1e-4

# the tower lengths (text 100 / 104, ViT 197 / 201), the ends of the range
# and the edges of the 8-key n-tiles, 16-row steps, 32-row and 32-key
# blocks, 32- and 64-key and -row tiles, and one length past 256
TOWER_S = (1, 8, 9, 16, 17, 33, 36, 63, 64, 65, 100, 104, 127, 128, 129, 197, 201, 256, 300)
# the tower shapes at H = 12, DH 64 with a smaller B: (S, B, key bias)
TOWER_SHAPES = ((100, 16, True), (104, 16, True), (201, 4, False))
# the ends of the S range, the edges of the 8-key n-tiles, 32-row blocks
# and 32- and 64-key tiles, the canonical buckets and the streaming sizes
DENSE_S = (1, 2, 17, 33, 63, 64, 65, 129, 257, 601, 1025)
# (bias kind, bias dtype)
DENSE_BIASES = [("head", torch.float32), ("head", torch.bfloat16), ("shared", torch.float32),
                ("shared", torch.bfloat16), ("none", None)]
# launches of ma.KERNELS for one float32 forward and backward: the 3xTF32
# forward, dq and dk/dv kernels
TF32_LAUNCHES = [0, 0, 1, 1, 1, 0, 0, 0]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def max_err_of_max(got, want, floor=1e-30):
    """max |got - want| over max(max |want|, floor)."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(floor)).item()


def tower_grads(fn, q, k, v, bias, g, **kw):
    """fn's output and its gradients (dq, dk, dv) for the cotangent g."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves, bias, **kw)
    out.backward(g)
    return [out.detach()] + [x.grad for x in leaves]


def _assert_tower_close(got, want, s):
    """out and dv within 1e-4 x max|ref|; dq and dk too, except at S = 1,
    where they are 0 in exact arithmetic (softmax over one key has no
    gradient) and what remains is the rounding of g . v / (1 - rate) - g .
    out, terms of the size of dv."""
    floor = want[3].abs().max().item() if s == 1 else 1e-30
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        err = max_err_of_max(a, w, floor if name in ("dq", "dk") else 1e-30)
        assert err <= F32_RTOL_OF_MAX, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("s", TOWER_S)
def test_tf32_pair_matches_plain_on_card(s, dh, rate):
    """float32 through ``masked_attention``: the 3xTF32 forward, then the
    3xTF32 pair, against the plain version's forward and autograd gradients
    (a key bias with a capacity-padding row); no other tower kernel
    launches."""
    dev = _card()
    q, k, v, bias = _tower_inputs(s + dh, 3, 4, s, dh)
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(s), device=dev)
    before = [fn.launches for fn in ma.KERNELS]
    got = tower_grads(ma.masked_attention, q, k, v, bias, g, rate=rate, seed=1357)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(ma.KERNELS, before)] == TF32_LAUNCHES
    want = tower_grads(ma.masked_attention_dropout_reference, q, k, v, bias, g, rate=rate, seed=1357)
    _assert_tower_close(got, want, s)


@pytest.mark.gpu
@pytest.mark.parametrize("s, b, masked", TOWER_SHAPES)
def test_tf32_pair_at_tower_shapes_on_card(s, b, masked):
    """The tower shapes at H = 12, DH 64, rate 0.3 (the ViT without a key
    bias): the pair called directly from the 3xTF32 forward's statistics
    against the plain version."""
    dev = _card()
    q, k, v, bias = _tower_inputs(s + b, b, 12, s, 64, masked=masked)
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(b), device=dev)
    scale, rate, seed = 0.125, 0.3, 2024
    out, stats = ma.masked_attention_fwd_tf32(q, k, v, bias, scale, rate, seed, with_stats=True)
    dq, delta = ma.masked_attention_bwd_dq_tf32(q, k, v, out, g, bias, stats, scale, rate, seed)
    pair = [out, dq, *ma.masked_attention_bwd_dkv_tf32(q, k, v, g, bias, stats, delta, scale, rate, seed)]
    torch.cuda.synchronize()
    want = tower_grads(ma.masked_attention_dropout_reference, q, k, v, bias, g, rate=rate, seed=seed)
    _assert_tower_close(pair, want, s)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [17, 104, 300])
def test_tf32_pair_capacity_rows_on_card(s):
    """A capacity-padding row (every key at -1e9) gets p = 1 / S from the
    forward's statistics, as in the plain version: its dq is within the
    tolerance of the plain one (0 in exact arithmetic only where the keys
    are equal), and a change of its cotangent moves dk and dv as the plain
    version's do."""
    dev = _card()
    q, k, v, bias = _tower_inputs(s + 11, 2, 4, s, 64)
    assert bool((bias[-1] <= ta.MASK_BIAS).all())
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(s), device=dev)
    g[-1] *= 50.0  # the capacity row's share dominates dk and dv
    got = tower_grads(ma.masked_attention, q, k, v, bias, g, rate=0.3, seed=8)
    want = tower_grads(ma.masked_attention_dropout_reference, q, k, v, bias, g, rate=0.3, seed=8)
    _assert_tower_close(got, want, s)
    assert max_err_of_max(got[1][-1], want[1][-1]) <= F32_RTOL_OF_MAX


@pytest.mark.gpu
@pytest.mark.parametrize("s, b", [(104, 8), (201, 2), (300, 2)])
def test_tf32_pair_adjoint_identity_in_v(s, b):
    """<g, f(v2)> = <vjp_v(g), v2> through the 3xTF32 forward and pair: it
    holds only if the backward regenerates the forward's mask (relative
    1e-4)."""
    dev = _card()
    q, k, v, bias = _tower_inputs(s + 3, b, 12, s, 64)
    gen = torch.Generator(device=dev).manual_seed(s)
    g, v2 = (torch.randn(q.shape, generator=gen, device=dev) for _ in range(2))
    before = ma.masked_attention_bwd_dkv_tf32.launches
    vv = v.clone().requires_grad_(True)
    ma.masked_attention(q, k, vv, bias, rate=0.3, seed=77).backward(g)
    assert ma.masked_attention_bwd_dkv_tf32.launches == before + 1
    lhs = (g.double() * ma.masked_attention(q, k, v2, bias, rate=0.3, seed=77).double()).sum().item()
    rhs = (vv.grad.double() * v2.double()).sum().item()
    assert abs(lhs - rhs) <= ADJOINT_REL * max(abs(lhs), 1.0), (lhs, rhs)


def read_back_tower_masks(b, h, s, dh, rate, seed):
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
    e0 = zeros.clone()
    e0[..., 0] = 1.0
    by_dv, by_dq = [], []
    for c in range(-(-s // dh)):
        onehot = torch.zeros(s + dh, dh, device="cuda")
        onehot[c * dh : (c + 1) * dh] = torch.eye(dh, device="cuda")
        onehot = onehot[:s].expand(b, h, s, dh).contiguous()
        v = zeros.clone().requires_grad_(True)
        ma.masked_attention(zeros, zeros, v, None, rate=rate, seed=seed).backward(onehot)
        by_dv.append(v.grad.transpose(-1, -2) != 0)
        q = zeros.clone().requires_grad_(True)
        ma.masked_attention(q, onehot, e0, None, rate=rate, seed=seed).backward(e0)
        by_dq.append(q.grad > 0)
    return torch.cat(by_dv, dim=-2)[..., :s, :], torch.cat(by_dq, dim=-1)[..., :s]


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [36, 104, 300])
def test_tf32_pair_mask_is_the_plain_philox(s, dh):
    """Both kernels of the 3xTF32 pair regenerate the plain Philox mask bit
    for bit, read back through dv (the dk/dv kernel) and dq (the dq kernel)
    over several row and key chunks."""
    _card()
    b, h, rate = 2, 3, 0.3
    before = [fn.launches for fn in ma.KERNELS]
    by_dv, by_dq = read_back_tower_masks(b, h, s, dh, rate, 99)
    chunks = -(-s // dh)
    assert [fn.launches - n for fn, n in zip(ma.KERNELS, before)] == [2 * chunks * d for d in TF32_LAUNCHES]
    want = ta.dropout_keep_mask(99, b, h, s, rate, "cuda")
    assert torch.equal(by_dv, want)
    assert torch.equal(by_dq, want)
    assert abs(want.float().mean().item() - (1 - rate)) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("kind, bias_dtype", DENSE_BIASES)
@pytest.mark.parametrize("s", DENSE_S)
def test_tf32_dense_forward_matches_plain_on_card(s, kind, bias_dtype):
    """The 3xTF32 dense-bias forward on float32 q, k, v against the plain
    version: every S edge, per-head, shared and no bias in both bias dtypes
    (-inf entries, the pad mask; B = 3 below S = 257, so that the bias rows
    and pad rows start at several offsets). Through ``biased_attention``:
    one launch of it and none of the other forwards."""
    _card()
    b = 3 if s < 257 else 1
    q, k, v, bias, mask = to_torch(make_inputs(s + 17, b, 12, s, 64, kind), "cuda", bias_dtype=bias_dtype)
    before = [fn.launches for fn in ba.KERNELS]
    out = ba.biased_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(ba.KERNELS, before)] == [0, 0, 1]
    want = ba.biased_attention_reference(q, k, v, bias, mask)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out - want).abs().max().item() <= F32_ATOL
    assert max_err_of_max(out, want) <= F32_RTOL_OF_MAX, max_err_of_max(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 128])
@pytest.mark.parametrize("s", [33, 129])
def test_tf32_dense_forward_head_dims_on_card(s, dh):
    """The other head dims, with the CUDA-core forward on the same inputs
    beside it."""
    _card()
    q, k, v, bias, mask = to_torch(make_inputs(s + dh, 2, 4, s, dh), "cuda")
    out = ba.biased_attention_fwd_tf32(q, k, v, bias, mask, dh ** -0.5)
    want = ba.biased_attention_reference(q, k, v, bias, mask, dh ** -0.5)
    cuda_core = ba.biased_attention_fwd(q, k, v, bias, mask, dh ** -0.5)
    assert max_err_of_max(out, want) <= F32_RTOL_OF_MAX
    assert max_err_of_max(out, cuda_core) <= F32_RTOL_OF_MAX


@pytest.mark.gpu
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [33, 65, 601])
def test_tf32_dense_forward_masked_rows_on_card(s, bias_dtype):
    """A fully masked row spreads equal weights over its S real keys (never
    the keys past S of the last tile): batch row 0 pads every key, and row
    1's query s // 2 has every bias entry -inf. -inf plus the pad term gives
    -1e9, never NaN; a non-power-of-two scale applies to q in f32."""
    _card()
    q, k, v, bias, mask = to_torch(make_inputs(s + 5, 2, 12, s, 64), "cuda", bias_dtype=bias_dtype)
    mask[0] = True
    bias[1, :, s // 2] = -float("inf")
    scale = 0.1
    out = ba.biased_attention_fwd_tf32(q, k, v, bias, mask, scale)
    assert torch.isfinite(out).all()
    mean_v = v.mean(dim=2)  # (B, H, DH): equal weights over the S keys
    for row in out[0].unbind(1):
        torch.testing.assert_close(row, mean_v[0], atol=F32_RTOL_OF_MAX * mean_v[0].abs().max().item(), rtol=0)
    want = ba.biased_attention_reference(q, k, v, bias, mask, scale)
    assert max_err_of_max(out, want) <= F32_RTOL_OF_MAX, max_err_of_max(out, want)
