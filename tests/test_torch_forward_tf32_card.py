"""The float32 forwards on tensor cores in 3xTF32, on the card: the tree
attention's ``tree_attention_fwd_tf32`` and the tower attention's
``masked_attention_fwd_tf32`` against their plain versions, their
masks read back, and the gradients that the backward kernels compute from
what they save.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_forward_tf32_card.py

Without a card every test skips. The route to these kernels, their
wrappers' contract and the 3xTF32 arithmetic against the JAX package are
held on the CPU in ``test_torch_forward_tf32.py``.

Tolerances (float32 inputs, TF32 off for PyTorch's own products): out and
every gradient within 1e-4 x max|ref| of the plain version on the same
inputs, as for the float32 kernels they replace. 3xTF32 drops the small x
small term of each product (~2^-22 of it) and the tensor cores sum in
another order than the plain version. The tree's LSE and the tower's row
max within 1e-4 x max(1, |ref|) elementwise, the tower's log-sum within
1e-4 absolute (both are sums of products; the row max of a
capacity-padding row is -1e9 exactly). Masks read back bit for bit.
"""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

torch.set_num_threads(2)

F32_RTOL_OF_MAX = 1e-4
STAT_RTOL = 1e-4

# the ends of the S range and the edges of the 8-key n-tiles, 16-row tiles,
# 32- and 64-row blocks, 32- and 64-key tiles, the canonical buckets and
# the streaming sizes
TREE_S = (1, 8, 9, 16, 17, 31, 32, 33, 63, 64, 65, 129, 257, 601, 1025)
# the tower lengths (text 100 / 104, ViT 197 / 201), the same edges, and
# one length past the tensor-core route's 256
TOWER_S = (1, 8, 9, 17, 32, 33, 63, 64, 65, 100, 104, 129, 201, 256, 300)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def max_err_of_max(got, want, floor=1e-30):
    """max |got - want| over max(max |want|, floor)."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(floor)).item()


def _tree_inputs(seed, b, h, s, dh, id_low=0, id_high=ta.LUT_SIZE):
    """(q, k, v, template, ids, lut) on the card in float32, ~15% of the
    template masked (never column 0, as the collator never does)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    template = np.where(rng.random((b, s, s)) < 0.15, ta.MASK_BIAS, 0.0).astype(np.float32)
    template[:, :, 0] = 0.0
    ids = rng.integers(id_low, id_high, (b, s, s)).astype(np.int32)
    lut = rng.standard_normal((ta.LUT_SIZE, h)).astype(np.float32)
    lut[0] = 0.0
    return tuple(torch.from_numpy(a).cuda() for a in (q, k, v, template, ids, lut))


def _tower_inputs(seed, b, h, s, dh, masked=True):
    """(q, k, v, key bias or None) on the card in float32: about 30% of the
    keys of each row padded with MASK_BIAS (key 0 never), the last row a
    capacity-padding row (every key masked)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, dh)).astype(np.float32)).cuda() for _ in range(3))
    bias = None
    if masked:
        bias = np.where(rng.random((b, s)) < 0.3, ta.MASK_BIAS, 0.0).astype(np.float32)
        bias[:, 0] = 0.0
        bias[-1] = ta.MASK_BIAS
        bias = torch.from_numpy(bias).cuda()
    return q, k, v, bias


def plain_lse(q, k, template, ids, lut, scale):
    """m + log(l) in f32 as the tree kernels store it."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float()) + ta.assemble_bias(template, ids, lut, True)
    m = s.amax(-1).clamp_min(ta.MASK_BIAS)
    return m + torch.exp(s - m[..., None]).sum(-1).clamp_min(1e-30).log()


def plain_stats(q, k, bias, scale):
    """(row max clamped at -1e9, log of the clamped undropped row sum), f32
    (2, B, H, S), as the tower kernels store them."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float().clamp_min(ta.MASK_BIAS)[:, None, None, :]
    m = s.amax(-1).clamp_min(ta.MASK_BIAS)
    return torch.stack([m, torch.exp(s - m[..., None]).sum(-1).clamp_min(1e-30).log()])


# ---------------------------------------------------------------------------
# the tree forward
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("s", TREE_S)
def test_tree_forward_matches_plain_on_card(s, dh, rate):
    """The 3xTF32 tree forward alone, with its LSE, against the plain
    version on the same float32 inputs."""
    _card()
    b = 2 if s <= 257 else 1
    q, k, v, template, ids, lut = _tree_inputs(s + 3 * dh, b, 4, s, dh)
    scale = dh ** -0.5
    before = [fn.launches for fn in ta.KERNELS]
    out, lse = ta.tree_attention_fwd_tf32(q, k, v, template, ids, lut, scale, True, rate, 4321, with_lse=True)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(ta.KERNELS, before)] == [0, 0, 0, 0, 0, 1]
    want = ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, 4321, rate, scale)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert max_err_of_max(out, want) <= F32_RTOL_OF_MAX, max_err_of_max(out, want)
    ref = plain_lse(q, k, template, ids, lut, scale)
    torch.testing.assert_close(lse, ref, rtol=STAT_RTOL, atol=STAT_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [33, 601])
def test_tree_forward_masked_rows_and_ids_on_card(s, dh):
    """A row whose every key the template masks gives zeros and the LSE
    -1e9 + log 1e-30; ids outside [0, 32) and LUT row 0 add
    nothing, bit for bit."""
    _card()
    q, k, v, template, ids, lut = _tree_inputs(s + 7, 2, 4, s, dh, id_low=-40, id_high=3 * ta.LUT_SIZE)
    template[0, s // 2] = ta.MASK_BIAS  # one row fully masked, column 0 included
    scale = dh ** -0.5
    out, lse = ta.tree_attention_fwd_tf32(q, k, v, template, ids, lut, scale, True, 0.3, 9, with_lse=True)
    assert torch.equal(out[0, :, s // 2], torch.zeros_like(out[0, :, s // 2]))
    torch.testing.assert_close(lse[0, :, s // 2], torch.full_like(lse[0, :, s // 2], ta.MASK_BIAS + np.log(1e-30)))
    want = ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, 9, 0.3, scale)
    assert max_err_of_max(out, want) <= F32_RTOL_OF_MAX
    clean = torch.where((ids >= 0) & (ids < ta.LUT_SIZE), ids, 0).to(torch.int32).contiguous()
    dirty_lut = lut.clone()
    dirty_lut[0] = 7.0
    again, again_lse = ta.tree_attention_fwd_tf32(q, k, v, template, clean, dirty_lut, scale, True, 0.3, 9, True)
    assert torch.equal(again, out) and torch.equal(again_lse, lse)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [33, 601])
def test_tree_forward_mask_is_the_plain_philox(s, dh):
    """With q = k = 0 and no bias every row weighs its keys equally, so with
    v holding one-hot columns for keys c*DH .. c*DH+DH-1, out = keep / (S (1
    - rate)) there: the 3xTF32 forward's mask, read back over several key
    tiles through ``tree_attention``, equals the plain Philox bit for bit."""
    dev = _card()
    b, h, rate = 1, 3, 0.3
    zeros = torch.zeros(b, h, s, dh, device=dev)
    template = torch.zeros(b, s, s, device=dev)
    ids = torch.zeros(b, s, s, dtype=torch.int32, device=dev)
    lut = torch.zeros(ta.LUT_SIZE, h, device=dev)
    before = [fn.launches for fn in ta.KERNELS]
    chunks = []
    for c in range(-(-s // dh)):
        v = torch.zeros(s + dh, dh, device=dev)
        v[c * dh : (c + 1) * dh] = torch.eye(dh, device=dev)
        out = ta.tree_attention(zeros, zeros, v[:s].expand(b, h, s, dh).contiguous(), template, ids, lut,
                                rate=rate, seed=99)
        chunks.append((out * s * (1 - rate)).round() > 0.5)
    assert [fn.launches - n for fn, n in zip(ta.KERNELS, before)] == [0] * 5 + [len(chunks)]
    mask = torch.cat(chunks, dim=-1)[..., :s]
    assert torch.equal(mask, ta.dropout_keep_mask(99, b, h, s, rate, dev))
    assert abs(mask.float().mean().item() - (1 - rate)) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s, b", [(33, 4), (129, 2), (601, 1), (1025, 1)])
def test_tree_gradients_through_the_tf32_forward(s, b, dh, rate):
    """float32 through ``tree_attention``: the 3xTF32 forward, then the
    3xTF32 pair reading its LSE and regenerating its mask, against the plain
    version's forward and autograd gradients; the tensor-core kernels
    launch no time."""
    dev = _card()
    q, k, v, template, ids, lut = _tree_inputs(5 * s + dh, b, 4, s, dh)
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(s), device=dev)
    before = [fn.launches for fn in ta.KERNELS]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, lut)]
    out = ta.tree_attention(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], rate=rate, seed=1234)
    out.backward(g)
    got = [out.detach()] + [x.grad for x in leaves]
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(ta.KERNELS, before)] == [0, 0, 0, 1, 1, 1]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, lut)]
    ref = ta.tree_attention_dropout_reference(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], 1234, rate)
    ref.backward(g)
    want = [ref.detach()] + [x.grad for x in leaves]
    for name, a, w in zip(("out", "dq", "dk", "dv", "dlut"), got, want):
        assert torch.isfinite(a).all(), name
        assert max_err_of_max(a, w) <= F32_RTOL_OF_MAX, (name, max_err_of_max(a, w))


# ---------------------------------------------------------------------------
# the tower forward
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("s", TOWER_S)
def test_tower_forward_matches_plain_on_card(s, dh, rate):
    """The 3xTF32 tower forward alone, with its statistics, against the
    plain version on the same float32 inputs (a key bias with a
    capacity-padding row)."""
    _card()
    q, k, v, bias = _tower_inputs(s + dh, 3, 4, s, dh)
    scale = dh ** -0.5
    before = [fn.launches for fn in ma.KERNELS]
    out, stats = ma.masked_attention_fwd_tf32(q, k, v, bias, scale, rate, 2468, with_stats=True)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(ma.KERNELS, before)] == [int(fn is ma.masked_attention_fwd_tf32)
                                                                      for fn in ma.KERNELS]
    want = ma.masked_attention_dropout_reference(q, k, v, bias, 2468, rate, scale)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert max_err_of_max(out, want) <= F32_RTOL_OF_MAX, max_err_of_max(out, want)
    ref = plain_stats(q, k, bias, scale)
    torch.testing.assert_close(stats[0], ref[0], rtol=STAT_RTOL, atol=STAT_RTOL)
    torch.testing.assert_close(stats[1], ref[1], rtol=0.0, atol=STAT_RTOL)
    assert torch.equal(stats[0, -1], torch.full_like(stats[0, -1], ta.MASK_BIAS))  # the padding row


@pytest.mark.gpu
@pytest.mark.parametrize("s", [104, 201])
def test_tower_forward_without_bias_on_card(s):
    """No key bias (the ViT): the plain version's output at both rates."""
    _card()
    q, k, v, _ = _tower_inputs(s, 2, 12, s, 64, masked=False)
    for rate in (0.0, 0.3):
        out, _ = ma.masked_attention_fwd_tf32(q, k, v, None, 0.125, rate, 5)
        want = ma.masked_attention_dropout_reference(q, k, v, None, 5, rate, 0.125)
        assert max_err_of_max(out, want) <= F32_RTOL_OF_MAX


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [36, 104, 300])
def test_tower_forward_mask_is_the_plain_philox(s, dh):
    """The 3xTF32 tower forward's mask, read back through
    ``masked_attention`` (q = k = 0, v one-hot by key chunk), equals the
    plain Philox bit for bit."""
    dev = _card()
    b, h, rate = 2, 3, 0.3
    zeros = torch.zeros(b, h, s, dh, device=dev)
    before = ma.masked_attention_fwd_tf32.launches
    chunks = []
    for c in range(-(-s // dh)):
        v = torch.zeros(s + dh, dh, device=dev)
        v[c * dh : (c + 1) * dh] = torch.eye(dh, device=dev)
        out = ma.masked_attention(zeros, zeros, v[:s].expand(b, h, s, dh).contiguous(), None, seed=98, rate=rate)
        chunks.append((out * s * (1 - rate)).round() > 0.5)
    assert ma.masked_attention_fwd_tf32.launches == before + len(chunks)
    mask = torch.cat(chunks, dim=-1)[..., :s]
    assert torch.equal(mask, ta.dropout_keep_mask(98, b, h, s, rate, dev))
    assert abs(mask.float().mean().item() - (1 - rate)) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [36, 104, 201, 300])
def test_tower_gradients_through_the_tf32_forward(s, dh, rate):
    """float32 through ``masked_attention``: the 3xTF32 forward, then the
    3xTF32 pair reading its statistics, against the plain version's forward
    and autograd gradients (a capacity-padding row included); no other
    tower kernel launches."""
    dev = _card()
    q, k, v, bias = _tower_inputs(7 * s + dh, 3, 4, s, dh)
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(s), device=dev)
    before = [fn.launches for fn in ma.KERNELS]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ma.masked_attention(*leaves, bias, seed=1234, rate=rate)
    out.backward(g)
    got = [out.detach()] + [x.grad for x in leaves]
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(ma.KERNELS, before)] == [0, 0, 1, 1, 1, 0, 0, 0]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = ma.masked_attention_dropout_reference(*leaves, bias, 1234, rate)
    ref.backward(g)
    want = [ref.detach()] + [x.grad for x in leaves]
    floor = want[3].abs().max().item() if s == 1 else 1e-30
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        assert max_err_of_max(a, w, floor) <= F32_RTOL_OF_MAX, (name, max_err_of_max(a, w, floor))
