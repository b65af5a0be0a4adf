"""The tiled tensor-core tower kernels (``csrc/masked_attention_fwd_tiled.cu``
and the pair of ``csrc/masked_attention_bwd_tiled.cu``) against the plain
version on the card: bf16 at DH 16, 32, 64 and 128, S from 1 past the
one-pass kernels' 256 up to the JAX package's whole-S limit of 1,024.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_masked_attention_tiled_card.py

Without a card every test skips. The comparisons with the JAX package are in
``test_torch_masked_attention_tiled.py``.

Tolerance: 1e-2 x max|ref| in bf16 (the forward rounds p to bf16 before
P V, the pair rounds p and ds to bf16 before its second products, and every
output is rounded to bf16), as for the other bf16 tower kernels.
"""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

torch.set_num_threads(2)

BF16_RTOL_OF_MAX = 1e-2
TILED = ("masked_attention_fwd_tiled", "masked_attention_bwd_dq_tiled", "masked_attention_bwd_dkv_tiled")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, h, s, dh, device, capacity_rows=True):
    """bf16 q, k, v, g on the card and an f32 (B, S) key bias: ~30% of each
    row's keys padded with MASK_BIAS (key 0 never), and the last row of the
    batch a capacity-padding row (every key masked) when asked."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, h, s, dh)).astype(np.float32)).to(device, torch.bfloat16)
                  for _ in range(4))
    bias = np.where(rng.random((b, s)) < 0.3, ta.MASK_BIAS, 0.0).astype(np.float32)
    bias[:, 0] = 0.0
    if capacity_rows and b > 1:
        bias[-1] = ta.MASK_BIAS
    return q, k, v, g, torch.from_numpy(bias).to(device)


def _plain(q, k, v, bias, g, scale, rate, seed):
    leaves = [x.float().detach().requires_grad_(True) for x in (q, k, v)]
    out = ma.masked_attention_dropout_reference(*leaves, bias, seed, rate, scale)
    out.backward(g.float())
    return [out.detach()] + [x.grad for x in leaves]


def _tiled(q, k, v, bias, g, scale, rate, seed):
    out, stats = ma.masked_attention_fwd_tiled(q, k, v, bias, scale, rate, seed, with_stats=True)
    dq, delta = ma.masked_attention_bwd_dq_tiled(q, k, v, out, g, bias, stats, scale, rate, seed)
    dk, dv = ma.masked_attention_bwd_dkv_tiled(q, k, v, g, bias, stats, delta, scale, rate, seed)
    return [out, dq, dk, dv], stats



def _plain_stats(q, k, bias, scale):
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2)) + bias.clamp_min(ta.MASK_BIAS)[:, None, None, :]
    m = s.amax(-1).clamp_min(ta.MASK_BIAS)
    return torch.stack([m, torch.exp(s - m[..., None]).sum(-1).clamp_min(1e-30).log()])


# (S, B, DH): the edges of the 16-key steps and 64-key tiles, the shapes the
# one-pass kernels stop at, the text and fusion lengths at 512 positions,
# and the JAX package's whole-S limit; DH 16, 32, 128 beside 64
SHAPES = [(1, 2, 64), (17, 2, 64), (64, 2, 64), (65, 2, 64), (257, 2, 64), (300, 4, 64), (512, 2, 64),
          (516, 2, 64), (1024, 2, 64), (104, 4, 16), (300, 2, 16), (104, 4, 32), (300, 2, 32), (104, 2, 128),
          (300, 2, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("s, b, dh", SHAPES)
def test_tiled_kernels_match_plain_on_card(s, b, dh, rate):
    """out, dq, dk and dv of the tiled forward and pair against the plain
    version's autograd in f32, with a capacity-padding row, within 1e-2 of
    max |ref|; the statistics against the plain ones."""
    dev = _card()
    h, scale, seed = 3, dh ** -0.5, 1234 + s
    q, k, v, g, bias = _inputs(s * 7 + dh, b, h, s, dh, dev)
    got, stats = _tiled(q, k, v, bias, g, scale, rate, seed)
    want = _plain(q, k, v, bias, g, scale, rate, seed)
    torch.cuda.synchronize()
    # at S = 1 dq and dk are 0 in exact arithmetic: what remains is the
    # rounding of g . v / (1 - rate) - g . out, terms of the size of dv
    floor = want[3].abs().max().item() if s == 1 else 0.0
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(x.float()).all(), name
        assert (x.float() - y).abs().max().item() <= BF16_RTOL_OF_MAX * max(y.abs().max().item(), floor), name
    ref = _plain_stats(q, k, bias, scale)
    assert torch.allclose(stats[0], ref[0], rtol=1e-5, atol=2e-3)
    assert torch.allclose(stats[1], ref[1], rtol=1e-5, atol=2e-3)
    padding = ref[0] <= ta.MASK_BIAS
    assert torch.equal(stats[0][padding], ref[0][padding])


@pytest.mark.gpu
@pytest.mark.parametrize("dh, s", [(64, 257), (64, 300), (16, 104), (32, 104), (128, 104), (128, 300)])
def test_route_takes_the_tiled_kernels(dh, s):
    """masked_attention on bf16 outside the one-pass range launches the
    tiled forward once and each pair kernel once, and nothing else."""
    dev = _card()
    q, k, v, g, bias = _inputs(5, 2, 2, s, dh, dev)
    before = {fn.__name__: fn.launches for fn in ma.KERNELS}
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    ma.masked_attention(*leaves, bias, seed=9, rate=0.3).backward(g)
    torch.cuda.synchronize()
    launched = {fn.__name__: fn.launches - before[fn.__name__] for fn in ma.KERNELS}
    assert launched == {n: int(n in TILED) for n in launched}


@pytest.mark.gpu
@pytest.mark.parametrize("dh, s", [(64, 300), (16, 104), (128, 201)])
def test_tiled_masks_are_the_plain_philox(dh, s):
    """The forward's keep mask read through out (q = k = 0, v one-hot
    columns), the dk/dv kernel's through dv (g one-hot rows) and the dq
    kernel's through dq (v = g = e_0, k one-hot columns), each against the
    plain Philox mask."""
    dev = _card()
    b, h, rate, seed = 2, 2, 0.3, 777
    plain = ta.dropout_keep_mask(seed, b, h, s, rate, dev)
    zeros = torch.zeros(b, h, s, dh, device=dev, dtype=torch.bfloat16)
    e0 = zeros.clone()
    e0[..., 0] = 1.0
    by_out, by_dv, by_dq = [], [], []
    for c in range(-(-s // dh)):
        onehot = torch.zeros(s + dh, dh, device=dev)
        onehot[c * dh: (c + 1) * dh] = torch.eye(dh, device=dev)
        onehot = onehot[:s].to(torch.bfloat16).expand(b, h, s, dh).contiguous()
        out, stats = ma.masked_attention_fwd_tiled(zeros, zeros, onehot, None, dh ** -0.5, rate, seed, with_stats=True)
        by_out.append((out.float() * s * (1 - rate)).round() > 0.5)
        _, delta = ma.masked_attention_bwd_dq_tiled(zeros, zeros, onehot, out, onehot, None, stats, dh ** -0.5, rate,
                                                    seed)
        _, dv = ma.masked_attention_bwd_dkv_tiled(zeros, zeros, onehot, onehot, None, stats, delta, dh ** -0.5, rate,
                                                  seed)
        by_dv.append(dv.float().transpose(-1, -2) != 0)
        out0, stats0 = ma.masked_attention_fwd_tiled(zeros, onehot, e0, None, dh ** -0.5, rate, seed, with_stats=True)
        dq, _ = ma.masked_attention_bwd_dq_tiled(zeros, onehot, e0, out0, e0, None, stats0, dh ** -0.5, rate, seed)
        by_dq.append(dq.float() > 0)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(by_out, dim=-1)[..., :s], plain)
    assert torch.equal(torch.cat(by_dv, dim=-2)[..., :s, :], plain)
    assert torch.equal(torch.cat(by_dq, dim=-1)[..., :s], plain)


@pytest.mark.gpu
@pytest.mark.parametrize("dh, s", [(64, 300), (32, 517)])
def test_tiled_adjoint_identity_in_v(dh, s):
    """<g, A(v2)> = <dv(g), v2> for the linear map A: v -> out at fixed q, k
    and mask, through the tiled forward and the dk/dv kernel, in f64 sums,
    with g = A(v2) so that the left side is ||A(v2)||^2 > 0: each side
    rounds its output (out, dv) to bf16 (2^-9 of each element), ~1e-4 of
    the sum, while a wrong mask at rate 0.3 moves it by tens of percent."""
    dev = _card()
    q, k, v, _, bias = _inputs(21, 2, 2, s, dh, dev)
    v2 = torch.randn(q.shape, device=dev).to(torch.bfloat16)
    fv2 = ma.masked_attention(q, k, v2, bias, seed=5, rate=0.3)
    vv = v.clone().requires_grad_(True)
    ma.masked_attention(q, k, vv, bias, seed=5, rate=0.3).backward(fv2)
    lhs = (fv2.double() * fv2.double()).sum().item()
    rhs = (vv.grad.double() * v2.double()).sum().item()
    assert abs(lhs - rhs) <= 1e-3 * lhs


@pytest.mark.gpu
def test_tiled_wrappers_refuse_other_dtypes_on_card():
    """A float32 tensor on the card goes to no tiled kernel: the wrapper
    raises (the route sends float32 to the 3xTF32 kernels)."""
    dev = _card()
    q = torch.zeros(1, 1, 300, 64, device=dev)
    with pytest.raises(ValueError, match="tiled"):
        ma.masked_attention_fwd_tiled(q, q, q, None, 0.125)
