"""The tree-attention wrapper's contract (the tensor-core forward's input
checks, the CPU path, the build), and the forwards against their plain
version on the card.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_tree_attention_card.py

(``--noconftest``: the repository's conftest sets JAX up.) Without a card
the tests marked ``gpu`` skip. The comparisons with the JAX package's Pallas
kernels are in ``test_torch_tree_attention.py``.
"""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

torch.set_num_threads(2)


def _inputs(seed, b, h, s, dh, id_low=0, id_high=ta.LUT_SIZE):
    """numpy (q, k, v, template, ids, lut) with ~15% of the template
    masked (never column 0, as the collator never does)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    template = np.where(rng.random((b, s, s)) < 0.15, ta.MASK_BIAS, 0.0).astype(np.float32)
    template[:, :, 0] = 0.0  # the graph-token column is never masked
    ids = rng.integers(id_low, id_high, (b, s, s)).astype(np.int32)
    lut = rng.standard_normal((ta.LUT_SIZE, h)).astype(np.float32)
    lut[0] = 0.0
    return q, k, v, template, ids, lut


def _port(arrays, **kw):
    return ta.tree_attention(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


def test_lut_row_zero_is_ignored():
    """id 0 is padding: whatever lut[0] holds, it adds nothing."""
    arrays = _inputs(13, 2, 3, 9, 8)
    dirty = list(arrays)
    dirty[5] = arrays[5].copy()
    dirty[5][0] = 7.0
    np.testing.assert_array_equal(_port(dirty), _port(arrays))


def test_cpu_path_never_builds_or_counts(monkeypatch):
    """bf16 at DH 128 (which the card sends to the tensor-core forward)
    and float32 at DH 8 (which no kernel takes) on the CPU: the plain
    version, no build, no launch."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    before = [fn.launches for fn in ta.KERNELS]
    _port(_inputs(15, 1, 2, 9, 8))
    bf16 = [torch.from_numpy(a) for a in _inputs(15, 1, 2, 9, 128)]
    bf16[:3] = [x.bfloat16() for x in bf16[:3]]
    assert torch.isfinite(ta.tree_attention(*bf16).float()).all()
    assert [fn.launches for fn in ta.KERNELS] == before


def test_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that cannot run fails the build loudly."""
    monkeypatch.setenv("NVCC", str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(OSError):
        cuda_lib.build()


def test_other_devices_raise():
    q = torch.empty(1, 2, 9, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ta.tree_attention(q, q, q, q, q, q)


# each fault of the tensor-core forward's inputs: the error and its words
KERNEL_FAULTS = {"dtype": (TypeError, "float32 or bfloat16"), "head_dim": (ValueError, "head dim 48"),
                 "ids_dtype": (ValueError, "ids"), "layout": (ValueError, "contiguous"),
                 "requires_grad": (ValueError, "runs on cuda")}


@pytest.mark.parametrize("fault", list(KERNEL_FAULTS))
def test_kernel_input_checks(monkeypatch, fault):
    """What the tensor-core forward refuses, checked on CPU tensors before
    any build: float16, a head dim outside (16, 32, 64, 128), int64 ids, a
    non-contiguous q. Inputs that want a gradient are taken (the backward
    kernels give it): with them, only the CPU device is refused."""

    def no_build():
        raise AssertionError("an input check must raise before the build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    q, k, v, template, ids, lut = (torch.from_numpy(a) for a in _inputs(16, 1, 2, 9, 64))
    q, k, v = (x.to(torch.half if fault == "dtype" else torch.bfloat16) for x in (q, k, v))
    if fault == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    elif fault == "ids_dtype":
        ids = ids.long()
    elif fault == "layout":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "requires_grad":
        q.requires_grad_(True)
    error, words = KERNEL_FAULTS[fault]
    with pytest.raises(error, match=words):
        ta.tree_attention_fwd_fused(q, k, v, template, ids, lut, 0.125)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s, b", [(33, 4), (129, 2), (601, 1)])
def test_kernel_matches_plain_on_card(dtype, s, b, dh):
    """The routed forward against its plain version on the card, at 768 //
    dh heads: float32 (the 3xTF32 forward) with TF32 off at atol 1e-4;
    bfloat16 (the tensor-core forward, which rounds p to bf16 before P V)
    within 1e-2 of max |ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v, template, ids, lut = (torch.from_numpy(a).cuda() for a in _inputs(17, b, 768 // dh, s, dh))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    fwd = ta.tree_attention_fwd_tf32 if dtype == "float32" else ta.tree_attention_fwd_fused
    before = fwd.launches
    got = ta.tree_attention(q, k, v, template, ids, lut).float()
    assert fwd.launches == before + 1
    want = ta.tree_attention_reference(q, k, v, template, ids, lut).float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-2


@pytest.mark.gpu
def test_kernel_out_of_range_ids_on_card():
    """ids outside [0, LUT_SIZE) add nothing on the card either (and are
    never used as an index): float32, TF32 off, atol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arrays = _inputs(18, 2, 12, 33, 64, id_low=-40, id_high=3 * ta.LUT_SIZE)
    clean = list(arrays)
    clean[4] = np.where((arrays[4] >= 0) & (arrays[4] < ta.LUT_SIZE), arrays[4], 0).astype(np.int32)
    got = ta.tree_attention(*(torch.from_numpy(a).cuda() for a in arrays))
    want = ta.tree_attention_reference(*(torch.from_numpy(a).cuda() for a in clean))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
