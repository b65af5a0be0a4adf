"""The dense-bias attention's forward kernels: the route between them, the
tensor-core forward's wrapper contract, and the tensor-core forward against
the plain version on the card (the 3xTF32 forward's are in
``test_torch_tf32_tower_bwd_dense_fwd_card.py``).

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_biased_attention_route.py

Without a card the tests marked ``gpu`` skip. The comparisons with the JAX
package are in ``test_torch_biased_attention.py``.

Tolerances on the card (the plain version in f32 on the same inputs): the
tensor-core forward and the gradients behind it within 1e-2 x max|ref| in
bf16, as for the other bf16 kernels (the kernel rounds P to bf16 before P V,
about one more bf16 step, and the output to bf16); float32 through the
3xTF32 forward within 1e-4 absolute (sums in other orders, TF32 off for
PyTorch's products, ~2^-22 of each product dropped) and its gradients
within 1e-4 x max|ref|.
"""

import importlib

import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from test_torch_biased_attention_card import forward_and_grads, make_inputs, max_err_of_max, to_torch

ba = importlib.import_module("multimodaldiscussiontransformer_tpu_torch.ops.biased_attention")

torch.set_num_threads(2)

BF16_RTOL_OF_MAX = 1e-2
F32_ATOL = 1e-4
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# the ends of the S range, the edges of the 16-key steps, 64-key tiles and
# 32-row blocks, the canonical buckets and the streaming sizes
FUSED_S = (1, 2, 17, 33, 63, 64, 65, 129, 257, 601, 1025)
# (bias kind, bias dtype): per-head and head-shared in both dtypes, and none
BIASES = [("head", torch.bfloat16), ("head", torch.float32), ("shared", torch.bfloat16),
          ("shared", torch.float32), ("none", None)]


def _torch(arrays, device="cpu", dtype=torch.bfloat16, bias_dtype=torch.bfloat16):
    """``to_torch`` with bf16 q, k, v and bias by default."""
    return to_torch(arrays, device, dtype, bias_dtype)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    return [fn.launches for fn in ba.KERNELS]


# launches of ba.KERNELS (CUDA-core, tensor-core, 3xTF32) for one forward,
# by route
ROUTE_LAUNCHES = {"cuda_core": [1, 0, 0], "tensor_core": [0, 1, 0], "tf32": [0, 0, 1]}

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
    assert ba.kernel_route(dtype, dh) == route


def test_model_graph_layers_route_to_tensor_cores():
    """``ModelConfig()``'s graph layers (bf16, d = 768 over 12 heads) take
    the tensor-core forward; their float32 twin the 3xTF32 one."""
    from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig

    mc = ModelConfig()
    dh = mc.encoder_embed_dim // mc.encoder_attention_heads
    assert (mc.dtype, dh) == ("bfloat16", 64)
    assert ba.kernel_route(getattr(torch, mc.dtype), dh) == "tensor_core"
    assert ba.kernel_route(torch.float32, dh) == "tf32"


def test_build_tables_name_the_tensor_core_forward():
    assert cuda_lib.SOURCES["biased_fwd_mma"] == cuda_lib.CSRC / "biased_attention_fwd_mma.cu"
    assert cuda_lib.ENTRY_POINTS["biased_fwd_mma"] == {
        "biased_attention_fwd_mma": cuda_lib.ENTRY_POINTS["biased_fwd"]["biased_attention_fwd"]}
    assert cuda_lib.ERROR_STRINGS["biased_fwd_mma"] == "biased_attention_fwd_mma_error_string"
    assert "biased_fwd_mma" in cuda_lib.library_paths()
    assert ba.KERNELS == (ba.biased_attention_fwd, ba.biased_attention_fwd_fused, ba.biased_attention_fwd_tf32)


@pytest.mark.parametrize("kind, bias_dtype", BIASES)
def test_fused_forward_passes_the_cuda_core_arguments(monkeypatch, kind, bias_dtype):
    """The tensor-core wrapper launches its library's C function with the
    CUDA-core forward's argument list (the bias's heads and dtype code, null
    for no bias) and counts one launch. The device check is stood in for, so
    that CPU tensors reach the launch."""
    launched = []
    monkeypatch.setattr(ba, "_check_tensor_core_inputs", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "launch", lambda lib, fn, dev, *args: launched.append((lib, fn, args)))
    q, k, v, bias, mask = _torch(make_inputs(6, 2, 3, 9, 64, kind), bias_dtype=bias_dtype)
    before = _launches()
    out = ba.biased_attention_fwd_fused(q, k, v, bias, mask, 0.125)
    assert out.shape == q.shape and out.dtype == q.dtype
    (lib, fn, args), = launched
    assert (lib, fn) == ("biased_fwd_mma", "biased_attention_fwd_mma")
    assert len(args) + 1 == len(cuda_lib.ENTRY_POINTS[lib][fn])  # + the stream
    assert args[3] == (None if bias is None else bias.data_ptr()) and args[4] == mask.data_ptr()
    heads = {"head": 3, "shared": 1, "none": 0}[kind]
    assert args[6:11] == (2, 3, 9, 64, heads) and args[11] == 0.125
    assert args[12:] == (ba.DTYPE_CODES[torch.bfloat16], ba.DTYPE_CODES[bias_dtype or torch.float32])
    assert _launches() == [n + d for n, d in zip(before, ROUTE_LAUNCHES["tensor_core"])]


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype)
    view = buf[1 : 1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


# each fault of the tensor-core forward's inputs and the words of its error
FUSED_FAULTS = {"float32": "tensor-core", "head_dim": "tensor-core", "bias_shape": "bias must",
                "misaligned_q": "aligned", "misaligned_k": "aligned", "misaligned_v": "aligned",
                "misaligned_bias": "aligned", "misaligned_mask": "aligned", "cpu": "runs on cuda"}


@pytest.mark.parametrize("fault", list(FUSED_FAULTS))
def test_fused_forward_input_checks(monkeypatch, fault):
    """What ``biased_attention_fwd_fused`` refuses: anything but bf16 at DH
    64, a malformed bias, q, k, v, the bias or the pad mask off a 16-byte
    boundary, and tensors off the card. It raises before any build, and
    never runs the CUDA-core kernel or the plain version instead."""

    def no_build():
        raise AssertionError("an input check must raise before the build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    dh = 32 if fault == "head_dim" else 64
    q, k, v, bias, mask = _torch(make_inputs(8, 2, 2, 9, dh), dtype=torch.float32 if fault == "float32" else torch.bfloat16)
    if fault == "bias_shape":
        bias = bias[:, :, :8].contiguous()
    elif fault.startswith("misaligned_"):
        name = fault[len("misaligned_"):]
        tensors = {"q": q, "k": k, "v": v, "bias": bias, "mask": mask}
        tensors[name] = _misaligned(tensors[name])
        q, k, v, bias, mask = tensors.values()
    before = _launches()
    with pytest.raises(ValueError, match=FUSED_FAULTS[fault]):
        ba.biased_attention_fwd_fused(q, k, v, bias, mask, dh ** -0.5)
    assert _launches() == before


@pytest.mark.parametrize("kind, bias_dtype", BIASES)
def test_cpu_path_never_builds_the_fused_forward(monkeypatch, kind, bias_dtype):
    """bf16 at DH = 64 on the CPU: the plain version and the Function's
    backward, no build and no launch, although the card would take the
    tensor-core forward."""

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    before = _launches()
    q, k, v, bias, mask = _torch(make_inputs(9, 1, 2, 17, 64, kind), bias_dtype=bias_dtype)
    got = forward_and_grads(ba.biased_attention, q, k, v, bias, mask, torch.ones_like(q))
    assert torch.equal(got[0], ba.biased_attention_reference(q, k, v, bias, mask))
    assert all(x is None or torch.isfinite(x.float()).all() for x in got)
    assert _launches() == before


def _pad_cases():
    return [(s, kind, dt, True) for s in FUSED_S for kind, dt in BIASES] + \
           [(s, kind, dt, False) for s in (33, 65, 601) for kind, dt in BIASES]


@pytest.mark.gpu
@pytest.mark.parametrize("s, kind, bias_dtype, pad", _pad_cases())
def test_fused_forward_matches_plain_on_card(s, kind, bias_dtype, pad):
    """The tensor-core forward alone against the plain version on the same
    bf16 inputs: every S edge, per-head, shared and no bias in both bias
    dtypes, with and without the pad mask (B = 3 below S = 257, so that the
    pad rows and bias planes start at several offsets within a 16-byte
    chunk)."""
    _card()
    b = 3 if s < 257 else 1
    q, k, v, bias, mask = _torch(make_inputs(s, b, 12, s, 64, kind, pad), "cuda", bias_dtype=bias_dtype)
    before = _launches()
    out = ba.biased_attention_fwd_fused(q, k, v, bias, mask, 0.125)
    assert _launches() == [n + d for n, d in zip(before, ROUTE_LAUNCHES["tensor_core"])]
    want = ba.biased_attention_reference(q, k, v, bias, mask, 0.125)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert max_err_of_max(out, want) <= BF16_RTOL_OF_MAX, max_err_of_max(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [33, 65, 601])
def test_fused_forward_masked_rows_on_card(s, bias_dtype):
    """A fully masked row spreads equal weights over its S real keys (never
    the keys past S of the last 16-key step): batch row 0 pads every key,
    and row 1's query s // 2 has every bias entry -inf. -inf plus the pad
    term gives -1e9, never NaN; a non-power-of-two scale applies to the f32
    accumulator."""
    _card()
    q, k, v, bias, mask = _torch(make_inputs(s + 5, 2, 12, s, 64), "cuda", bias_dtype=bias_dtype)
    mask[0] = True
    bias[1, :, s // 2] = -float("inf")
    scale = 0.1
    out = ba.biased_attention_fwd_fused(q, k, v, bias, mask, scale)
    assert torch.isfinite(out.float()).all()
    mean_v = v.float().mean(dim=2)  # (B, H, DH): equal weights over the S keys
    for row in out[0].float().unbind(1):
        torch.testing.assert_close(row, mean_v[0], atol=BF16_RTOL_OF_MAX * mean_v[0].abs().max().item(), rtol=0)
    want = ba.biased_attention_reference(q, k, v, bias, mask, scale)
    torch.testing.assert_close(out[1, :, s // 2].float(), want[1, :, s // 2].float(),
                               atol=BF16_RTOL_OF_MAX * want[1].float().abs().max().item(), rtol=0)
    assert max_err_of_max(out, want) <= BF16_RTOL_OF_MAX, max_err_of_max(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["head", "shared", "none"])
@pytest.mark.parametrize("s, b", [(33, 4), (257, 2), (1025, 1)])
def test_function_routes_and_gradients_on_card(s, b, kind, dtype):
    """``biased_attention`` on the card: bf16 launches the tensor-core
    forward once, float32 the 3xTF32 one, and neither the CUDA-core one;
    the output and the gradients (the unchanged torch-ops backward) agree
    with autograd of the plain version."""
    dev = _card()
    q, k, v, bias, mask = _torch(make_inputs(3 * s, b, 12, s, 64, kind), "cuda", dtype, dtype)
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(s), device=dev).to(dtype)
    before = _launches()
    got = forward_and_grads(ba.biased_attention, q, k, v, bias, mask, g)
    route = ba.kernel_route(dtype, 64)
    assert route == ("tensor_core" if dtype == torch.bfloat16 else "tf32")
    assert _launches() == [n + d for n, d in zip(before, ROUTE_LAUNCHES[route])]
    want = forward_and_grads(ba.biased_attention_reference, q, k, v, bias, mask, g)
    if dtype == torch.float32:
        assert (got[0] - want[0]).abs().max().item() <= F32_ATOL
    else:
        assert max_err_of_max(got[0], want[0]) <= BF16_RTOL_OF_MAX, max_err_of_max(got[0], want[0])
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got[1:], want[1:]):
        if w is None:
            assert a is None and kind == "none"
            continue
        assert a.dtype == w.dtype and torch.isfinite(a.float()).all(), name
        assert max_err_of_max(a, w) <= GRAD_REL[dtype], (name, max_err_of_max(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("s, b", [(33, 16), (601, 1)])
def test_both_forwards_agree_on_card(s, b):
    """On the same bf16 inputs the tensor-core forward stays within
    1e-2 x max|ref| of the CUDA-core one, which keeps P in f32."""
    _card()
    q, k, v, bias, mask = _torch(make_inputs(s + 11, b, 12, s, 64), "cuda")
    fused = ba.biased_attention_fwd_fused(q, k, v, bias, mask, 0.125)
    cuda_core = ba.biased_attention_fwd(q, k, v, bias, mask, 0.125)
    assert max_err_of_max(fused, cuda_core) <= BF16_RTOL_OF_MAX
