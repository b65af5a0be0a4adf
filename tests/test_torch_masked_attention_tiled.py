"""The tiled tensor-core route of the port's tower attention
(``ops/masked_attention.py``, "tensor_core_tiled": bf16 at DH 16, 32, 64 and
128 outside the one-pass kernels' DH 64 and S <= 256), on the CPU.

- The route table: bf16 at every DH against S = 1, 256, 257, 300, 1024, and
  float32 still on "tf32".
- The new wrappers' arguments, through a stand-in library: the C function's
  argument list in ``cuda_lib``'s order, one launch counted; their input
  checks raise before any build.
- ``MaskedAttention`` on the route: the tiled forward, then the dq and dk/dv
  kernels, each once (stood in for on CPU tensors).
- The plain version, which the wrappers take on CPU tensors and which
  ``chip_smoke.py`` holds the kernels to on the card, against the JAX
  package in float32 at rate 0 at the route's shapes: S = 300 and DH 16,
  32, 128, forward and gradients, with a capacity-padding row, against
  ``masked_attention_reference`` (``jax.vjp``) and against the Pallas kernel
  in interpret mode (``FORCE_KERNEL``, B = 1, H = 2, real rows only: the
  kernel spreads a fully masked row over its 8-padded S).
- One tiny ``MDTModel`` forward with both towers fused and a text length of
  300 against the JAX model (the Flax state built from the port's weights).

Tolerance: 1e-5 (rtol and atol on outputs; gradients within 1e-5 x their
largest magnitude): float32 sums in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.data.collator import collate as jax_collate
from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_batch_items as jax_items
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu.ops import masked_attention as jma
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import collate, to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_batch_items
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import to_flax_params

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5
IMG = (3, 32, 32)
TILED = ("masked_attention_fwd_tiled", "masked_attention_bwd_dq_tiled", "masked_attention_bwd_dkv_tiled")


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [1, 256, 257, 300, 1024])
def test_route_table(dh, s):
    """bf16 takes the one-pass tensor-core kernels at DH 64 and S <= 256 and
    the tiled ones everywhere else; float32 keeps the 3xTF32 kernels."""
    want = "tensor_core" if dh == 64 and s <= 256 else "tensor_core_tiled"
    assert ma.kernel_route(torch.bfloat16, dh, s) == want
    assert ma.kernel_route(torch.float32, dh, s) == "tf32"


def test_route_keeps_no_cuda_core_answer():
    """No shape of any dtype the kernels take reaches CUDA cores."""
    routes = {ma.kernel_route(dt, dh, s) for dt in (torch.float32, torch.bfloat16) for dh in (16, 32, 64, 128)
              for s in (1, 17, 256, 257, 516, 1024, 4096)}
    assert routes == {"tf32", "tensor_core", "tensor_core_tiled"}


def _tower_inputs(seed, b, h, s, dh, capacity_row=True):
    """numpy f32 q, k, v, g and a (B, S) key bias: ~30% of each row's keys
    padded (key 0 never), the last batch row a capacity-padding row."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(4))
    bias = np.where(rng.random((b, s)) < 0.3, ta.MASK_BIAS, 0.0).astype(np.float32)
    bias[:, 0] = 0.0
    if capacity_row:
        bias[-1] = ta.MASK_BIAS
    return q, k, v, g, bias


def _wrapper_args(which, dh=32, s=9):
    """The arguments of the tiled ``which`` wrapper (fwd, dq or dkv) on bf16
    CPU tensors."""
    q, k, v, g, bias = (torch.from_numpy(x) for x in _tower_inputs(3, 2, 3, s, dh))
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    stats, delta = torch.zeros(2, 2, 3, s), torch.zeros(2, 3, s)
    return {"fwd": (q, k, v, bias, dh ** -0.5, 0.3, 11, True),
            "dq": (q, k, v, q.clone(), g, bias, stats, dh ** -0.5, 0.3, 11),
            "dkv": (q, k, v, g, bias, stats, delta, dh ** -0.5, 0.3, 11)}[which]


# wrapper -> (library, C function, positions of the outputs it allocates)
WRAPPERS = {"fwd": ("masked_fwd_tiled", "masked_attention_fwd_tiled", (4, 5)),
            "dq": ("masked_bwd_tiled", "masked_attention_bwd_dq_tiled", (7, 8)),
            "dkv": ("masked_bwd_tiled", "masked_attention_bwd_dkv_tiled", (7, 8))}


@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_tiled_wrappers_pass_the_c_arguments(monkeypatch, which):
    """Each tiled wrapper launches its library's C function once with
    pointers, (B, H, S, DH), the scale, the split seed, the keep threshold,
    1 / (1 - rate) and the dtype code, in ``cuda_lib``'s argument order,
    and counts one launch. The device check is stood in for, so that CPU
    tensors reach the launch."""
    launched = []
    monkeypatch.setattr(cuda_lib, "launch", lambda lib, fn, dev, *args: launched.append((lib, fn, args)))
    monkeypatch.setattr(ma, "_check_tensor_core_inputs", lambda *a, **kw: None)
    wrapper = getattr(ma, TILED[("fwd", "dq", "dkv").index(which)])
    args = _wrapper_args(which)
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before + 1
    ((lib, fn, passed),) = launched
    want_lib, want_fn, outputs = WRAPPERS[which]
    assert (lib, fn) == (want_lib, want_fn)
    assert len(passed) + 1 == len(cuda_lib.ENTRY_POINTS[lib][fn])  # + the stream
    q = args[0]
    n_in = {"fwd": 4, "dq": 7, "dkv": 7}[which]
    inputs = [a for a in args[:n_in] if isinstance(a, torch.Tensor) or a is None]
    assert list(passed[:n_in]) == [None if t is None else t.data_ptr() for t in inputs]
    assert [passed[i] for i in outputs] == [t.data_ptr() for t in got]
    seed_lo, seed_hi, thr, keep_scale = ta.dropout_args(11, 0.3)
    assert passed[n_in + 2:] == (2, 3, 9, 32, pytest.approx(32 ** -0.5), seed_lo, seed_hi, thr,
                                 pytest.approx(keep_scale), ta.DTYPE_CODES[torch.bfloat16])
    assert got[0].shape == q.shape and got[0].dtype == torch.bfloat16
    assert got[1].dtype == (torch.bfloat16 if which == "dkv" else torch.float32)


@pytest.mark.parametrize("fault", ["float32", "misaligned", "stats_shape", "cpu", "head_dim"])
@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_tiled_wrappers_input_checks(monkeypatch, which, fault):
    """What the tiled wrappers refuse, before any build: float32 (the
    "tf32" route's), a tensor off a 16-byte boundary, malformed statistics,
    tensors off the card, a head dim the kernels do not take."""

    def no_build():
        raise AssertionError("an input check must raise before the build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    args = list(_wrapper_args(which, dh=48 if fault == "head_dim" else 32))
    if fault == "float32":
        args[:3] = [x.float() for x in args[:3]]
        if which != "fwd":
            args[3] = args[3].float()
            if which == "dq":
                args[4] = args[4].float()
    elif fault == "misaligned":
        args[0] = torch.zeros(args[0].numel() + 1, dtype=torch.bfloat16)[1:].view(args[0].shape)
    elif fault == "stats_shape":
        if which == "fwd":
            args[1] = args[1][:, :, :-1].contiguous()  # k of another shape
        else:
            args[6 if which == "dq" else 5] = torch.zeros(2, 3, 9)
    with pytest.raises((ValueError, TypeError)):
        getattr(ma, TILED[("fwd", "dq", "dkv").index(which)])(*args)


def test_function_takes_the_tiled_kernels(monkeypatch):
    """``MaskedAttention`` on bf16 at S = 300: the tiled forward with the
    statistics, then the dq kernel and the dk/dv kernel with the forward's
    saved tensors, each once; nothing of the one-pass or 3xTF32 kernels.
    The kernels are stood in for on CPU tensors."""
    calls = []

    def fwd(q, k, v, key_bias, scale, rate, seed, with_stats):
        calls.append(("fwd", with_stats))
        out = ma.masked_attention_dropout_reference(q, k, v, key_bias, seed, rate, scale)
        return out, torch.zeros((2,) + q.shape[:3]) if with_stats else None

    def dq(q, k, v, out, g, key_bias, stats, scale, rate, seed):
        calls.append(("dq", tuple(stats.shape)))
        return torch.zeros_like(q), torch.zeros(q.shape[:3])

    def dkv(q, k, v, g, key_bias, stats, delta, scale, rate, seed):
        calls.append(("dkv", tuple(delta.shape)))
        return torch.zeros_like(k), torch.zeros_like(v)

    for name, fn in zip(TILED, (fwd, dq, dkv)):
        monkeypatch.setattr(ma, name, fn)
    for name in ("masked_attention_fwd_fused", "masked_attention_bwd_fused", "masked_attention_fwd_tf32",
                 "masked_attention_bwd_dq_tf32", "masked_attention_bwd_dkv_tf32"):
        monkeypatch.setattr(ma, name, lambda *a, **kw: pytest.fail("not this route's kernel"))
    q, k, v, _, bias = (torch.from_numpy(x) for x in _tower_inputs(4, 1, 2, 300, 64))
    q, k, v = (x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    ma.MaskedAttention.apply(q, k, v, bias, 3, 0.2, 0.125).float().sum().backward()
    assert calls == [("fwd", True), ("dq", (2, 1, 2, 300)), ("dkv", (1, 2, 300))]
    assert q.grad.dtype == torch.bfloat16 and v.grad.shape == v.shape


def _port(q, k, v, bias, g):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ma.masked_attention(*leaves, None if bias is None else torch.from_numpy(bias))
    out.backward(torch.from_numpy(g))
    return [out.detach().numpy()] + [x.grad.numpy() for x in leaves]


def _jax(fn, q, k, v, g):
    """fn's output and its vjp of g, in one jit (one compile per shape)."""

    def run(q_, k_, v_, g_):
        out, vjp = jax.vjp(fn, q_, k_, v_)
        return (out, *vjp(g_))

    return [np.asarray(x) for x in jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, g)))]


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for name, a, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert np.abs(a - w).max() <= GRAD_REL * max(np.abs(w).max(), 1e-6), name


@pytest.mark.parametrize("s, dh", [(300, 64), (104, 16), (300, 32), (104, 128)])
def test_plain_version_matches_jax_at_the_tiled_shapes(monkeypatch, s, dh):
    """The port's plain version (what the tiled kernels are held to) against
    JAX in f32 at rate 0: the XLA reference at B = 2 with a capacity-padding
    row, and the Pallas kernel in interpret mode at B = 1, H = 2."""
    q, k, v, g, bias = _tower_inputs(s + dh, 2, 2, s, dh)
    jb = jnp.asarray(bias)
    _assert_close(_port(q, k, v, bias, g), _jax(lambda *a: jma.masked_attention_reference(*a, jb), q, k, v, g))
    monkeypatch.setattr(jma, "FORCE_KERNEL", True)
    one = [x[:1] for x in (q, k, v, g)]
    _assert_close(_port(*one[:3], bias[:1], one[3]),
                  _jax(lambda *a: jma.masked_attention(*a, jb[:1]), *one))


def test_mdt_model_with_fused_towers_at_text_300_matches_jax():
    """The tiny model with both towers fused and a text length of 300 (302
    with the bottleneck tokens in the fusion layers), deterministic: logits
    on real node slots and the global embedding against JAX's, from the
    port's weights. JAX runs its towers' XLA path here (the Pallas kernel
    in interpret mode is held above)."""

    def cfg(mod):
        c = mod.tiny_model_config()
        c = c.replace(text_tower=dataclasses.replace(c.text_tower, max_position_embeddings=320))
        return c.replace(text_tower=dataclasses.replace(c.text_tower, use_pallas_attention=True),
                         image_tower=dataclasses.replace(c.image_tower, use_pallas_attention=True))

    item_kw = dict(seed=17, seq_len=300, vocab_size=128, image_shape=IMG, max_nodes=6, image_prob=0.5)
    jb = jax_collate(jax_items(2, **item_kw), image_shape=IMG)
    pb = collate(synthetic_batch_items(2, **item_kw), image_shape=IMG)
    for key, val in jb.asdict().items():
        np.testing.assert_array_equal(val, pb.asdict()[key], err_msg=key)
    assert pb.input_ids.shape[-1] == 300
    port = MDTModel(cfg(pconfig), generator=torch.Generator().manual_seed(2)).eval()
    params = jax.tree.map(jnp.asarray, to_flax_params(port))
    want = jax.jit(lambda p, b: JaxMDTModel(cfg(jconfig)).apply(p, b, deterministic=True))(
        params, {k: jnp.asarray(v) for k, v in jb.asdict().items()})
    before = [fn.launches for fn in ma.KERNELS]
    with torch.no_grad():
        got = port(to_tensors(pb, "cpu"))
    assert [fn.launches for fn in ma.KERNELS] == before
    mask = pb.node_mask
    np.testing.assert_allclose(got.logits.numpy()[mask], np.asarray(want.logits)[mask], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.global_embedding.numpy(), np.asarray(want.global_embedding), rtol=2e-4, atol=2e-5)
