"""The port's dense-bias attention (``ops/biased_attention.py``) and the graph
layers' dense-bias fused branch against the JAX package, on the CPU.

- The plain forward against JAX's ``_biased_attention_fused``, which runs
  the Pallas kernel in interpret mode here: S = 17 and 33 (not multiples of
  8), per-head, head-shared and no bias, -inf entries and key padding;
  float32 within atol 1e-5 and rtol 1e-5, bfloat16 inputs within one bf16
  step (rtol 2^-7, atol 1e-5: both compute in f32 from the same bf16 inputs
  and round the output once).
- The Function's dq/dk/dv/dbias against ``jax.vjp`` of
  ``_biased_attention_fused`` (its custom VJP), per-head and shared, at rtol
  2e-4 / atol 1e-5 as ``tests/test_biased_attention.py`` holds JAX's own.
- -inf entries, a fully masked row included, leave every gradient finite.
- A row whose every key is masked: equal weights over the S keys in the
  port; the Pallas kernel spreads it over its 8-padded S, JAX's XLA
  reference over the padded keys.
- ``BiasedMultiheadAttention`` with ``use_pallas_attention`` and a dense
  bias, and the slice's path (``GraphNodeFeature`` -> dense
  ``GraphAttnBias`` -> two ``GraphEncoderStack``), with weights carried
  across, against the JAX modules (which take their XLA route on the CPU):
  forward and every parameter's gradient in float32, at 1e-5 (forward) and
  1e-4 x max|grad| + 1e-6 (sums in other orders through the layers).
- Dispatch: deterministic, or training at attention dropout 0, takes the
  op; training at a rate > 0 keeps ``FastDropout``.
"""

import importlib
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodaldiscussiontransformer_tpu.core.config import tiny_model_config as jax_tiny_config
from multimodaldiscussiontransformer_tpu.models import graphormer as jgraph
from multimodaldiscussiontransformer_tpu_torch.core.config import tiny_model_config
from multimodaldiscussiontransformer_tpu_torch.models import graphormer
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import dropout_rngs
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict
from test_torch_biased_attention_card import forward_and_grads, make_inputs, to_torch
from test_torch_models import batch_pair, perturbed

jba = importlib.import_module("multimodaldiscussiontransformer_tpu.ops.biased_attention")
ba = importlib.import_module("multimodaldiscussiontransformer_tpu_torch.ops.biased_attention")

torch.set_num_threads(2)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
VJP_TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_REL = 1e-4
# k_proj's bias has a gradient of 0 in exact arithmetic (softmax ignores a
# constant added to a row's scores): both sides give float noise of ~1e-7
GRAD_ATOL = 1e-6
SCALE = 8 ** -0.5


def _jax_fused(q, k, v, bias, mask):
    return jba._biased_attention_fused(q, k, v, bias, None if mask is None else jnp.asarray(mask), SCALE)


@pytest.mark.parametrize(
    "s, kind, dtype",
    [(17, "head", "float32"), (33, "shared", "float32"), (33, "none", "float32"),
     (17, "shared", "bfloat16"), (33, "head", "bfloat16")],
)
def test_plain_forward_matches_jax_kernel(s, kind, dtype):
    arrays = make_inputs(s, 2, 2, s, 8, kind)
    q, k, v, bias, mask = to_torch(arrays, dtype=getattr(torch, dtype))
    got = ba.biased_attention(q, k, v, bias, mask, scale=SCALE)
    jdt = jnp.dtype(dtype)
    want = _jax_fused(*(jnp.asarray(a, jdt) for a in arrays[:3]),
                      None if bias is None else jnp.asarray(arrays[3], jdt), arrays[4])
    assert got.dtype == q.dtype and str(want.dtype) == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("kind", ["head", "shared"])
def test_function_grads_match_jax_custom_vjp(kind):
    arrays = make_inputs(40, 2, 3, 17, 8, kind)
    g = np.random.default_rng(41).standard_normal(arrays[0].shape).astype(np.float32)
    def run(q, k, v, b, g_):  # one jit: the eager vjp compiles op by op
        out, vjp = jax.vjp(lambda *a: _jax_fused(*a, arrays[4]), q, k, v, b)
        return (out, *vjp(g_))

    want = jax.jit(run)(*map(jnp.asarray, arrays[:4]), jnp.asarray(g))
    got = forward_and_grads(ba.biased_attention, *to_torch(arrays), torch.from_numpy(g))
    for name, a, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **VJP_TOL, err_msg=name)


def test_inf_entries_leave_every_gradient_finite():
    """-inf bias entries, and a row whose every key is -inf: finite output
    and gradients from the Function and from autograd of the plain version."""
    q, k, v, bias, mask = to_torch(make_inputs(42, 2, 3, 17, 8, "shared"))
    bias[0, 0, 4] = -np.inf
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(42))
    for fn in (ba.biased_attention, ba.biased_attention_reference):
        for x in forward_and_grads(fn, q, k, v, bias, mask, g):
            assert torch.isfinite(x).all()


def test_all_masked_row():
    """Row 4 of batch row 0 has every key at -inf and two keys padded. The
    port gives it equal weights over its S real keys; the Pallas kernel over
    its 8-padded S (zero-padded keys included: sum(v) / 24); JAX's XLA
    reference puts all the weight on the two padded keys. Every other row
    agrees with the kernel."""
    b, h, s = 2, 2, 17
    q, k, v, bias, _ = make_inputs(43, b, h, s, 8, "head", pad=False)
    bias[0, :, 4] = -np.inf
    mask = np.zeros((b, s), bool)
    mask[:, [5, 9]] = True
    got = ba.biased_attention(*to_torch((q, k, v, bias, mask)), scale=SCALE).numpy()
    kernel = np.asarray(_jax_fused(*map(jnp.asarray, (q, k, v, bias)), mask))
    xla = np.asarray(jba.biased_attention_reference(*map(jnp.asarray, (q, k, v, bias, mask)), SCALE))
    np.testing.assert_allclose(got[0, :, 4], v[0].mean(axis=1), **F32_TOL)
    np.testing.assert_allclose(kernel[0, :, 4], v[0].sum(axis=1) / 24, **F32_TOL)
    np.testing.assert_allclose(xla[0, :, 4], v[0][:, [5, 9]].mean(axis=1), **F32_TOL)
    rest = np.ones(got.shape[:3], bool)
    rest[0, :, 4] = False
    np.testing.assert_allclose(got[rest], kernel[rest], **F32_TOL)


def _graph_inputs(seed):
    """Collated template, spatial ids, degrees and the (B, S) pad mask, and
    random node states, for synthetic trees of up to 8 nodes."""
    jb, _ = batch_pair(seed, image_prob=0.0)
    b, n = jb.in_degree.shape
    x = np.random.default_rng(seed).standard_normal((b, n, 64)).astype(np.float32)
    kpm = np.concatenate([np.zeros((b, 1), bool), ~jb.grid_mask], axis=1)
    return dict(x=x, in_degree=jb.in_degree, out_degree=jb.out_degree, template=jb.attn_bias,
                spatial=jb.spatial_pos, kpm=kpm)


@pytest.mark.parametrize("kind", ["head", "shared", "none"])
def test_biased_multihead_attention_fused_matches_jax(kind, monkeypatch):
    """The fused dense branch with key padding, deterministic, against the
    JAX layer with ``use_pallas_attention`` from the same weights; the
    port's layer calls the op once."""
    inp = _graph_inputs(8)
    b, s, _ = inp["template"].shape
    bias = None
    if kind != "none":
        bias = np.random.default_rng(9).standard_normal((b, 4 if kind == "head" else 1, s, s)).astype(np.float32)
        bias += inp["template"][:, None]  # -inf where the collator masks
    x = np.random.default_rng(10).standard_normal((b, s, 64)).astype(np.float32)
    jcfg = jax_tiny_config(use_pallas_attention=True)
    mod = jgraph.BiasedMultiheadAttention(jcfg)
    jargs = (jnp.asarray(x), None if bias is None else jnp.asarray(bias), jnp.asarray(inp["kpm"]))
    params = perturbed(jax.jit(lambda r: mod.init(r, *jargs))(jax.random.PRNGKey(0)))  # jitted: see above
    want = np.asarray(jax.jit(mod.apply)(params, *jargs))
    port = graphormer.BiasedMultiheadAttention(tiny_model_config(use_pallas_attention=True), torch.float32)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    calls = _count_op_calls(monkeypatch)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if bias is None else torch.from_numpy(bias),
                   torch.from_numpy(inp["kpm"])).numpy()
    assert calls == [1]
    np.testing.assert_allclose(got, want, **F32_TOL)


class JaxDensePath(fnn.Module):
    """The slice's path in the JAX package: node features, the dense bias,
    graph stacks with a key-padding mask."""

    config: Any
    num_stacks: int

    @fnn.compact
    def __call__(self, x, in_degree, out_degree, template, spatial, kpm):
        c = self.config
        h = jgraph.GraphNodeFeature(c, name="graph_node_feature")(x, in_degree, out_degree)
        bias = jgraph.GraphAttnBias(c, name="graph_attn_bias")(template, spatial)
        for i in range(self.num_stacks):
            h = jgraph.GraphEncoderStack(c, c.num_graph_stack, name=f"graph_stack_{i}")(h, bias, kpm, True)
        return h


class DensePath(nn.Module):
    """The same path from the port's modules."""

    def __init__(self, config, num_stacks):
        super().__init__()
        self.graph_node_feature = graphormer.GraphNodeFeature(config, torch.float32)
        self.graph_attn_bias = graphormer.GraphAttnBias(config, torch.float32)
        self.stacks = [graphormer.GraphEncoderStack(config, config.num_graph_stack, torch.float32)
                       for _ in range(num_stacks)]
        for i, st in enumerate(self.stacks):
            self.add_module(f"graph_stack_{i}", st)

    def forward(self, x, in_degree, out_degree, template, spatial, kpm, deterministic=True):
        h = self.graph_node_feature(x, in_degree, out_degree)
        bias = self.graph_attn_bias(template, spatial)
        for st in self.stacks:
            h = st(h, bias, kpm, deterministic)
        return h


def _count_op_calls(monkeypatch):
    """Count the graph layer's calls of the fused op."""
    calls = [0]
    op = graphormer.biased_attention

    def counted(*a, **kw):
        calls[0] += 1
        return op(*a, **kw)

    monkeypatch.setattr(graphormer, "biased_attention", counted)
    return calls


def test_dense_path_forward_and_grads_match_jax(monkeypatch):
    """GraphNodeFeature -> dense GraphAttnBias -> 2 x GraphEncoderStack with
    the fused branch (one op call per layer), float32: the output and the gradient of
    every parameter, the bias tables' through dbias, against JAX's."""
    inp = _graph_inputs(11)
    names = ("x", "in_degree", "out_degree", "template", "spatial", "kpm")
    jcfg = jax_tiny_config(use_pallas_attention=True, dropout=0.0, act_dropout=0.0)
    mod = JaxDensePath(jcfg, 2)
    jargs = [jnp.asarray(inp[n]) for n in names]
    # jitted init and vjp: eagerly each op compiles on its own
    params = perturbed(jax.jit(mod.init)(jax.random.PRNGKey(0), *jargs))
    cot = np.random.default_rng(12).standard_normal(jax.eval_shape(mod.apply, params, *jargs).shape).astype(np.float32)

    def run(p, c):
        out, jvjp = jax.vjp(lambda p_: mod.apply(p_, *jargs), p)
        return out, jvjp(c)[0]

    want, jgrad_tree = jax.jit(run)(params, jnp.asarray(cot))
    jgrads = flax_to_state_dict(jax.device_get(jgrad_tree))

    pcfg = tiny_model_config(use_pallas_attention=True, dropout=0.0, act_dropout=0.0)
    port = DensePath(pcfg, 2)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    calls = _count_op_calls(monkeypatch)
    targs = [torch.from_numpy(np.asarray(inp[n])) for n in names]
    targs[1], targs[2], targs[4] = (t.long() for t in (targs[1], targs[2], targs[4]))
    got = port(*targs)
    (got * torch.from_numpy(cot)).sum().backward()
    assert calls == [2 * pcfg.num_graph_stack]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert grads.keys() == jgrads.keys()
    for name in ("graph_attn_bias.spatial_pos_encoder", "graph_attn_bias.graph_token_virtual_distance"):
        assert grads[name].abs().max() > 0, name
    for name, g in grads.items():
        w = jgrads[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + GRAD_ATOL, (name, err, np.abs(w).max())


@pytest.mark.parametrize(
    "deterministic, rate, use_pallas, fused",
    [(True, 0.3, True, True), (False, 0.0, True, True), (False, 0.3, True, False), (True, 0.0, False, False)],
)
def test_dense_dispatch(monkeypatch, deterministic, rate, use_pallas, fused):
    """The fused op runs exactly where the JAX layer's ``use_fused`` holds:
    ``use_pallas_attention`` and (deterministic or attention dropout 0);
    training at rate > 0 drops the probabilities with ``FastDropout``."""
    cfg = tiny_model_config(use_pallas_attention=use_pallas, attention_dropout=rate)
    layer = graphormer.BiasedMultiheadAttention(cfg, torch.float32)
    for p in layer.parameters():
        nn.init.normal_(p, 0.0, 0.2, generator=torch.Generator().manual_seed(13))
    inp = _graph_inputs(14)
    b, s, _ = inp["template"].shape
    bias = torch.from_numpy(inp["template"])[:, None].expand(b, 4, s, s).contiguous()
    x = torch.randn(b, s, 64, generator=torch.Generator().manual_seed(15))
    calls = _count_op_calls(monkeypatch)
    dropped = []
    layer.dropout.register_forward_hook(lambda m, a, out: dropped.append(out is not a[0]))
    with dropout_rngs(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)), torch.no_grad():
        out = layer(x, bias, torch.from_numpy(inp["kpm"]), deterministic=deterministic)
    assert torch.isfinite(out).all()
    assert calls == [1 if fused else 0]
    assert dropped == ([] if fused else [not deterministic and rate > 0.0])
