"""Ring (sequence-parallel) tree attention over an ``sp`` process group: the
port of the JAX package's ``ops/ring_attention.py``.

The node axis S of the graph grid is cut into n equal strips, one per rank
of the group (S padded to a multiple of n). Each rank holds:
- q, k and v of its strip, (B, H, S/n, dh);
- its q-row strip of the compact bias inputs, template and ids (B, S/n, S):
  the O(S^2) structure is itself cut 1/n per rank;
- the replicated (32, H) LUT.

Forward (``RingTreeAttention``): n steps; at step t the rank holds the k/v
block of strip ``(rank - t) mod n``, takes the (B, S/n, S/n) column block of
its template and ids strip for that block (a contiguous copy), and computes
the square tile's (out, lse) with the tree-attention forward; the tile's
result merges into the running (out, lse) in f32 (``out = sum_t
exp(lse_t - lse) out_t``, ``lse = logsumexp_t lse_t``); then the k/v block
moves one rank along the ring (``parallel/comm.py::ring_shift``). A tile
whose rows are all masked (the last strip's padded block) has lse = -1e9 +
log(1e-30) and zero output, so it merges with weight 0.

Backward: the ring again, each tile through the dq kernel and the dk/dv
kernel fed the MERGED lse and the merged output (whose row dot with the
cotangent is the delta both take): dq accumulates on the rank, dK and dV
travel with their block and are home after n hops, and dLUT is summed over
the rank's tiles. The sum of dLUT over the group is left to the caller,
with the other replicated parameters' gradients (the trainer's all-reduce
over the data and sp axes).

Tiles go to the port's tree kernels (``ops/tree_attention.py``): on CUDA
tensors the route ``ta.kernel_route`` names (bf16 at dh 64: the tensor-core
forward with LSE and the tensor-core dq and dk/dv kernels; float32: the
CUDA-core K1 and the 3xTF32 dq and dk/dv kernels), which raise if a launch
fails; on CPU tensors the
plain versions of the same three tile functions (``tile_forward_plain``,
``tile_dq_plain``, ``tile_dkv_plain``). The JAX ring is XLA-level, not
Pallas, and so is the merge here: torch ops.

Attention dropout: each tile's Philox seed is ``tile_seed(seed, shard,
strip, block, n)``, the layer's seed folded with the data-parallel shard,
the rank's strip and the k/v block (JAX folds the strip and the block into
its key, and the dp shard into the seed, ``:87-88, 107-110, 208-217``); the
backward regenerates the same per-tile masks. As in JAX the mask drops
terms of the value sum, never the normalizer: dropout(softmax(s)) v, tile
by tile. The bits differ from JAX's (TPU PRNG).

Entry points:
- ``ring_tree_attention_local``: the per-rank body on strips (what the
  model's graph layers call: their activations are strips);
- ``ring_tree_attention_dispatch``: whole arrays on every rank; pads S to a
  multiple of n with template columns at MASK_BIAS, runs the ring on this
  rank's strip and returns the whole output with the padded rows sliced off
  (JAX ``:151-243``);
- ``ring_tree_attention_reference``: the plain ring in one process over all
  n strips (JAX's loop of ``ring_tree_attention_local``), differentiable by
  autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import fold_seed
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from multimodaldiscussiontransformer_tpu_torch.ops.tree_attention import MASK_BIAS
from multimodaldiscussiontransformer_tpu_torch.parallel.comm import gather_dim, ring_shift


def tile_seed(seed: int, shard: int, strip: int, block: int, n: int) -> int:
    """The Philox seed of the tile (q strip ``strip``, k/v block ``block``)
    of data-parallel shard ``shard`` on a ring of ``n``."""
    return fold_seed(seed, 1 + (shard * n + strip) * n + block)


# ---------------------------------------------------------------------------
# the plain ring, one process
# ---------------------------------------------------------------------------


def ring_tree_attention_reference(
    q, k, v, template, ids, lut, n: int, scale: Optional[float] = None, double_add: bool = True,
    seed: int = 0, rate: float = 0.0, shard: int = 0,
) -> torch.Tensor:
    """The ring over all ``n`` strips in one process, in f32, returned in q's
    dtype: q, k, v (B, H, S, dh) and template, ids (B, S, S) with S a
    multiple of ``n``. Strip r visits the k/v blocks r, r-1, ... (mod n) with
    the online softmax of JAX ``ring_tree_attention_local`` (row max from
    MASK_BIAS, the undropped normalizer clamped at 1e-30)."""
    b, h, s, dh = q.shape
    if s % n:
        raise ValueError(f"S={s} is not a multiple of the ring size {n}")
    scale = dh ** -0.5 if scale is None else scale
    c = s // n
    outs = []
    for r in range(n):
        qr = q[:, :, r * c:(r + 1) * c].float() * scale
        m = torch.full((b, h, c, 1), MASK_BIAS, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, c, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, c, dh), dtype=torch.float32, device=q.device)
        for t in range(n):
            src = (r - t) % n
            cols = slice(src * c, (src + 1) * c)
            bias = ta.assemble_bias(template[:, r * c:(r + 1) * c, cols], ids[:, r * c:(r + 1) * c, cols], lut,
                                    double_add)
            sc = torch.einsum("bhqd,bhkd->bhqk", qr, k[:, :, cols].float()) + bias
            # the max cancels in the quotient; detached, ties stay out of autograd
            m_new = torch.maximum(m, sc.detach().amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            if rate > 0.0:
                keep = ta.dropout_keep_mask(tile_seed(seed, shard, r, src, n), b, h, c, rate, q.device)
                p = torch.where(keep, p, 0.0) / (1.0 - rate)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, cols].float())
            m = m_new
        outs.append(acc / l.clamp_min(1e-30))
    return torch.cat(outs, dim=2).to(q.dtype)


# ---------------------------------------------------------------------------
# one square tile: the plain versions of the three tree kernels
# ---------------------------------------------------------------------------


def _tile_scores(q, k, template, ids, lut, scale, double_add):
    return torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float()) + ta.assemble_bias(template, ids, lut,
                                                                                            double_add)


def _tile_keep(q, rate, seed):
    b, h, s, _ = q.shape
    return ta.dropout_keep_mask(seed, b, h, s, rate, q.device)


def tile_forward_plain(q, k, v, template, ids, lut, scale, double_add, rate, seed) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of one tile, as the forward kernels compute them: row max
    from MASK_BIAS, lse = m + log(max(l, 1e-30)) with l the undropped sum,
    out = sum keep e v / ((1 - rate) max(l, 1e-30)) in q's dtype."""
    sc = _tile_scores(q, k, template, ids, lut, scale, double_add)
    m = sc.amax(dim=-1, keepdim=True).clamp_min(MASK_BIAS)
    e = torch.exp(sc - m)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if rate > 0.0:
        e = torch.where(_tile_keep(q, rate, seed), e, 0.0) / (1.0 - rate)
    out = torch.einsum("bhqk,bhkd->bhqd", e, v.float()) / denom
    return out.to(q.dtype), (m + torch.log(denom))[..., 0]


def _tile_probs(q, k, template, ids, lut, lse, scale, double_add):
    return torch.exp(_tile_scores(q, k, template, ids, lut, scale, double_add) - lse[..., None])


def tile_dq_plain(q, k, v, out, g, template, ids, lut, lse, scale, double_add, rate, seed):
    """(dq, dlut (32, H) f32, delta (B, H, S) f32) of one tile from the lse
    and out given, as the dq kernels compute them: delta = rowsum(g out),
    dS = P (dP - delta) with dP the dropped g v^T, dq = scale dS k, dlut the
    sum of dS by id (ids 1 .. 31)."""
    p = _tile_probs(q, k, template, ids, lut, lse, scale, double_add)
    gf = g.float()
    delta = (gf * out.float()).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, v.float())
    if rate > 0.0:
        dp = torch.where(_tile_keep(q, rate, seed), dp, 0.0) / (1.0 - rate)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    h = q.shape[1]
    valid = (ids > 0) & (ids < ta.LUT_SIZE)
    flat = torch.where(valid, ids.long(), 0)[:, None].expand_as(ds).reshape(-1)
    per_head = torch.arange(h, device=q.device).view(1, h, 1, 1).expand_as(ds).reshape(-1)
    dlut = torch.zeros(ta.LUT_SIZE * h, dtype=torch.float32, device=q.device)
    dlut.index_add_(0, flat * h + per_head, ds.reshape(-1))
    dlut = dlut.view(ta.LUT_SIZE, h)
    dlut[0] = 0.0
    return dq.to(q.dtype), dlut, delta


def tile_dkv_plain(q, k, v, g, template, ids, lut, lse, delta, scale, double_add, rate, seed):
    """(dk, dv) of one tile from the lse and delta given, as the dk/dv
    kernels compute them."""
    p = _tile_probs(q, k, template, ids, lut, lse, scale, double_add)
    gf = g.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, v.float())
    pv = p
    if rate > 0.0:
        keep = _tile_keep(q, rate, seed)
        pv = torch.where(keep, p, 0.0) / (1.0 - rate)
        dp = torch.where(keep, dp, 0.0) / (1.0 - rate)
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", pv, gf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def tile_ops(q: torch.Tensor):
    """(forward, dq, dk/dv) for tiles of q's device, dtype and head dim: the
    kernels ``ta.kernel_route`` names on CUDA tensors, the plain versions on
    CPU tensors."""
    if q.device.type == "cpu":
        return tile_forward_plain, tile_dq_plain, tile_dkv_plain
    if q.device.type != "cuda":
        raise ValueError(f"ring tree attention runs on cpu or cuda, not {q.device}")
    route = ta.kernel_route(q.dtype, q.shape[-1])
    if route == "tensor_core":
        fwd, dq, dkv = ta.tree_attention_fwd_fused, ta.tree_attention_bwd_dq_fused, ta.tree_attention_bwd_dkv_fused
    elif route == "tf32":
        fwd, dq, dkv = ta.tree_attention_fwd, ta.tree_attention_bwd_dq_tf32, ta.tree_attention_bwd_dkv_tf32
    else:
        fwd, dq, dkv = ta.tree_attention_fwd, ta.tree_attention_bwd_dq, ta.tree_attention_bwd_dkv

    def forward(q_, k_, v_, t_, i_, l_, scale, double_add, rate, seed):
        return fwd(q_, k_, v_, t_, i_, l_, scale, double_add, rate, seed, with_lse=True)

    return forward, dq, dkv


# ---------------------------------------------------------------------------
# the distributed ring
# ---------------------------------------------------------------------------


class RingTreeAttention(torch.autograd.Function):
    """The ring over ``group``: q, k, v (B, H, c, dh) of this rank's strip,
    template and ids (B, c, n c) its q-row strips (f32, int32), the (32, H)
    f32 LUT. Returns the strip's output in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, template, ids, lut, group, seed: int, rate: float, scale: float, double_add: bool,
                shard: int):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        c = q.shape[2]
        fwd, _, _ = tile_ops(q)
        kv = torch.stack([k, v])
        out = lse = None
        for t in range(n):
            src = (rank - t) % n
            cols = slice(src * c, (src + 1) * c)
            o_t, lse_t = fwd(q, ta.aligned16(kv[0]), ta.aligned16(kv[1]), template[:, :, cols].contiguous(),
                             ids[:, :, cols].contiguous(), lut, scale, double_add, rate,
                             tile_seed(seed, shard, rank, src, n))
            if out is None:
                out, lse = o_t.float(), lse_t
            else:
                new = torch.logaddexp(lse, lse_t)
                out = out * torch.exp(lse - new)[..., None] + o_t.float() * torch.exp(lse_t - new)[..., None]
                lse = new
            if t < n - 1:
                kv = ring_shift(kv, group)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, template, ids, lut, out, lse)
        ctx.args = (group, seed, rate, scale, double_add, shard)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, template, ids, lut, out, lse = ctx.saved_tensors
        group, seed, rate, scale, double_add, shard = ctx.args
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        c = q.shape[2]
        _, dq_tile, dkv_tile = tile_ops(q)
        q, out, g = (ta.aligned16(x) for x in (q, out, g))
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dlut = torch.zeros(lut.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32, device=q.device)
        for t in range(n):
            src = (rank - t) % n
            cols = slice(src * c, (src + 1) * c)
            kb, vb = ta.aligned16(kv[0]), ta.aligned16(kv[1])
            tpl_t, ids_t = template[:, :, cols].contiguous(), ids[:, :, cols].contiguous()
            sd = tile_seed(seed, shard, rank, src, n)
            dq_t, dlut_t, delta = dq_tile(q, kb, vb, out, g, tpl_t, ids_t, lut, lse, scale, double_add, rate, sd)
            dk_t, dv_t = dkv_tile(q, kb, vb, g, tpl_t, ids_t, lut, lse, delta, scale, double_add, rate, sd)
            dq += dq_t.float()
            dlut += dlut_t
            dkv[0] += dk_t.float()
            dkv[1] += dv_t.float()
            if t < n - 1:
                kv = ring_shift(kv, group)
            # the block's gradient travels with it: home after n hops
            dkv = ring_shift(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None,
                dlut if ctx.needs_input_grad[5] else None, None, None, None, None, None, None)


def ring_tree_attention_local(
    q: torch.Tensor,  # (B, H, c, dh) this rank's strip
    k: torch.Tensor,
    v: torch.Tensor,
    template: torch.Tensor,  # (B, c, n c) f32 q-row strip
    ids: torch.Tensor,  # (B, c, n c) int32
    lut: torch.Tensor,  # (LUT_SIZE, H) f32
    group,
    scale: Optional[float] = None,
    double_add: bool = True,
    rate: float = 0.0,
    seed: Optional[int] = None,
    shard: int = 0,
) -> torch.Tensor:
    """The per-rank body over ``group`` (JAX ``ring_tree_attention_local``):
    this rank's (B, H, c, dh) output. ``calls`` counts the calls."""
    n = dist.get_world_size(group)
    b, h, c, dh = q.shape
    if template.shape != (b, c, n * c) or ids.shape != (b, c, n * c):
        raise ValueError(f"template and ids must be ({b}, {c}, {n * c}) strips, got {tuple(template.shape)} and "
                         f"{tuple(ids.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"k and v must share q's shape {tuple(q.shape)}")
    scale = dh ** -0.5 if scale is None else scale
    ta.check_rate(rate, seed)
    ring_tree_attention_local.calls += 1
    return RingTreeAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), template.float().contiguous(),
                                   ids.to(torch.int32).contiguous(), lut.float().contiguous(), group,
                                   0 if seed is None else int(seed), float(rate), float(scale), double_add, int(shard))


ring_tree_attention_local.calls = 0


def pad_compact(q, k, v, template, ids, n: int):
    """q, k, v (B, H, S, dh) and template, ids (B, S, S) padded to S' = a
    multiple of ``n``: zero rows of q/k/v, template rows and columns at
    MASK_BIAS (the padded keys add nothing; the padded rows are all masked
    and give zeros), ids 0."""
    pad = -q.shape[2] % n
    if not pad:
        return q, k, v, template.float(), ids

    def rows(t):
        return torch.nn.functional.pad(t, (0, 0, 0, pad))

    tpl = torch.nn.functional.pad(template.float(), (0, pad, 0, pad), value=MASK_BIAS)
    return rows(q), rows(k), rows(v), tpl, torch.nn.functional.pad(ids, (0, pad, 0, pad))


def ring_tree_attention_dispatch(
    q, k, v, template, ids, lut, group, scale: Optional[float] = None, double_add: bool = True,
    rate: float = 0.0, seed: Optional[int] = None, shard: int = 0,
) -> torch.Tensor:
    """Whole arrays on every rank of ``group`` (q, k, v (B, H, S, dh),
    template and ids (B, S, S)): S padded to a multiple of the group size
    (``pad_compact``), this rank's strip through the ring, every rank's
    strip gathered, and the padded rows sliced off (JAX
    ``ring_tree_attention_dispatch``). No gradient flows through the
    gather: a differentiable caller holds strips and calls
    ``ring_tree_attention_local``."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    s = q.shape[2]
    qp, kp, vp, tpl, idp = pad_compact(q, k, v, template, ids, n)
    c = qp.shape[2] // n
    rows = slice(rank * c, (rank + 1) * c)
    out = ring_tree_attention_local(qp[:, :, rows], kp[:, :, rows], vp[:, :, rows], tpl[:, rows], idp[:, rows], lut,
                                    group, scale, double_add, rate, seed, shard)
    return gather_dim(out.detach().contiguous(), 2, group)[:, :, :s]

