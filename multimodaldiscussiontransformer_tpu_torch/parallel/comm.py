"""The collectives the port's parallel paths use, as autograd functions where
a gradient crosses them.

Every collective here but ``ring_shift`` on NCCL is an ``all_reduce``: gloo
carries only ``all_reduce`` and ``broadcast`` on CUDA tensors, and ranks
that share one card run over gloo. A gather is an ``all_reduce`` of a zero
buffer into which each rank wrote its own block (the sums add exact zeros).

Sequence parallelism (an ``sp`` group whose ranks hold strips of one node
axis) adds:
- ``ring_shift``: the counterpart of ``jax.lax.ppermute`` to the next rank
  of the ring (NCCL point-to-point; over gloo an all-reduce that moves n
  times the bytes);
- ``all_gather_dim``: every rank's block along a dim, differentiable (the
  gradient of a rank's block is the sum of every rank's gradient for it);
- ``reduce_scatter_dim``: the sum over the group, of which each rank keeps
  its block along a dim, differentiable (the gradient is every rank's
  block-gradient gathered);
- ``broadcast_from``: one rank's tensor on every rank, differentiable (the
  gradients of every rank are summed on the source, zero elsewhere).

Tensor parallelism follows Megatron's pair of regions:
- ``copy_to_group``: identity forward, gradient summed over the group
  backward (the input of a column-parallel projection, or a replicated
  parameter whose heads each rank slices);
- ``reduce_from_group``: summed forward, identity backward (the output of
  a row-parallel projection).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` summed (or reduced by ``op``) over ``group`` in place."""
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``t`` (equal shapes on every rank of ``group``)
    concatenated along ``dim`` in rank order; no gradient."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * size
    buf = t.new_zeros(shape)
    buf.narrow(dim, rank * n, n).copy_(t)
    return all_reduce_(buf, group)


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return gather_dim(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads every rank's block: sum the gradients of
        # all ranks, keep this rank's block
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.n, ctx.n), None, None


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, differentiable: the gradient of a rank's block is the sum of all
    ranks' gradients for it."""
    return _AllGatherDim.apply(x, dim, group)


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // dist.get_world_size(group)
        return all_reduce_(x.contiguous().clone(), group).narrow(dim, dist.get_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, of which this rank keeps
    its block along ``dim`` (``x.shape[dim]`` divides by the group size),
    differentiable: the gradient of ``x`` is every rank's block-gradient
    gathered along ``dim``."""
    return _ReduceScatterDim.apply(x, dim, group)


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.group, ctx.own = group, dist.get_rank(group) == src
        buf = x.detach().clone() if ctx.own else torch.zeros_like(x)
        return all_reduce_(buf, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return (g if ctx.own else torch.zeros_like(g)), None, None


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of ``group`` (every rank
    passes a tensor of the same shape), differentiable: the gradients of
    every rank are summed into ``src``'s ``x``; the others' get zeros."""
    return _BroadcastFrom.apply(x, src, group)


def shift_by_all_reduce(group, t: torch.Tensor) -> bool:
    """Whether ``ring_shift`` takes the all-reduce form: over gloo with a
    CUDA tensor (gloo has no point-to-point on CUDA tensors)."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """Rank r's ``t`` on rank r + 1 (mod the group size): every rank sends
    its tensor to the next rank of the ring and returns the previous rank's
    (equal shapes and dtypes on every rank; no gradient). On NCCL, and on
    gloo with CPU tensors, one ``batch_isend_irecv`` pair; on gloo with CUDA
    tensors, an ``all_reduce`` of an (n, ...) zero buffer holding each
    rank's tensor in its row, which moves n times the bytes."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    t = t.contiguous()
    if n == 1:
        return t.clone()
    if shift_by_all_reduce(group, t):
        buf = t.new_zeros((n,) + tuple(t.shape))
        buf[rank].copy_(t)
        return all_reduce_(buf, group)[(rank - 1) % n].clone()
    out = torch.empty_like(t)
    pg = group if group is not None else dist.group.WORLD
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(pg, (rank + 1) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(pg, (rank - 1) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def any_rank(flag: bool, group, device: Optional[torch.device] = None) -> bool:
    """Whether ``flag`` is true on any rank of ``group`` (one MAX all-reduce
    of a scalar on ``device``)."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(all_reduce_(t, group, dist.ReduceOp.MAX).item() > 0)
