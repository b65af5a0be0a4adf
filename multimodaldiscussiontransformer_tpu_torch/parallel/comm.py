"""The collectives the port's parallel paths use, as autograd functions where
a gradient crosses them.

Every collective here is an ``all_reduce``: gloo carries only ``all_reduce``
and ``broadcast`` on CUDA tensors, and ranks that share one card run over
gloo. A gather is an ``all_reduce`` of a zero buffer into which each rank
wrote its own block (the sums add exact zeros).

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


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return gather_dim(x.contiguous(), 0, group)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads every rank's rows: sum the gradients of
        # all ranks, keep this rank's block
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        n, rank = ctx.rows, dist.get_rank(ctx.group)
        return g[rank * n : (rank + 1) * n], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The (size * n, ...) concatenation of every rank's (n, ...) ``x`` in
    rank order, differentiable: the gradient of a rank's block is the sum
    of all ranks' gradients for it."""
    return _GatherRows.apply(x, group)


def any_rank(flag: bool, group, device: Optional[torch.device] = None) -> bool:
    """Whether ``flag`` is true on any rank of ``group`` (one MAX all-reduce
    of a scalar on ``device``)."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(all_reduce_(t, group, dist.ReduceOp.MAX).item() > 0)
