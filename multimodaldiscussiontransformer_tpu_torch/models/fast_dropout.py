"""Mask-regenerating inverted dropout, and the generators a training forward
draws from.

``fast_dropout`` keeps no activation-sized mask for the backward: it saves
the device generator's state before drawing, and the backward redraws the
same mask from a generator set to that state. The mask is
``rand >= rate`` and kept entries are ``x / (1 - rate)``; at rate 0, or when
deterministic, dropout is the identity. The JAX package does the same at the
XLA level, so there is no hand kernel here.

A training forward (``deterministic=False``) runs inside ``dropout_rngs``,
which names two generators, as Flax's ``rngs={"dropout": ...}`` does:
- ``device``: a ``torch.Generator`` on the compute device, for the
  ``FastDropout`` masks;
- ``host``: a ``torch.Generator`` on the CPU that draws one integer seed per
  call of the tree attention and of the fused tower attention
  (``draw_seed``); the attention kernels derive their mask from it
  (``ops/tree_attention.py``, ``ops/masked_attention.py``).
The same generator states reproduce a step exactly.

Under tensor parallelism a dropout site whose activation is sharded over
the tp group (``FastDropout.shard``: the heads of the attention
probabilities, the features of the graph FFN) draws the whole activation's
mask and keeps its rank's block, so that every tp rank advances the
generator alike and the masks are the one-device masks; an activation that
is replicated over tp draws the same mask on every rank. The attention
kernels' seeds are folded with the tp rank (``draw_seed(fold)``): their
Philox counter holds the local head index, so the ranks' heads get distinct
masks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch
from torch import nn

_current = threading.local()


@contextlib.contextmanager
def dropout_rngs(host: torch.Generator, device: torch.Generator):
    """Generators for the dropout of the forwards run inside the block."""
    prev = getattr(_current, "rngs", None)
    _current.rngs = (host, device)
    try:
        yield
    finally:
        _current.rngs = prev


def current_rngs() -> Tuple[torch.Generator, torch.Generator]:
    rngs = getattr(_current, "rngs", None)
    if rngs is None:
        raise RuntimeError(
            "a training forward (deterministic=False) draws dropout masks: run it inside "
            "fast_dropout.dropout_rngs(host_generator, device_generator)"
        )
    return rngs


# the fold of a shard index into a seed (JAX ops/ring_attention.py:208-217)
SEED_FOLD = 1000003


def fold_seed(seed: int, index: int) -> int:
    """``seed`` decorrelated for shard ``index`` (unchanged for 0)."""
    return (int(seed) + int(index) * SEED_FOLD) % (2**63)


def draw_seed(fold: int = 0) -> int:
    """A fresh 63-bit seed from the host generator, folded with ``fold``."""
    return fold_seed(int(torch.randint(0, 2**63 - 1, (), generator=current_rngs()[0])), fold)


def _keep(shape, rate: float, generator: torch.Generator, device, shard=None) -> torch.Tensor:
    """The keep mask; with ``shard`` (dim, TPInfo) the block of the whole
    activation's mask (``shape`` times the group size along dim) that the
    rank holds."""
    if shard is None:
        return torch.rand(shape, generator=generator, device=device) >= rate
    dim, tp = shard
    whole = list(shape)
    whole[dim] *= tp.size
    return (torch.rand(whole, generator=generator, device=device) >= rate).narrow(dim, tp.rank * shape[dim], shape[dim])


class _FastDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate: float, generator: torch.Generator, shard=None):
        ctx.state = generator.get_state()
        ctx.rate = rate
        ctx.shard = shard
        ctx.generator_device = generator.device
        return torch.where(_keep(x.shape, rate, generator, x.device, shard), x / (1.0 - rate), 0.0)

    @staticmethod
    def backward(ctx, g):
        regen = torch.Generator(device=ctx.generator_device)
        regen.set_state(ctx.state)
        keep = _keep(g.shape, ctx.rate, regen, g.device, ctx.shard)  # regenerated, not stored
        return torch.where(keep, g / (1.0 - ctx.rate), 0.0), None, None, None


def fast_dropout(x: torch.Tensor, rate: float, generator: torch.Generator, shard=None) -> torch.Tensor:
    """Inverted dropout of ``x`` at ``rate`` in (0, 1), masks from
    ``generator`` (on x's device); ``shard`` as ``_keep``."""
    return _FastDropout.apply(x, rate, generator, shard)


class FastDropout(nn.Module):
    """Dropout with the JAX modules' call contract:
    ``forward(x, deterministic=True)``. ``shard`` (dim, TPInfo): ``x`` is
    the rank's block of a tensor-parallel activation along dim."""

    shard = None

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        return fast_dropout(x, self.rate, current_rngs()[1], self.shard)
