"""Rematerialisation of the fusion and graph stacks (``ModelConfig.remat``):
the port's counterpart of ``jax.checkpoint`` with the JAX package's five
``remat_policy`` values (JAX ``models/mdt.py::_remat_policy``).

``remat_segment(fn, *args, policy=...)`` runs ``fn`` under
``torch.utils.checkpoint`` (non-reentrant). What the backward finds saved:
- ``full``: the segment's inputs only; the backward reruns its forward;
- ``dots``: also the outputs of matmuls without batch dims (``mm``,
  ``addmm``: every dense layer), as
  ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``;
- ``dots_saveable``: also the batched ones (``bmm``, ``baddbmm``: the
  unfused attention products), as ``dots_saveable``;
- ``names``: the tensors the layers tag ``attn_out`` and ``ffn_out``
  (``checkpoint_name``), as ``save_only_these_names``;
- ``names_heavy``: also ``attn_proj`` and ``ffn_mid``.
The selective policies go through ``create_selective_checkpoint_contexts``,
which sees aten ops only. The hand-written kernels launch through ``ctypes``
into tensors that an aten op allocated (``empty``, ``zeros``); no policy
saves an allocation, so every kernel runs again in the recompute and
writes fresh outputs (``tests/test_torch_runtime_remat.py`` holds the save
set to the ops above).

Dropout under recompute: the recompute must draw the masks and the
attention-kernel seeds of the original forward. They come from the two
generators of ``fast_dropout.dropout_rngs``, which ``torch.utils.checkpoint``
does not know of (it restores the default generators only, so it is asked
not to). Each segment snapshots both generators at entry; its recompute
sets them to that snapshot, makes them the thread's dropout generators
(the backward may run on another thread, as autograd's CUDA worker does)
and, when it ends, returns them to where they stood, so that every later
draw is the one a run without remat makes.

The tags (``checkpoint_name``) are the identity outside a ``names``
segment; inside one they are the ``mdt_port::checkpoint_name`` op, a copy
that the policy can see and save.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import current_rngs, dropout_rngs

POLICIES = ("full", "dots", "dots_saveable", "names", "names_heavy")
_NAMES = {"names": frozenset({"attn_out", "ffn_out"}),
          "names_heavy": frozenset({"attn_out", "ffn_out", "attn_proj", "ffn_mid"})}
_aten = torch.ops.aten
_DOTS = {"dots": frozenset({_aten.mm.default, _aten.addmm.default}),
         "dots_saveable": frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default})}

_tagging = threading.local()


@torch.library.custom_op("mdt_port::checkpoint_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_named.register_fake
def _(x, name):
    return torch.empty_like(x)


_named.register_autograd(lambda ctx, grad: (grad, None), setup_context=lambda ctx, inputs, output: None)
NAMED_OP = torch.ops.mdt_port.checkpoint_name.default


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tag ``x`` as ``name`` for the ``names`` policies: the identity
    outside a segment that saves names."""
    if getattr(_tagging, "on", False):
        return _named(x, name)
    return x


@contextlib.contextmanager
def _tags(on: bool):
    prev = getattr(_tagging, "on", False)
    _tagging.on = on
    try:
        yield
    finally:
        _tagging.on = prev


def saved_ops(policy: str) -> Callable[[object, tuple], bool]:
    """``(op, args) -> bool``: whether ``policy`` saves that op's output."""
    if policy in _DOTS:
        dots = _DOTS[policy]
        return lambda op, args: op in dots
    names = _NAMES[policy]
    return lambda op, args: op == NAMED_OP and args[1] in names


def _selective(policy: str):
    saves = saved_ops(policy)

    def policy_fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if saves(op, args) else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy_fn)


@contextlib.contextmanager
def _replay(host: torch.Generator, device: torch.Generator, entry: Tuple[torch.Tensor, torch.Tensor], tags: bool):
    """The recompute: both generators at the segment's entry state and the
    thread's dropout generators; afterwards both where they stood."""
    now = (host.get_state(), device.get_state())
    host.set_state(entry[0])
    device.set_state(entry[1])
    try:
        with dropout_rngs(host, device), _tags(tags):
            yield
    finally:
        host.set_state(now[0])
        device.set_state(now[1])


class _Context(contextlib.AbstractContextManager):
    """One side of a segment: the checkpoint context (selective, or none
    for ``full``) with the tag switch; for the recompute also the
    generators' replay."""

    def __init__(self, inner, tags: bool, replay: Optional[tuple] = None):
        self._inner, self._tags, self._replay = inner, tags, replay
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self._replay is not None:
            self._stack.enter_context(_replay(*self._replay, self._tags))
        else:
            self._stack.enter_context(_tags(self._tags))
        self._stack.enter_context(self._inner)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)


def _contexts(policy: str):
    """(forward context, recompute context) of one segment; called as the
    segment's forward starts, so the generators' states are its entry's."""
    host, device = current_rngs()
    entry = (host.get_state(), device.get_state())
    tags = policy in _NAMES
    if policy == "full":
        forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()
    else:
        forward, recompute = _selective(policy)
    return _Context(forward, tags), _Context(recompute, tags, (host, device, entry))


def remat_segment(fn: Callable, *args, policy: str = "full"):
    """``fn(*args)`` with its activations rematerialised under ``policy``
    (run inside ``dropout_rngs``)."""
    if policy not in POLICIES:
        raise ValueError(f"remat_policy {policy!r} not in {POLICIES}")
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=functools.partial(_contexts, policy))
