"""Non-finite sweeps: the port's counterpart of the JAX package's
``utils/debugging.py``.

- ``find_nonfinite(tree)``: the names of the floating tensors (or arrays)
  holding a NaN or an Inf in a state_dict, a nested dict or list of them,
  or a module (its ``state_dict``);
- ``checkify_step(fn)``: wraps a step so that the first non-finite floating
  output, or gradient left on a parameter, raises ``FloatingPointError``
  naming it (JAX's ``checkify`` float checks name the failing op instead;
  eager PyTorch has no such tracing, so the check reads what the step
  produced);
- ``nan_guard(logs)``: the per-step gate over scalar logs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Any, path: str = "") -> Iterable[Tuple[str, Any]]:
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/[{i}]" if path else f"[{i}]")
    else:
        yield path, tree


def _finite(x: Any) -> bool:
    """True unless ``x`` is a floating tensor or array with a NaN or Inf."""
    if isinstance(x, torch.Tensor):
        return not x.is_floating_point() or bool(torch.isfinite(x).all())
    arr = np.asarray(x)
    return not np.issubdtype(arr.dtype, np.floating) or bool(np.isfinite(arr).all())


def find_nonfinite(tree: Any) -> List[str]:
    """"/"-joined paths of the leaves holding NaN or Inf, named as JAX's
    (a list index as ``[i]``); a sweep over every element: use it sparingly
    on the card."""
    return [path for path, leaf in _leaves(tree) if not _finite(leaf)]


def checkify_step(fn: Callable, *, jit: bool = True, params: Iterable[Tuple[str, torch.Tensor]] = ()) -> Callable:
    """``fn`` with a finiteness check of what it returns and, for each named
    parameter in ``params`` (e.g. ``model.named_parameters()``), of the
    gradient it left: the first non-finite one raises
    ``FloatingPointError`` with its name. ``jit`` is accepted for the JAX
    signature and ignored: eager PyTorch compiles nothing."""
    del jit
    params = list(params)

    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = find_nonfinite(out)
        if bad:
            raise FloatingPointError(f"non-finite output of {getattr(fn, '__name__', fn)}: {bad[0]}")
        for name, p in params:
            if p.grad is not None and not _finite(p.grad):
                raise FloatingPointError(f"non-finite gradient of {name}")
        return out

    return run


def nan_guard(logs: Dict[str, Any]) -> Tuple[bool, List[str]]:
    """(ok, the keys whose values are not finite) over scalar logs."""
    bad = [k for k, v in logs.items() if not np.isfinite(np.asarray(
        v.detach().cpu().double() if isinstance(v, torch.Tensor) else v, dtype=np.float64)).all()]
    return (not bad, bad)
