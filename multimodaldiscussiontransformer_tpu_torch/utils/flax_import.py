"""Carry weights from the JAX package's Flax params into the port's model.

The port's modules are named like the Flax ones, so a Flax path maps to a
state_dict key component by component; only the leaf name and layout
change:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed;
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
- ``bias`` and raw parameters (``bottle_neck``, ``graph_token``, the degree
  tables, ``spatial_pos_encoder``, ``graph_token_virtual_distance``,
  ``cls_token``, ``position_embeddings``) are copied as they are.

A tree in the scan layout (``ModelConfig.scan_layers``: ``scan_pairs`` and
each tower's ``scan_layers`` stacked on a leading axis) is unstacked first
(``utils/scan_params.py::to_unrolled``); ``to_flax_params`` emits the scan
layout for a model whose config sets ``scan_layers``.

Leaves are numpy arrays (``jax.device_get`` of the params). A bfloat16 leaf
(``param_dtype="bfloat16"``) stays bfloat16, bit for bit, both ways; so does
a uint16 leaf, read as bfloat16 bits (the ``.npz`` layout of
``tools/orbax_to_npz.py``, which numpy reads without ``ml_dtypes``); every
other leaf becomes float32. Nothing here imports JAX; ``to_flax_params``
imports ``ml_dtypes`` (numpy's bfloat16) only when it meets a bf16 tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import to_scanned, to_unrolled


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _is_bf16(arr: np.ndarray) -> bool:
    """A bfloat16 array, or a uint16 array of bfloat16 bits."""
    return arr.dtype.name in ("bfloat16", "uint16")


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor with ``arr``'s values: bf16 bits reinterpreted, else float32."""
    if _is_bf16(arr):
        return torch.tensor(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.tensor(arr)


def _convert(path: Tuple[str, ...], leaf) -> Tuple[str, np.ndarray]:
    arr = np.asarray(leaf)
    arr = arr if _is_bf16(arr) else arr.astype(np.float32)
    name = path[-1]
    module = ".".join(path[:-1])
    if name == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
        name = "weight"
    elif name in ("scale", "embedding"):
        name = "weight"
    return f"{module}.{name}" if module else name, arr


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX ``MDTModel`` params tree (with or
    without the top-level ``"params"`` collection), in either layout. Each
    unrolled leaf becomes exactly one tensor."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(to_unrolled(params)).items():
        key, arr = _convert(path, leaf)
        if key in out:
            raise ValueError(f"two Flax leaves map to {key}")
        out[key] = _tensor(np.ascontiguousarray(arr))
    return out


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Fill every parameter of ``model`` from the Flax params tree. Raises
    if a port tensor is left unfilled, a Flax leaf has no port tensor, or a
    shape disagrees."""
    sd = flax_to_state_dict(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise ValueError(f"Flax params do not fit the model: missing {missing}, unexpected {unexpected}")
    bad = {k: (tuple(sd[k].shape), tuple(v.shape)) for k, v in own.items() if sd[k].shape != v.shape}
    if bad:
        raise ValueError(f"shape mismatch (flax, port): {bad}")
    model.load_state_dict(sd, strict=True)
    return model


def to_flax_params(model: nn.Module, tensors: Mapping[str, torch.Tensor] = None) -> Dict[str, Any]:
    """The inverse mapping: ``{"params": nested dict of numpy}`` in the Flax
    layout for the model's parameters, or for ``tensors`` keyed by the
    model's parameter names (e.g. their gradients); in the scan layout when
    the model's config sets ``scan_layers``."""
    kinds = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            kinds[f"{mod_name}.{leaf}" if mod_name else leaf] = (type(mod), leaf)
    tensors = dict(model.named_parameters()) if tensors is None else tensors
    tree: Dict[str, Any] = {}
    for key, t in tensors.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            arr = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            arr = t.float().numpy()
        cls, leaf = kinds[key]
        if leaf == "weight" and issubclass(cls, nn.Linear):
            arr, leaf = arr.T, "kernel"
        elif leaf == "weight" and issubclass(cls, nn.Conv2d):
            arr, leaf = arr.transpose(2, 3, 1, 0), "kernel"
        elif leaf == "weight" and issubclass(cls, nn.LayerNorm):
            leaf = "scale"
        elif leaf == "weight" and issubclass(cls, nn.Embedding):
            leaf = "embedding"
        node = tree
        for part in key.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    config = getattr(model, "config", None)
    if config is not None and config.scan_layers:
        tree = to_scanned(tree, config)
    return {"params": tree}
