"""Param-layout transforms between the unrolled and the layer-scanned model:
the port's copy of the JAX package's ``utils/scan_params.py``, without JAX.

``ModelConfig.scan_layers`` changes the param LAYOUT, not the math: the
uniform interleave pairs live under one ``scan_pairs`` subtree with their
params stacked on a leading axis (``graph_stack_i`` / ``fusion_stack_{i+1}``
for scanned ``i`` disappear), and each bottom tower's ``layer_0..n-1``
become one stacked ``scan_layers``. The port's modules always run unrolled
(eager PyTorch has no compiled program to shrink); under ``scan_layers`` its
checkpoints store the scan layout, and every loader unstacks it
(``unrolled_state_dict``).

The transforms are exact restacks. They take a nested dict (a Flax params
tree with numpy leaves, with or without the ``{"params": ...}`` wrapper);
``scanned_state_dict`` / ``unrolled_state_dict`` apply them to a torch
state_dict, whose dotted keys follow the same paths.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig


def _stack_sizes(total: int, chunk: int) -> list:
    return [min(chunk, total - i) for i in range(0, total, chunk)]


def _scan_pair_count(sizes: list) -> int:
    """Interleave pairs that can share one scan body: ``n_pairs`` when every
    scanned fusion stack has the size of ``fusion_stack_1``, one fewer when
    the last stack is ragged."""
    n_pairs = len(sizes) - 1
    if n_pairs <= 0:
        return 0
    return n_pairs if sizes[-1] == sizes[1] else n_pairs - 1


def scan_plan(cfg: ModelConfig) -> Dict[str, int]:
    """What the scanned layout stacks, from the model config alone."""
    sizes = _stack_sizes(cfg.num_fusion_layers + 1, cfg.num_fusion_stack)
    return {
        "n_pairs_scanned": _scan_pair_count(sizes),
        "text_layers": max(cfg.num_bottom_text_layers, 0),
        "image_layers": max(cfg.num_bottom_image_layers, 0) if cfg.use_image_tower else 0,
    }


def _unwrap(params: Any):
    """(inner tree, rewrap) for raw trees and {"params": ...} wrappers."""
    if isinstance(params, Mapping) and "params" in params:
        outer = dict(params)

        def rewrap(inner):
            return {**outer, "params": inner}

        return params["params"], rewrap
    return params, lambda inner: inner


def params_layout(params: Any) -> str:
    """"scanned" | "unrolled" | "none" by key presence under graph_encoder."""
    inner, _ = _unwrap(params)
    enc = inner.get("graph_encoder", {}) if isinstance(inner, Mapping) else {}
    if "scan_pairs" in enc or "scan_layers" in enc.get("text_model", {}):
        return "scanned"
    if any(k.startswith("graph_stack_") for k in enc) or "layer_0" in enc.get("text_model", {}):
        return "unrolled"
    return "none"


def _map_leaves(fn: Callable, *trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _map_leaves(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _stack(*leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack([np.asarray(x) for x in leaves], axis=0)


def _take(leaf, i: int):
    return leaf[i].clone() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)[i]


def _stacked_len(tree) -> int:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return int(tree.shape[0])


def to_scanned(params: Any, cfg: ModelConfig) -> Any:
    """Unrolled-layout params -> scanned layout."""
    inner, rewrap = _unwrap(params)
    if params_layout(params) != "unrolled":
        return params
    plan = scan_plan(cfg)
    enc = dict(inner["graph_encoder"])
    n = plan["n_pairs_scanned"]
    if n > 0:
        enc["scan_pairs"] = {
            "graph_stack": _map_leaves(_stack, *[enc.pop(f"graph_stack_{i}") for i in range(n)]),
            "fusion_stack": _map_leaves(_stack, *[enc.pop(f"fusion_stack_{i + 1}") for i in range(n)]),
        }
    for tower, count in (("text_model", plan["text_layers"]), ("vit_model", plan["image_layers"])):
        if count > 0 and tower in enc:
            t = dict(enc[tower])
            t["scan_layers"] = _map_leaves(_stack, *[t.pop(f"layer_{i}") for i in range(count)])
            enc[tower] = t
    return rewrap({**inner, "graph_encoder": enc})


def to_unrolled(params: Any, cfg: Optional[ModelConfig] = None) -> Any:
    """Scanned-layout params -> unrolled layout. Without ``cfg`` the layer
    counts are read off the stacked leading axes."""
    inner, rewrap = _unwrap(params)
    if params_layout(params) != "scanned":
        return params
    plan = scan_plan(cfg) if cfg is not None else None
    enc = dict(inner["graph_encoder"])
    if "scan_pairs" in enc:
        pairs = dict(enc.pop("scan_pairs"))
        n = plan["n_pairs_scanned"] if plan else _stacked_len(pairs)
        for name, first in (("graph_stack", 0), ("fusion_stack", 1)):
            if name in pairs:
                stacked = pairs.pop(name)
                for i in range(n):
                    enc[f"{name}_{i + first}"] = _map_leaves(lambda x: _take(x, i), stacked)
        if pairs:  # what is not a scanned pair stays where it is
            enc["scan_pairs"] = pairs
    for tower, key in (("text_model", "text_layers"), ("vit_model", "image_layers")):
        if tower in enc and "scan_layers" in enc[tower]:
            t = dict(enc[tower])
            stacked = t.pop("scan_layers")
            count = plan[key] if plan else _stacked_len(stacked)
            for i in range(count):
                t[f"layer_{i}"] = _map_leaves(lambda x: _take(x, i), stacked)
            enc[tower] = t
    return rewrap({**inner, "graph_encoder": enc})


def adapt_params(params: Any, cfg: ModelConfig) -> Any:
    """Convert ``params`` to the layout ``cfg`` expects (no-op if aligned)."""
    if cfg.scan_layers:
        return to_scanned(params, cfg)
    return to_unrolled(params, cfg)


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def state_dict_layout(state_dict: Mapping[str, Any]) -> str:
    """``params_layout`` of a torch state_dict."""
    return params_layout(_nest(state_dict))


def scanned_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A state_dict in the scan layout (a scanned one is returned as it is)."""
    if state_dict_layout(state_dict) != "unrolled":
        return dict(state_dict)
    return _flatten(to_scanned(_nest(state_dict), cfg))


def unrolled_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: Optional[ModelConfig] = None) -> Dict[str, torch.Tensor]:
    """A state_dict in the layout of the port's modules (the unrolled one)."""
    if state_dict_layout(state_dict) != "scanned":
        return dict(state_dict)
    return _flatten(to_unrolled(_nest(state_dict), cfg))
