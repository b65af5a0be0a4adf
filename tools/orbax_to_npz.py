"""Convert one step of the JAX package's Orbax checkpoints into an ``.npz``
that the PyTorch port restores.

Runs where JAX, orbax and tensorstore run (the port's machine has none of
them). It restores the step with the JAX package's
``utils/checkpoints.py::Checkpointer`` (structure-free) and writes:

- ``params/<Flax path>``: the params, in the checkpoint's param layout;
- ``opt/mu/<Flax path>``, ``opt/nu/<Flax path>``, ``opt/count``: optax's
  AdamW moments of the trainable params and its count (the frozen towers
  have none), where the checkpoint holds an optimizer state;
- ``step`` (microbatches), ``epoch``, ``num_updates`` (the AdamW count) and,
  where the save dir has a best step, ``best_step``;
- ``__bf16__``: the names of the bfloat16 leaves, each stored as its uint16
  bits, so that numpy reads the file without ``ml_dtypes``.

Restore it in the port with ``--restore-file OUT.npz`` (with or without
``--reset-optimizer``) or ``DiscussionScorer.from_checkpoint("OUT.npz")``.

    python tools/orbax_to_npz.py SAVE_DIR OUT.npz [--step N | --best]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_KEY = "__bf16__"


def _walk(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _find_adam(tree: Any) -> Optional[Dict[str, Any]]:
    """The (only) ``ScaleByAdamState`` in a raw optax state: a dict with
    ``count``, ``mu`` and ``nu``."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        found = [a for a in (_find_adam(v) for v in tree.values()) if a is not None]
    elif isinstance(tree, (list, tuple)):
        found = [a for a in (_find_adam(v) for v in tree) if a is not None]
    else:
        return None
    if len(found) > 1:
        raise ValueError("more than one AdamW state in the optimizer state")
    return found[0] if found else None


def _params_tree(tree: Any) -> Any:
    """The tree under the Flax ``params`` collection."""
    return tree["params"] if isinstance(tree, dict) and set(tree) == {"params"} else tree


def npz_arrays(raw: Dict[str, Any], best_step: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The ``.npz`` entries for a structure-free restore of a JAX
    ``TrainState`` (or a params-only checkpoint)."""
    arrays: Dict[str, np.ndarray] = {}
    bf16 = []

    def put(prefix: str, tree: Any) -> None:
        for path, leaf in _walk(_params_tree(tree)):
            if leaf is None or not hasattr(leaf, "shape"):  # optax's MaskedNode of a frozen leaf
                continue
            arr = np.asarray(leaf)
            key = prefix + "/".join(path)
            if arr.dtype.name == "bfloat16":
                arr = arr.view(np.uint16)
                bf16.append(key)
            arrays[key] = arr

    put("params/", raw["params"])
    adam = _find_adam(raw.get("opt_state"))
    if adam is not None:
        put("opt/mu/", adam["mu"])
        put("opt/nu/", adam["nu"])
        arrays["opt/count"] = np.asarray(adam["count"], np.int32)
        arrays["num_updates"] = np.asarray(adam["count"], np.int32)
    for key in ("step", "epoch"):
        if key in raw:
            arrays[key] = np.asarray(raw[key], np.int32)
    if best_step is not None:
        arrays["best_step"] = np.asarray(best_step, np.int32)
    arrays[BF16_KEY] = np.asarray(sorted(bf16), dtype=str)
    return arrays


def convert(save_dir: str, out: str, step: Optional[int] = None, best: bool = False) -> int:
    """Write ``out`` from one step of ``save_dir`` (default: the latest;
    ``best``: the best). Returns the step."""
    sys.path.insert(0, ROOT)
    from multimodaldiscussiontransformer_tpu.utils.checkpoints import Checkpointer

    ckpt = Checkpointer(save_dir, async_save=False)
    try:
        if step is None:
            step = ckpt.best_step() if best else ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {save_dir}")
        raw = ckpt.restore_raw(step=step, best=best)
    finally:
        ckpt.close()
    best_file = os.path.join(save_dir, "best_step.txt")
    best_step = int(open(best_file).read().strip()) if os.path.exists(best_file) else None
    np.savez(out, **npz_arrays(raw, best_step))
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="JAX Orbax checkpoint step -> .npz for the PyTorch port")
    p.add_argument("save_dir")
    p.add_argument("out")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--step", type=int, default=None)
    g.add_argument("--best", action="store_true", help="the best step (best_step.txt) instead of the latest")
    a = p.parse_args(argv)
    step = convert(a.save_dir, a.out, step=a.step, best=a.best)
    print(f"step {step} of {a.save_dir} -> {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
