"""Stage 5: dedupe table + train/test split generation.

THE MISSING STAGE: the reference pipeline consumes ``duped.parquet`` and
``{train,test}_index-<i>.txt`` / ``{train,test}-idx.txt`` split files that no
in-repo script produces (SURVEY.md §2.1 "Gap": 6-export:5,50-58 and
hateful_discussions.py:96-101 read them; nothing writes them). This module
provides the functional reconstruction:

- ``build_dupe_table``: texts appearing in more than one comment (bot
  boilerplate, copypasta) — the natural definition that makes stage 6's
  ``body in duped`` membership test meaningful;
- ``make_splits``: k seeded train/test splits over discussion line numbers,
  stratified by whether the tree contains a hate-labelled node.

The PyTorch port's copy of the JAX package's ``data_prep/splits.py``.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Iterable, List, Optional, Tuple

import numpy as np

HATE_LABELS = ("DEG", "lti_hate", "IdentityDirectedAbuse", "AffiliationDirectedAbuse")


def iter_bodies(tree: dict):
    data = tree["data"]
    yield data.get("body", data.get("title", ""))
    for c in tree["tree"]:
        yield from iter_bodies(c)


def tree_has_hate(tree: dict) -> bool:
    if tree["data"].get("label") in HATE_LABELS:
        return True
    return any(tree_has_hate(c) for c in tree["tree"])


def build_dupe_table(
    json_path: str, out_parquet: Optional[str] = None, min_count: int = 2
) -> List[str]:
    """Texts repeated >= min_count times across the corpus."""
    counts: Counter = Counter()
    with open(json_path) as f:
        for line in f:
            if not line.strip():
                continue
            for body in iter_bodies(json.loads(line)):
                counts[body] += 1
    duped = [t for t, c in counts.items() if c >= min_count]
    if out_parquet:
        import pandas as pd

        pd.DataFrame({"text": duped}).to_parquet(out_parquet)
    return duped


def make_splits(
    json_path: str,
    out_dir: str,
    n_splits: int = 7,
    test_frac: float = 0.2,
    seed: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """K seeded, hate-stratified train/test splits over line numbers.

    Writes both naming conventions the downstream consumers expect:
    ``{train,test}_index-<i>.txt`` (6-export:50-58) and, for split 0, the
    ``{train,test}-idx.txt`` pair (hateful_discussions.py:96-101)."""
    import os

    has_hate = []
    with open(json_path) as f:
        for line in f:
            if line.strip():
                has_hate.append(tree_has_hate(json.loads(line)))
    has_hate = np.asarray(has_hate)
    n = len(has_hate)
    os.makedirs(out_dir, exist_ok=True)

    splits = []
    for i in range(n_splits):
        rng = np.random.RandomState(seed + i)
        test_mask = np.zeros(n, bool)
        for cls in (True, False):
            idx = np.flatnonzero(has_hate == cls)
            rng.shuffle(idx)
            k = max(1, int(len(idx) * test_frac)) if len(idx) else 0
            test_mask[idx[:k]] = True
        test_idx = np.flatnonzero(test_mask)
        train_idx = np.flatnonzero(~test_mask)
        for name, arr in (("train", train_idx), ("test", test_idx)):
            with open(os.path.join(out_dir, f"{name}_index-{i}.txt"), "w") as f:
                f.write("\n".join(map(str, arr)) + "\n")
            if i == 0:
                with open(os.path.join(out_dir, f"{name}-idx.txt"), "w") as f:
                    f.write("\n".join(map(str, arr)) + "\n")
        splits.append((train_idx, test_idx))
    return splits
