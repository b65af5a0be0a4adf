"""Stage 6: flatten pruned trees to per-comment parquet splits for the
comment-only baseline (port of Pre-Processing/6-export_text_only_results.py).

The PyTorch port's copy of the JAX package's ``data_prep/text_export.py``.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional, Sequence, Set

HATE_LABELS = ("DEG", "lti_hate", "IdentityDirectedAbuse", "AffiliationDirectedAbuse")
GOOD_LABELS = ("Neutral", "lti_normal", "NDG", "HOM")


def collapse_tree(comment: dict, data: List[dict], root_images, duped: Set[str]):
    """DFS flatten, skipping duplicated bodies (6-export:9-20)."""
    if comment["data"].get("body", comment["data"].get("title", "")) not in duped:
        comment = dict(comment)
        comment["root_images"] = root_images
        data.append(comment)
    for x in comment["tree"]:
        collapse_tree(x, data, root_images, duped)


def extract_relevant_bits(comment: dict) -> dict:
    """6-export:22-39: submissions use title+body text; label -> binary
    primary_label (hate True)."""
    d = comment["data"]
    if "link_id" in d:
        link_id = d["link_id"]
        text = d.get("body", "")
    else:
        link_id = d["id"]
        text = d.get("title", "") + "\n" + d.get("body", "")
    return {
        "id": d["id"],
        "link_id": link_id,
        "text": text,
        "images": comment.get("images", []),
        "root_images": comment.get("root_images", []),
        "label": d.get("label", "NA"),
        "primary_label": d.get("label") in HATE_LABELS,
    }


def export_splits(
    json_path: str,
    split_dir: str,
    out_dir: str,
    duped: Optional[Iterable[str]] = None,
    n_splits: int = 7,
    labelled_only: bool = False,
) -> int:
    """Write ``HatefulDiscussions_dataset_{train,test}-split-<i>.parquet``
    (6-export:41-100). ``duped`` is the stage-5 dedupe text list."""
    import pandas as pd

    duped_set = set(duped or [])
    os.makedirs(out_dir, exist_ok=True)

    lines = []
    with open(json_path) as f:
        for line in f:
            if line.strip():
                lines.append(json.loads(line))

    total = 0
    for split_idx in range(n_splits):
        def read_idx(name):
            with open(os.path.join(split_dir, f"{name}_index-{split_idx}.txt")) as f:
                return {int(x) for x in f.read().split() if x.strip()}

        train_ids = read_idx("train")
        test_ids = read_idx("test")
        for split, ids in (("train", train_ids), ("test", test_ids)):
            rows: List[dict] = []
            for z, tree in enumerate(lines):
                if z in ids:
                    flat: List[dict] = []
                    collapse_tree(tree, flat, tree.get("images", []), duped_set)
                    rows.extend(extract_relevant_bits(c) for c in flat)
            if labelled_only:
                rows = [
                    r for r in rows
                    if r["label"] in HATE_LABELS or r["label"] in GOOD_LABELS
                ]
            df = pd.DataFrame(rows)
            if len(df):
                df["image_count"] = df["images"].apply(len)
                df["label_text"] = df["label"]
                df["label"] = df["primary_label"].astype(int)
            df.to_parquet(
                os.path.join(
                    out_dir,
                    f"HatefulDiscussions_dataset_{split}-split-{split_idx}.parquet",
                )
            )
            total += len(df)
    return total
