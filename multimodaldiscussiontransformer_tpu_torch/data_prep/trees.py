"""Stages 2-3: build nested discussion trees from monthly dumps and prune.

Ports of Pre-Processing/2-combine_and_compress_trees.py and
3-prune-trees.py. The tree format is the raw-JSON contract the ingestion
layer consumes: ``{"data": {...,"label": ...}, "id": ..., "tree": [...]}``.

The PyTorch port's copy of the JAX package's ``data_prep/trees.py``.
"""

from __future__ import annotations

import json
import math
import os
from glob import glob
from typing import Dict, Iterable, List, Optional, Tuple


def build_month_trees(
    submissions: Iterable[dict],
    comments: Iterable[dict],
    label_of: Dict[str, str],
) -> List[dict]:
    """One month of submissions+comments -> list of nested trees.

    Mirrors 2-combine_and_compress_trees.py:26-82: label join (NA when
    missing), t3_-prefix stripping on parent/link ids, a second pass for
    comments whose parents arrive later ("missing" list)."""
    graph: Dict[str, Dict[str, dict]] = {}
    for data in submissions:
        link_id = data["id"]
        data = dict(data)
        data["label"] = label_of.get(link_id, "NA")
        graph[link_id] = {
            link_id: {"data": data, "tree": [], "id": link_id}
        }

    missing: List[Tuple[str, str, dict]] = []
    for node in comments:
        node = dict(node)
        parent_id = node["parent_id"][3:]
        node["parent_id"] = parent_id
        link_id = node["link_id"][3:]
        if link_id not in graph:
            continue
        node["label"] = label_of.get(node["id"], "NA")
        entry = {"data": node, "tree": [], "id": node["id"]}
        graph[link_id][node["id"]] = entry
        if parent_id in graph[link_id]:
            graph[link_id][parent_id]["tree"].append(entry)
        else:
            missing.append((link_id, parent_id, entry))

    for link_id, parent_id, entry in missing:
        if parent_id in graph[link_id]:
            graph[link_id][parent_id]["tree"].append(entry)

    return [g[k] for k, g in ((lk, gr) for lk, gr in graph.items())]


def combine_months(
    data_dir: str,
    label_parquet_glob: str = "*-processed.parquet",
    out_path: str = "complete-graphs.json",
) -> int:
    """Stage-2 entry point over ``<date>-submissions.json`` /
    ``<date>-comments.json`` pairs (2-combine:15-96). Returns #labels."""
    import pandas as pd

    frames = [
        pd.read_parquet(x)
        for x in glob(os.path.join(data_dir, label_parquet_glob))
    ]
    df = pd.concat(frames).set_index("id") if frames else None
    label_of = (
        {i: r["label"] for i, r in df.iterrows()} if df is not None else {}
    )

    labels = 0
    with open(out_path, "w") as out:
        for cfile in sorted(glob(os.path.join(data_dir, "*-*-comments.json"))):
            date = os.path.basename(cfile)[:7]
            sfile = os.path.join(data_dir, f"{date}-submissions.json")

            def read_jsonl(path):
                if not os.path.exists(path):
                    return
                with open(path) as f:
                    for line in f:
                        if line.strip():
                            yield json.loads(line)

            trees = build_month_trees(
                read_jsonl(sfile), read_jsonl(cfile), label_of
            )
            for t in trees:
                out.write(json.dumps(t) + "\n")
                labels += count_labels(t)
    return labels


def count_labels(tree: dict) -> int:
    n = int(tree["data"].get("label", "NA") != "NA")
    return n + sum(count_labels(c) for c in tree["tree"])


def count_size_of_tree(x: dict) -> int:
    return sum(count_size_of_tree(y) for y in x["tree"]) + 1


MAX_UNLABELLED_DEPTH = 7  # unlabelled branches cut at this depth
MIN_KEPT_CHILDREN = 2


def trim_and_get_size(comment: dict, depth: int = 0) -> float:
    """Prune policy (semantics of 3-prune-trees.py:16-39, pinned by
    tests/test_data_prep.py):

    - a child whose node is labelled is always kept (treated as
      infinitely large so it survives the top-k cut), and its own subtree
      is pruned recursively;
    - an unlabelled child at depth < MAX_UNLABELLED_DEPTH is pruned
      recursively and ranked by its post-prune size (labelled descendants
      push the size to inf);
    - an unlabelled child at the depth limit loses its whole subtree;
    - finally only the largest max(MIN_KEPT_CHILDREN, #label-bearing
      children) children survive.

    Returns the post-prune subtree size (inf if it contains a label)."""
    ranked = []  # (subtree size, child position)
    label_bearing = 0
    for pos, child in enumerate(comment["tree"]):
        if child["data"]["label"] != "NA":
            trim_and_get_size(child, depth + 1)
            label_bearing += 1
            ranked.append((math.inf, pos))
        elif depth + 1 < MAX_UNLABELLED_DEPTH:
            size = trim_and_get_size(child, depth + 1)
            if size == math.inf:
                label_bearing += 1
            ranked.append((size, pos))
        else:
            child["tree"] = []
            ranked.append((0, pos))
    keep = sorted(ranked, key=lambda sp: sp[0], reverse=True)[
        : max(MIN_KEPT_CHILDREN, label_bearing)
    ]
    comment["tree"] = [comment["tree"][pos] for _, pos in keep]
    return sum(size for size, _ in keep) + 1


def prune_file(in_path: str, out_path: str) -> int:
    """Stage-3 entry point (3-prune-trees.py:6-12)."""
    n = 0
    with open(in_path) as read, open(out_path, "w") as write:
        for line in read:
            if not line.strip():
                continue
            data = json.loads(line)
            trim_and_get_size(data)
            write.write(json.dumps(data) + "\n")
            n += 1
    return n
