"""Stage 0: normalize hate-speech corpora to (id, link_id, label) parquets.

Ports of Pre-Processing/data/process_cad.py, process_slurs.py and the
offline half of process_lti.py (the Pushshift link_id lookup is pluggable —
process_lti.py:20-31 hits api.pushshift.io).

The PyTorch port's copy of the JAX package's ``data_prep/labels.py``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Optional


def cad_majority_label(annotations: Iterable[str]) -> str:
    """Majority vote excluding Neutral; Neutral only if nothing else
    (process_cad.py:16-27)."""
    counts: Dict[str, int] = {}
    for y in annotations:
        counts[y] = counts.get(y, 0) + 1
    ranked = sorted(
        ((k, v) for k, v in counts.items() if k != "Neutral"),
        key=lambda kv: kv[1],
    )
    return ranked[-1][0] if ranked else "Neutral"


def process_cad(tsv_path: str, out_path: str) -> "pd.DataFrame":
    """CAD corpus -> parquet (process_cad.py:3-31)."""
    import pandas as pd

    df = pd.read_csv(tsv_path, sep="\t")
    df = df[df["split"].isin(("train", "test", "dev"))]
    df = df[["info_id.link", "info_id", "annotation_Primary"]]
    df["info_id"] = (
        df["info_id"].str.replace("-post", "").str.replace("-title", "")
    )
    grouped = df.groupby("info_id").agg(list)
    df = df.drop("annotation_Primary", axis=1).join(
        grouped["annotation_Primary"].apply(cad_majority_label), on="info_id"
    )
    df = df.drop_duplicates(subset="info_id")
    df = df.rename(
        {"annotation_Primary": "label", "info_id": "id", "info_id.link": "link_id"},
        axis=1,
    )
    df.to_parquet(out_path)
    return df


def process_slurs(csv_path: str, out_path: str) -> "pd.DataFrame":
    """Slur corpus -> parquet (process_slurs.py:3-9): strip the t1_/t3_
    prefixes and rename gold_label."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    df = df[["id", "link_id", "gold_label"]]
    df["id"] = df["id"].str[3:]
    df["link_id"] = df["link_id"].str[3:]
    df = df.rename({"gold_label": "label"}, axis=1)
    df.to_parquet(out_path)
    return df


_LTI_ID_SPLIT = re.compile(r"\n?\d+\. \t*")


def explode_lti_ids(raw_id_field: str) -> list:
    """The LTI csv packs multiple comment ids into one numbered-list string
    (process_lti.py:38-50)."""
    parts = _LTI_ID_SPLIT.split(raw_id_field)[1:]
    if parts:
        parts[-1] = parts[-1][:-1]
    return parts


def process_lti(
    csv_path: str,
    out_path: str,
    link_id_lookup: Optional[Callable[[list], Dict[str, str]]] = None,
    batch: int = 500,
) -> "pd.DataFrame":
    """LTI corpus -> parquet. ``link_id_lookup`` maps comment-id batches to
    link ids (the reference uses the Pushshift API, process_lti.py:20-31;
    pass a local index for offline runs). Rows whose link_id cannot be
    resolved are dropped."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    df["id"] = df["id"].apply(explode_lti_ids)
    # one row per comment id, labelled hate/normal by the per-id hate mask
    rows = []
    for _, r in df.iterrows():
        ids = r["id"]
        hate_mask = r.get("hate_speech_idx")
        hate_idx = set()
        if isinstance(hate_mask, str) and hate_mask.strip().startswith("["):
            try:
                hate_idx = {int(x) for x in re.findall(r"\d+", hate_mask)}
            except ValueError:
                hate_idx = set()
        for i, cid in enumerate(ids, start=1):
            rows.append(
                {"id": cid, "label": "lti_hate" if i in hate_idx else "lti_normal"}
            )
    out = pd.DataFrame(rows).drop_duplicates(subset="id")
    if link_id_lookup is not None:
        link_ids: Dict[str, str] = {}
        ids = list(out["id"])
        for s in range(0, len(ids), batch):
            link_ids.update(link_id_lookup(ids[s : s + batch]))
        out["link_id"] = out["id"].map(link_ids)
        out = out.dropna(subset=["link_id"])
        out["link_id"] = out["link_id"].str[3:]
    else:
        out["link_id"] = None
    out.to_parquet(out_path)
    return out
