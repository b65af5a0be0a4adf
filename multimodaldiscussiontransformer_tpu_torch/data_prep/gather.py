"""Stage 1: locate labelled comments in time and filter monthly Reddit dumps.

Port of Pre-Processing/1-gather_complete_trees.py. The two network
dependencies — the Pushshift search API for (created_utc, link_id) lookups
(lines 22-36) and the monthly RS_/RC_ dump downloads (lines 76-79) — are
pluggable callables so the offline filtering logic is testable and the
pipeline can run against locally-mirrored dumps.

The PyTorch port's copy of the JAX package's ``data_prep/gather.py``.
"""

from __future__ import annotations

import os
import re
from glob import glob
from typing import Callable, Dict, Iterable, List, Optional, Tuple

SUB_ID_RE = re.compile(r"\"id\":\"([a-zA-Z0-9]*)\"")
COMMENT_LINK_RE = re.compile(r"\"link_id\":\"t3_([a-zA-Z0-9]*)\"")


def pushshift_comment_times(batch_fetch: Callable[[List[str]], dict]):
    """Wrap a Pushshift-API-like fetcher into an id -> (created_utc,
    link_id) mapper with batching (reference get_comment_time, lines 22-36)."""

    def lookup(ids: List[str], batch: int = 900) -> Dict[str, Tuple[int, str]]:
        out: Dict[str, Tuple[int, str]] = {}
        for s in range(0, len(ids), batch):
            out.update(batch_fetch(ids[s : s + batch]))
        return out

    return lookup


def formatted_month(ts: float) -> str:
    """'YYYY-MM' with zero padding (lines 62-71)."""
    from datetime import datetime

    d = datetime.fromtimestamp(ts)
    return f"{d.year}-{d.month:02d}"


def filter_month_dump(
    rs_path: str,
    rc_path: str,
    link_ids: Iterable[str],
    out_submissions: str,
    out_comments: str,
) -> Tuple[int, int]:
    """Filter one month's decompressed RS_/RC_ dumps to the needed
    submissions and their comments (lines 80-104). Returns
    (#submissions, #comments) kept."""
    ids_to_find = set(link_ids)
    ids_found = set()
    n_subs = n_comments = 0
    with open(rs_path) as read, open(out_submissions, "w") as write:
        for line in read:
            m = SUB_ID_RE.search(line)
            if m and m.group(1) in ids_to_find:
                ids_found.add(m.group(1))
                ids_to_find.discard(m.group(1))
                write.write(line.rstrip("\n") + "\n")
                n_subs += 1
    with open(rc_path) as read, open(out_comments, "w") as write:
        for line in read:
            m = COMMENT_LINK_RE.search(line)
            if m and m.group(1) in ids_found:
                write.write(line.rstrip("\n") + "\n")
                n_comments += 1
    return n_subs, n_comments


def gather(
    label_parquet_glob: str,
    work_dir: str,
    time_lookup: Callable[[List[str]], Dict[str, Tuple[int, str]]],
    dump_fetcher: Optional[Callable[[str], Tuple[str, str]]] = None,
) -> "pd.DataFrame":
    """Stage-1 entry point: join (created_utc, link_id) onto the labels, group by
    month, and filter each month's dumps. ``dump_fetcher(date)`` must return
    local paths to the decompressed (RS, RC) files for that month — download
    + unzstd in the reference (lines 76-79)."""
    import pandas as pd

    df = pd.concat([pd.read_parquet(x) for x in glob(label_parquet_glob)])
    ids = list(df["id"].unique())
    times = time_lookup(ids)
    tdf = pd.DataFrame(
        {
            "id": list(times),
            "created_utc": [times[i][0] for i in times],
            "link_id": [times[i][1][3:] for i in times],
        }
    ).set_index("id")
    df = df.drop("link_id", axis=1, errors="ignore").set_index("id").join(tdf)
    df = df.dropna()
    df["formatted_date"] = df["created_utc"].apply(formatted_month)
    os.makedirs(work_dir, exist_ok=True)
    df.to_parquet(os.path.join(work_dir, "complete_dataframe.parquet"))

    if dump_fetcher is not None:
        for date, group in df.groupby("formatted_date"):
            rs, rc = dump_fetcher(str(date))
            filter_month_dump(
                rs, rc, group["link_id"].unique(),
                os.path.join(work_dir, f"{date}-submissions.json"),
                os.path.join(work_dir, f"{date}-comments.json"),
            )
    return df
