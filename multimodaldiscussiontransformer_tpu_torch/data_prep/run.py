"""Offline pipeline CLI — runnable equivalents of the reference's numbered
Pre-Processing scripts:

    python -m multimodaldiscussiontransformer_tpu_torch.data_prep.run labels-cad cad_v1_1.tsv cad-processed.parquet
    python -m multimodaldiscussiontransformer_tpu_torch.data_prep.run labels-slurs kurrek.2020.slur-corpus.csv slurs-processed.parquet
    python -m multimodaldiscussiontransformer_tpu_torch.data_prep.run combine <data_dir>            # stage 2
    python -m multimodaldiscussiontransformer_tpu_torch.data_prep.run prune complete-graphs.json pruned-graphs.json   # stage 3
    python -m multimodaldiscussiontransformer_tpu_torch.data_prep.run images pruned-graphs.json pruned-with-images.json --fetch  # stage 4
    python -m multimodaldiscussiontransformer_tpu_torch.data_prep.run splits pruned-with-images.json <out_dir>  # stage 5 (the missing script)
    python -m multimodaldiscussiontransformer_tpu_torch.data_prep.run export pruned-with-images.json <split_dir> <out_dir>  # stage 6

Where pandas is not installed, ``splits`` writes the duplicated texts as
``duped.json`` (a JSON list) instead of ``duped.parquet``, and ``export
--duped`` reads either; the other stages that write parquet need pandas.

The PyTorch port's copy of the JAX package's ``data_prep/run.py``.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="mDT offline data pipeline")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("labels-cad")
    s.add_argument("tsv"); s.add_argument("out")
    s = sub.add_parser("labels-slurs")
    s.add_argument("csv"); s.add_argument("out")
    s = sub.add_parser("labels-lti")
    s.add_argument("csv"); s.add_argument("out")
    s = sub.add_parser("combine")
    s.add_argument("data_dir"); s.add_argument("--out", default="complete-graphs.json")
    s = sub.add_parser("prune")
    s.add_argument("infile"); s.add_argument("outfile")
    s = sub.add_parser("images")
    s.add_argument("infile"); s.add_argument("outfile")
    s.add_argument("--image-root", default=".")
    s.add_argument("--fetch", action="store_true", help="download via HTTP (network)")
    s = sub.add_parser("splits")
    s.add_argument("json_path"); s.add_argument("out_dir")
    s.add_argument("--n-splits", type=int, default=7)
    s.add_argument("--test-frac", type=float, default=0.2)
    s.add_argument("--seed", type=int, default=0)
    s = sub.add_parser("export")
    s.add_argument("json_path"); s.add_argument("split_dir"); s.add_argument("out_dir")
    s.add_argument("--duped", default=None)
    s.add_argument("--n-splits", type=int, default=7)

    a = p.parse_args(argv)

    if a.cmd == "labels-cad":
        from multimodaldiscussiontransformer_tpu_torch.data_prep.labels import process_cad

        df = process_cad(a.tsv, a.out)
        print(f"{len(df)} labels -> {a.out}")
    elif a.cmd == "labels-slurs":
        from multimodaldiscussiontransformer_tpu_torch.data_prep.labels import process_slurs

        df = process_slurs(a.csv, a.out)
        print(f"{len(df)} labels -> {a.out}")
    elif a.cmd == "labels-lti":
        from multimodaldiscussiontransformer_tpu_torch.data_prep.labels import process_lti

        df = process_lti(a.csv, a.out)
        print(f"{len(df)} labels -> {a.out} (link_ids unresolved: offline)")
    elif a.cmd == "combine":
        from multimodaldiscussiontransformer_tpu_torch.data_prep.trees import combine_months

        n = combine_months(a.data_dir, out_path=a.out)
        print(f"labels: {n}")
    elif a.cmd == "prune":
        from multimodaldiscussiontransformer_tpu_torch.data_prep.trees import prune_file

        n = prune_file(a.infile, a.outfile)
        print(f"pruned {n} trees")
    elif a.cmd == "images":
        from multimodaldiscussiontransformer_tpu_torch.data_prep.images import (
            annotate_and_fetch,
            requests_fetcher,
        )

        fetcher = requests_fetcher() if a.fetch else None
        n = annotate_and_fetch(a.infile, a.outfile, a.image_root, fetcher)
        print(f"{n} image jobs")
    elif a.cmd == "splits":
        from multimodaldiscussiontransformer_tpu_torch.data_prep.splits import (
            build_dupe_table,
            make_splits,
        )
        import os

        os.makedirs(a.out_dir, exist_ok=True)
        try:
            import pandas  # noqa: F401  (parquet needs it)

            duped = build_dupe_table(
                a.json_path, os.path.join(a.out_dir, "duped.parquet")
            )
        except ImportError:
            # no pandas here: the same table as a JSON list of texts
            duped = build_dupe_table(a.json_path)
            with open(os.path.join(a.out_dir, "duped.json"), "w") as f:
                json.dump(duped, f)
            print("pandas is not installed: duplicated texts -> duped.json")
        splits = make_splits(
            a.json_path, a.out_dir, a.n_splits, a.test_frac, a.seed
        )
        print(f"{len(duped)} duplicated texts; {len(splits)} splits -> {a.out_dir}")
    elif a.cmd == "export":
        from multimodaldiscussiontransformer_tpu_torch.data_prep.text_export import (
            export_splits,
        )

        duped = None
        if a.duped and a.duped.endswith(".json"):
            with open(a.duped) as f:
                duped = json.load(f)
        elif a.duped:
            import pandas as pd

            duped = list(pd.read_parquet(a.duped)["text"])
        total = export_splits(
            a.json_path, a.split_dir, a.out_dir, duped=duped, n_splits=a.n_splits
        )
        print(f"TOTAL {total}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
