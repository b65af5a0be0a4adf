"""Checkpoint averaging CLI (FairSeq's ``scripts/average_checkpoints.py``),
the port's copy of the JAX package's ``utils/average_checkpoints.py``:

    python -m multimodaldiscussiontransformer_tpu_torch.utils.average_checkpoints \\
        --inputs ckpts/run0 --num-last 3 --output ckpts/run0-avg

The output directory holds a params-only checkpoint (step 0) that
``--restore-file <output> --reset-optimizer`` and
``serve.incremental.DiscussionScorer.from_checkpoint`` take.
"""

from __future__ import annotations

import argparse
import sys

from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import average_checkpoints, save_params


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--inputs", required=True, help="checkpoint save dir (its steps are the inputs)")
    p.add_argument("--output", required=True, help="directory for the averaged params checkpoint")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--num-last", type=int, default=None, help="average the newest K retained steps")
    g.add_argument("--steps", default=None, help="comma-separated explicit step numbers")
    args = p.parse_args(argv)

    steps = [int(s) for s in args.steps.split(",") if s.strip()] if args.steps else None
    save_params(args.output, average_checkpoints(args.inputs, steps=steps, last_k=args.num_last))
    print(f"averaged params written to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
