"""Two versions of the bf16 tensor-core tree kernels (the forward, the dq
kernel and the dk/dv kernel) timed against each other in one process on
one card.

    python -m multimodaldiscussiontransformer_tpu_torch.utils.tree_kernel_ab \\
        OTHER_CSRC [--this-csrc DIR] [--dh 64] [--heads 12] [--rounds 12]

OTHER_CSRC and ``--this-csrc`` (default: the port's ``csrc/``) are
directories holding a version's ``tree_attention_fwd_mma.cu``,
``tree_attention_bwd_mma.cu`` and the headers they include, for example a
parent commit's sources written out by ``git archive`` into a directory
that git ignores. Both are compiled with the port's nvcc flags, four nvcc
at once, and bound in turn under the port's wrappers, so both get the same
arguments. At each shape (bf16, rate 0.3, templates collated from synthetic
trees; ``--shapes`` S x B, default 33x12, 601x1, 1025x1) the versions take
``--rounds`` rounds each, in the order other, this, this, other, ...; a
round is one profiler session over ``--calls`` calls of each kernel, and a
kernel's time is its device time per launch the profiler saw (it drops
some at times; the count stands beside the time). One JSON line per shape:
each round's ms, each version's median, least and most, the spread (most
less least, over the median) and this version's median over the other's;
and this version's outputs against the other's (out, the LSE, dq, dlut,
dk, dv: max abs difference over max |other|). Then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

LIBS = {"tree_fwd_mma": "tree_attention_fwd_mma.cu", "tree_bwd_mma": "tree_attention_bwd_mma.cu"}
# a kernel's device time is that of the CUDA kernels whose names hold these
MARKERS = {"fwd": "tree_attention_fwd_mma_kernel", "dq": "tree_attention_bwd_dq_mma_kernel",
           "dkv": "tree_attention_bwd_dkv_mma_kernel"}
RATE, SEED = 0.3, 7


def build(csrc: Path, out_dir: Path, tag: str) -> dict:
    """Start nvcc for both tree sources of ``csrc``: {library: (process, path)}."""
    from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib

    nvcc = os.environ.get("NVCC") or shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for lib, src in LIBS.items():
        path = out_dir / f"{tag}_{lib}.so"
        cmd = [nvcc, *cuda_lib.NVCC_FLAGS, "-o", str(path), str(csrc / src)]
        procs[lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), path)
    return procs


def wait(procs: dict) -> dict:
    """Wait for ``build``'s nvcc: {library: path}."""
    for lib, (proc, path) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path.name}: {err}")
    return {lib: path for lib, (_, path) in procs.items()}


def graph_inputs(s: int, b: int, h: int, seed: int):
    """Template, ids and LUT of ``b`` collated synthetic trees whose node
    bucket is s - 1 (the first tree fills it)."""
    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.data.collator import collate
    from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_item
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    rng = np.random.default_rng(seed)
    sizes = [s - 1] + [int(rng.integers((s - 1) // 2 + 1, s)) for _ in range(b - 1)]
    items = [synthetic_item(i, m, rng, seq_len=4, vocab_size=64, image_prob=0.0) for i, m in enumerate(sizes)]
    batch = collate(items, image_capacity_buckets=(0,))
    gen = torch.Generator().manual_seed(seed)
    table, virtual = torch.randn(512, h, generator=gen), torch.randn(1, h, generator=gen)
    return ta.build_compact_bias_inputs(torch.from_numpy(batch.attn_bias), torch.from_numpy(batch.spatial_pos),
                                        table, virtual)


def round_ms(calls: dict, n: int) -> dict:
    """Device ms per launch of each kernel in ``calls`` ({name: fn}), from
    one profiler session over ``n`` calls of each, and under ``events`` the
    launches the profiler saw of each. The profiler drops some launches at
    times, so a kernel's time is over those it saw, not over ``n``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
    us, seen = {name: 0.0 for name in calls}, {name: 0 for name in calls}
    for e in prof.key_averages():
        for name, marker in MARKERS.items():
            if marker in e.key:
                us[name] += e.self_device_time_total
                seen[name] += e.count
    return {**{name: us[name] / seen[name] / 1e3 for name in calls}, "events": seen}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other_csrc", type=Path)
    p.add_argument("--this-csrc", type=Path, default=None, help="default: the port's csrc/")
    p.add_argument("--dh", type=int, default=64)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--shapes", default="33x12,601x1,1025x1", help="S x B, comma separated")
    p.add_argument("--rounds", type=int, default=12, help="rounds of each version at each shape")
    p.add_argument("--calls", type=int, default=200, help="calls of each kernel in a round")
    args = p.parse_args(argv)

    import torch

    from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    if not torch.cuda.is_available():
        print("tree_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    this_csrc = args.this_csrc or cuda_lib.CSRC
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        started = {"other": build(args.other_csrc, Path(tmp), "other"), "this": build(this_csrc, Path(tmp), "this")}
        versions = {tag: cuda_lib.bind(wait(procs)) for tag, procs in started.items()}
        h, dh = args.heads, args.dh
        scale = dh ** -0.5
        for shape in args.shapes.split(","):
            s, b = (int(x) for x in shape.split("x"))
            template, ids, lut = (t.cuda() for t in graph_inputs(s, b, h, s))
            gen = torch.Generator(device="cuda").manual_seed(s)
            q, k, v, g = (torch.randn(b, h, s, dh, device="cuda", generator=gen).bfloat16() for _ in range(4))

            def calls_of(tag):
                """Each kernel of version ``tag`` as a call, and its outputs."""
                cuda_lib._libs = versions[tag]  # the wrappers launch this version's kernels
                out, lse = ta.tree_attention_fwd_fused(q, k, v, template, ids, lut, scale, True, RATE, SEED, True)
                dq, dlut, delta = ta.tree_attention_bwd_dq_fused(q, k, v, out, g, template, ids, lut, lse, scale,
                                                                 True, RATE, SEED)
                dk, dv = ta.tree_attention_bwd_dkv_fused(q, k, v, g, template, ids, lut, lse, delta, scale, True,
                                                         RATE, SEED)
                calls = {
                    "fwd": lambda: ta.tree_attention_fwd_fused(q, k, v, template, ids, lut, scale, True, RATE, SEED,
                                                               True),
                    "dq": lambda: ta.tree_attention_bwd_dq_fused(q, k, v, out, g, template, ids, lut, lse, scale,
                                                                 True, RATE, SEED),
                    "dkv": lambda: ta.tree_attention_bwd_dkv_fused(q, k, v, g, template, ids, lut, lse, delta, scale,
                                                                   True, RATE, SEED),
                }
                return calls, {"out": out, "lse": lse, "dq": dq, "dlut": dlut, "dk": dk, "dv": dv}

            outputs = {}
            for tag in ("other", "this"):  # warm-up: builds the launch state and brings the clocks up
                calls, outputs[tag] = calls_of(tag)
                round_ms(calls, args.calls)
            rounds = {"other": [], "this": []}
            for r in range(args.rounds):
                for tag in (("other", "this") if r % 2 == 0 else ("this", "other")):
                    calls, _ = calls_of(tag)
                    rounds[tag].append(round_ms(calls, args.calls))
            summary = {}
            for tag, rs in rounds.items():
                summary[tag] = {}
                for name in MARKERS:
                    ms = [x[name] for x in rs]
                    med = statistics.median(ms)
                    summary[tag][name] = {"median": med, "least": min(ms), "most": max(ms),
                                          "spread": (max(ms) - min(ms)) / med}
            diff = {n: ((outputs["this"][n].float() - outputs["other"][n].float()).abs().max()
                        / outputs["other"][n].float().abs().max().clamp_min(1e-30)).item() for n in outputs["other"]}
            line = {"S": s, "B": b, "H": h, "dh": dh, "rate": RATE, "calls": args.calls, "card": card,
                    "rounds_ms": rounds, "summary_ms": summary,
                    "this_over_other": {n: summary["this"][n]["median"] / summary["other"][n]["median"]
                                        for n in MARKERS},
                    "max_diff_over_max_other": diff}
            print(json.dumps(line), flush=True)
        print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
