#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure exits non-zero:

1. build: compile the tree-attention kernel from ``csrc/`` with nvcc
   (sm_90a), and print the card's name and power limit as nvidia-smi
   reports them.
2. kernel_vs_plain: the kernel against its plain PyTorch version on the card,
   at H=12, dh=64, double_add, with templates/ids collated from synthetic
   trees: S=33 (B=16), S=129 and S=257 (B=2), S=601 (B=1); in float32 (TF32
   off) and in bfloat16. Each shape also gets times (CUDA events) for the
   kernel, the plain version and one library call on the assembled dense
   bias (``F.scaled_dot_product_attention``, a yardstick the port never
   calls), beside the least time the card could take.
3. scoring: the canonical ``ModelConfig()`` at full width with random
   weights from a seeded ``torch.Generator``, scored through
   ``BatchingScorer`` from 4 threads (discussions of ~20, ~100 and 600
   nodes, 100-token text, some nodes with a 3x224x224 image). Checks finite
   probabilities that sum to 1, exactly 10 kernel launches per forward, and
   agreement with the same model on the CPU (float32) on one small
   discussion.
4. latency: per-request-batch scoring latency at batch 1, 4 and 16, and
   the device time of a batch-4 forward (``torch.profiler``) against its
   wall time, beside the host's time to collate that batch and copy it to
   the card.

The last two lines are the kernels' summary and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

# published H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain version, float32 with TF32 off: the two differ only in
# the order of f32 sums over dh=64 and S keys (~1e-6 here); 1e-4 leaves
# two orders of margin
F32_ATOL = 1e-4
# bfloat16: both compute in f32 from the same bf16 inputs and round the
# result to bf16 once, so they may differ by one bf16 step, i.e. 2^-7 of
# the value at most (atol covers values near zero)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
# full model, GPU float32 (TF32 off) vs CPU float32: ~20 layers of f32
# matmuls summed in another order; per-node probabilities
MODEL_ATOL = 1e-4

# the canonical model runs 5 graph stacks of 2 layers per forward
LAUNCHES_PER_FORWARD = 10
IMAGE_SHAPE = (3, 224, 224)

KERNEL_SOURCE = "multimodaldiscussiontransformer_tpu_torch/csrc/tree_attention_fwd.cu"
TPU_KERNELS = "multimodaldiscussiontransformer_tpu/ops/tree_attention.py"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """Milliseconds of device time per call: the CUDA kernels' self time
    from ``torch.profiler`` over ``iters`` calls (None if the profiler saw
    no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


def bound(b: int, h: int, s: int, dh: int, dtype_name: str):
    """(ms, "bytes"|"operations"): each input read once, the output written
    once, over the HBM rate; 4*B*H*S^2*dh operations over the peak rate of
    the input type."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * b * h * s * dh * item + 2 * b * s * s * 4 + 32 * h * 4
    flops = 4 * b * h * s * s * dh
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    t0 = time.perf_counter()
    lib = ta.build()
    seconds = time.perf_counter() - t0
    ta.load_library()
    ptxas = [
        ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
        if "registers" in ln or "spill" in ln
    ]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": round(seconds, 3), "library": lib.name, "ptxas": ptxas})
    print(card, flush=True)
    return card


def compact_inputs(s: int, b: int, h: int, seed: int):
    """Collated template/ids/lut for ``b`` synthetic trees whose node
    bucket is s-1."""
    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.data.collator import collate
    from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_item
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    rng = np.random.default_rng(seed)
    n = s - 1
    sizes = [n] + [int(rng.integers(n // 2 + 1, n + 1)) for _ in range(b - 1)]
    items = [
        synthetic_item(i, m, rng, seq_len=4, vocab_size=64, image_prob=0.0)
        for i, m in enumerate(sizes)
    ]
    batch = collate(items, image_capacity_buckets=(0,))
    assert batch.attn_bias.shape == (b, s, s), batch.attn_bias.shape
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(512, h, generator=g)
    virtual = torch.randn(1, h, generator=g)
    return ta.build_compact_bias_inputs(
        torch.from_numpy(batch.attn_bias), torch.from_numpy(batch.spatial_pos), table, virtual
    )


def phase_kernel(seed: int):
    import torch
    import torch.nn.functional as F

    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    h, dh = 12, 64
    rows = []
    for s, b in ((33, 16), (129, 2), (257, 2), (601, 1)):
        template, ids, lut = (t.cuda() for t in compact_inputs(s, b, h, seed + s))
        g = torch.Generator(device="cuda").manual_seed(seed + s)
        q, k, v = (torch.randn(b, h, s, dh, device="cuda", generator=g) for _ in range(3))
        row = {"S": s, "B": b, "H": h, "dh": dh}
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            qq, kk, vv = (x.to(dt).contiguous() for x in (q, k, v))
            got = ta.tree_attention(qq, kk, vv, template, ids, lut)
            want = ta.tree_attention_reference(qq, kk, vv, template, ids, lut)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if name == "float32":
                ok = bool((err <= F32_ATOL).all())
            else:
                ok = bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
            if not (ok and torch.isfinite(got).all()):
                raise AssertionError(f"kernel disagrees with plain version at S={s} B={b} {name}: max err {err.max().item()}")
            row[f"max_abs_err_{name}"] = err.max().item()
        # times in the main path's type
        qq, kk, vv = (x.to(torch.bfloat16).contiguous() for x in (q, k, v))
        dense = ta.assemble_bias(template, ids, lut, True).to(torch.bfloat16)
        calls = {
            "": lambda: ta.tree_attention(qq, kk, vv, template, ids, lut),
            "plain_": lambda: ta.tree_attention_reference(qq, kk, vv, template, ids, lut),
            "library_": lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=dense, scale=dh ** -0.5),
        }
        for prefix, fn in calls.items():
            # per call as a caller sees it (host launch work included), and
            # the device time alone; "ms" is the device time where the
            # profiler gives one
            row[prefix + "call_ms"] = time_cuda(fn, 200 if s <= 257 else 50)
            row[prefix + "device_ms"] = device_ms(fn)
            row[prefix + "ms"] = row[prefix + "device_ms"] or row[prefix + "call_ms"]
        row["bound_ms"], row["bound_by"] = bound(b, h, s, dh, "bfloat16")
        row["tolerance"] = {"float32_atol": F32_ATOL, "bfloat16_rtol": BF16_RTOL, "bfloat16_atol": BF16_ATOL}
        emit({"phase": "kernel_vs_plain", **row})
        rows.append(row)
    return rows


def make_discussion(rng, n: int, image_prob: float, seq_len: int = 100, vocab: int = 30522):
    import numpy as np

    from multimodaldiscussiontransformer_tpu_torch.data.synthetic import random_tree_parents
    from multimodaldiscussiontransformer_tpu_torch.serve.incremental import Discussion

    d = Discussion()
    for i, p in enumerate(random_tree_parents(n, rng)):
        ids = np.zeros(seq_len, np.int32)
        ln = int(rng.integers(5, seq_len + 1))
        ids[:ln] = rng.integers(1, vocab, ln)
        image = None
        if rng.random() < image_prob:
            image = rng.standard_normal(IMAGE_SHAPE).astype(np.float32)
        d.add_node(int(p), ids, image=image)
    return d


def phase_scoring(seed: int):
    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
    from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
    from multimodaldiscussiontransformer_tpu_torch.serve.incremental import DiscussionScorer
    from multimodaldiscussiontransformer_tpu_torch.serve.server import BatchingScorer

    cfg = ModelConfig()
    t0 = time.perf_counter()
    model = MDTModel(cfg, generator=torch.Generator().manual_seed(seed))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    init_s = time.perf_counter() - t0
    scorer = DiscussionScorer(model, device="cuda", image_shape=IMAGE_SHAPE)
    per_forward = cfg.num_graph_stack * (
        len(model.graph_encoder.fusion_stacks) + (0 if cfg.reproduce_dead_graph_stack else 1)
    )
    if per_forward != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"the config runs {per_forward} graph layers, expected {LAUNCHES_PER_FORWARD}")

    rng = np.random.default_rng(seed)
    requests = {
        "small_images": [make_discussion(rng, int(rng.integers(16, 25)), 0.2) for _ in range(3)],
        "medium": [make_discussion(rng, int(rng.integers(90, 111)), 0.1) for _ in range(2)],
        "giant": [make_discussion(rng, 600, 0.05)],
        "small_text_only": [make_discussion(rng, int(rng.integers(16, 25)), 0.0) for _ in range(3)],
    }
    scorer.score(requests["small_images"][0])  # warm-up, outside the counted run
    torch.cuda.synchronize()

    calls = []
    inner = scorer.score_items

    def timed(items):
        t = time.perf_counter()
        out = inner(items)  # ends in a device-to-host copy, so it has synced
        calls.append({"graphs": len(items), "max_nodes": max(it.num_nodes for it in items),
                      "seconds": time.perf_counter() - t})
        return out

    scorer.score_items = timed
    batching = BatchingScorer(scorer, max_batch=16, max_wait_ms=5.0)
    results, errors = {}, []

    def worker(name):
        try:
            results[name] = [batching.score(d) for d in requests[name]]
        except BaseException as e:  # reported below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    ta.tree_attention.launches = 0
    threads = [threading.Thread(target=worker, args=(name,)) for name in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    launches = ta.tree_attention.launches
    batching.close()
    scorer.score_items = inner
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"scoring failed: {errors or 'a worker did not finish'}")
    for name, ds in requests.items():
        for d, p in zip(ds, results[name]):
            if p.shape != (d.num_nodes, cfg.num_classes) or not np.isfinite(p).all():
                raise AssertionError(f"{name}: bad probabilities {p.shape}")
            if np.abs(p.sum(-1) - 1.0).max() > 1e-5:
                raise AssertionError(f"{name}: probabilities do not sum to 1")
    if launches != per_forward * len(calls):
        raise AssertionError(f"{launches} kernel launches for {len(calls)} forwards, expected {per_forward} each")
    emit({"phase": "scoring", "config": "ModelConfig() canonical, bfloat16 compute", "init_seconds": init_s,
          "forwards": len(calls), "launches": launches, "launches_per_forward": launches / len(calls),
          "request_batches": calls})

    # the same weights in float32, on the card (TF32 off) and on the CPU
    cfg32 = cfg.replace(dtype="float32")
    small = make_discussion(rng, 24, 0.15)
    probs = {}
    for dev in ("cuda", "cpu"):
        m = MDTModel(cfg32)
        m.load_state_dict(state)
        t = time.perf_counter()
        probs[dev] = DiscussionScorer(m, device=dev, image_shape=IMAGE_SHAPE).score(small)
        probs[dev + "_seconds"] = time.perf_counter() - t
        del m
    bf16 = scorer.score(small)
    err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    emit({"phase": "cpu_agreement", "nodes": small.num_nodes, "images": len(small.images),
          "depth": "full", "max_abs_err_f32": err, "atol": MODEL_ATOL,
          "max_abs_err_bf16_vs_cpu_f32": float(np.abs(bf16 - probs["cpu"]).max()),
          "cpu_seconds": probs["cpu_seconds"]})
    if not err <= MODEL_ATOL:
        raise AssertionError(f"GPU float32 scores differ from the CPU's by {err}")
    return scorer, launches, rng


def phase_latency(scorer, rng):
    import numpy as np
    import torch

    discussions = [make_discussion(rng, 20, 0.2) for _ in range(16)]
    out = {}
    for b in (1, 4, 16):
        items = [d.to_item(i) for i, d in enumerate(discussions[:b])]
        scorer.score_items(items)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            scorer.score_items(items)
            times.append((time.perf_counter() - t) * 1e3)
        out[str(b)] = {"median_ms": float(np.median(times)), "all_ms": times}
    emit({"phase": "latency", "nodes_per_discussion": 20, "image_prob": 0.2,
          "text_len": 100, "per_request_batch": out})

    # where a request batch's time goes: device time of its kernels (by
    # torch.profiler) against the wall time of the same forwards
    from torch.profiler import ProfilerActivity, profile

    items = [d.to_item(i) for i, d in enumerate(discussions[:4])]
    reps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            scorer.score_items(items)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    # device work only (kernels, copies, memsets); runtime calls carry no
    # device time
    events = sorted(
        (e for e in prof.key_averages() if e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    device_ms = sum(e.self_device_time_total for e in events) / reps / 1e3
    tree_ms = sum(e.self_device_time_total for e in events if "tree_attention" in e.key) / reps / 1e3
    top = [
        {"kernel": e.key[:80], "ms": e.self_device_time_total / reps / 1e3, "count": e.count // reps}
        for e in events[:12]
    ]

    # the host's share before the forward: collate, then the copy to the card
    from multimodaldiscussiontransformer_tpu_torch.data.collator import to_tensors

    collate_ms, copy_ms = [], []
    for _ in range(reps):
        t = time.perf_counter()
        batch = scorer.collate(items)
        t1 = time.perf_counter()
        to_tensors(batch, scorer.device)
        torch.cuda.synchronize()
        collate_ms.append((t1 - t) * 1e3)
        copy_ms.append((time.perf_counter() - t1) * 1e3)
    emit({"phase": "trace", "request_batch": 4, "wall_ms": wall_ms, "device_ms": device_ms,
          "device_busy_share": device_ms / wall_ms if wall_ms else None,
          "tree_attention_ms": tree_ms, "device_ops_per_forward": sum(e.count for e in events) // reps,
          "host_collate_ms": float(np.median(collate_ms)), "host_to_device_ms": float(np.median(copy_ms)),
          "batch_bytes": sum(v.nbytes for v in batch.asdict().values()),
          "top_kernels": top})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_build()
    rows = phase_kernel(args.seed)
    scorer, launches, rng = phase_scoring(args.seed)
    phase_latency(scorer, rng)

    main_row = rows[0]  # S=33, B=16: the canonical serving shape
    print(card, flush=True)
    emit({"kernels": [{
        "name": "tree_attention_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": f"{TPU_KERNELS}:103",
        "also_replaces": [f"{TPU_KERNELS}:66", f"{TPU_KERNELS}:228"],
        "launches": launches,
        "max_abs_err": main_row["max_abs_err_bfloat16"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
