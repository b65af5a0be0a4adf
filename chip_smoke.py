#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure exits non-zero:

1. build: compile the tree-attention kernels from ``csrc/`` with nvcc
   (sm_90a; one nvcc per source, in parallel), and print the card's name
   and power limit as nvidia-smi reports them.
2. kernel_vs_plain: the forward kernel at rate 0 against its plain PyTorch
   version on the card, at H=12, dh=64, double_add, with templates/ids
   collated from synthetic trees: S=33 (B=16), S=129 and S=257 (B=2), S=601
   (B=1); in float32 (TF32 off) and in bfloat16. Each shape also gets times
   for the kernel, the plain version and one library call on the assembled
   dense bias (``F.scaled_dot_product_attention``, a yardstick the port
   never calls), beside the least time the card could take.
3. kernel_vs_plain_train: the forward kernel at rate 0.3 with the LSE
   output and the two backward kernels against the plain version's forward
   and autograd gradients at S=33 (B=12), 129 (B=4), 257 (B=2), in float32
   and bfloat16; the adjoint identity in v; times of each kernel, the plain
   version and SDPA (forward, and forward + backward at rate 0). Then
   dropout_mask: the forward kernel's mask read back equals the plain
   Philox, and its kept fraction.
4. scoring: the canonical ``ModelConfig()`` at full width with random
   weights from a seeded ``torch.Generator``, scored through
   ``BatchingScorer`` from 4 threads (discussions of ~20, ~100 and 600
   nodes, 100-token text, some nodes with a 3x224x224 image). Checks finite
   probabilities that sum to 1, exactly 10 forward launches per forward and
   no backward launch, and agreement with the same model on the CPU
   (float32) on one small discussion.
5. latency: per-request-batch scoring latency at batch 1, 4 and 16, and
   the device time of a batch-4 forward (``torch.profiler``) against its
   wall time, beside the host's time to collate that batch and copy it to
   the card.
6. train: the canonical run (``launch`` flag resolution, batch 12 x
   update_freq 3, dropout 0.4/0.3/0.3, frozen towers) at full width through
   ``NodePredictionTask(cfg).build_trainer()`` and ``Trainer.fit`` on
   synthetic discussions of 8-32 nodes with 100-token text and 3x224x224
   images on 25% of nodes: one untimed update, then 5 timed ones. Checks a
   finite, changing loss, exactly 30/24/24 launches of the forward, dq and
   dkv kernels per update (10 graph layers x 3 microbatches forward; the
   last graph stack's 2 layers feed only the global embedding, so their
   backward never runs), frozen towers unchanged and every tensor with a
   nonzero gradient changed; prints ms per update, discussions/s, MFU against 989 TFLOP/s,
   peak memory, and (train_trace) one profiled update's device time.
7. train_cpu_agreement: one scan update of the tiny config with every
   dropout at 0 in float32, on the card and on the CPU: gradients and
   updated parameters agree.
8. launch: ``train.launch.main`` with ``--synthetic --max-updates 2`` on the
   card returns 0.

The last two lines are the kernels' summary and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
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
    libs = ta.build()  # one nvcc per source, in parallel
    seconds = time.perf_counter() - t0
    ta.load_library()
    ptxas = [
        ln.strip() for lib in libs.values() for ln in lib.with_suffix(".log").read_text().splitlines()
        if "registers" in ln or "spill" in ln
    ]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": round(seconds, 3), "libraries": [p.name for p in libs.values()], "ptxas": ptxas})
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

    for fn in ta.KERNELS:
        fn.launches = 0
    threads = [threading.Thread(target=worker, args=(name,)) for name in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    launches = ta.tree_attention_fwd.launches
    if ta.tree_attention_bwd_dq.launches or ta.tree_attention_bwd_dkv.launches:
        raise AssertionError("the scoring path launched a backward kernel")
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


# training kernels: the canonical node buckets 32, 128, 256 (S = 33, 129,
# 257) at the batch sizes whose tensors a 12-discussion microbatch gives
TRAIN_SHAPES = ((33, 12), (129, 4), (257, 2))
TRAIN_RATE = 0.3
# kernels vs plain version, relative to the largest |ref| of each output:
# float32 (TF32 off) differs by sum order and, for dlut, by the atomics'
# run-to-run order; bfloat16 by the kernels' bf16 rounding of out and g
# before g . out and of every output (a few steps of 2^-8)
TRAIN_F32_REL = 1e-4
TRAIN_BF16_REL = 1e-2
ADJOINT_REL = 1e-4
# the train phase: 1 untimed update, then this many timed ones
TIMED_UPDATES = 5
TRAIN_GRAPHS = 240  # 192 train graphs: 16 microbatches of 12, 6 updates an epoch
# train_cpu_agreement: tiny config, float32, card (TF32 off) vs CPU:
# gradients within rtol 2e-4 + atol 1e-6 (sum order); parameters after
# AdamW within rtol 2e-4 + atol 2e-5 where |grad| > 1e-4, and within
# 2.05 lr elsewhere (Adam's first step is lr * g / (|g| + eps))
AGREE_GRAD_RTOL, AGREE_GRAD_ATOL = 2e-4, 1e-6
AGREE_PARAM_RTOL, AGREE_PARAM_ATOL = 2e-4, 2e-5
H100_BF16_PEAK = 989e12

BWD_SOURCE = "multimodaldiscussiontransformer_tpu_torch/csrc/tree_attention_bwd.cu"


def train_bounds(b: int, h: int, s: int, dh: int, dtype_name: str):
    """{kernel: (ms, "bytes"|"operations")} for the three training kernels:
    each input read once and each output written once over the HBM rate,
    and the operations of each kernel's function over the peak of its type
    (fwd 4, dq 6, dkv 8 x B*H*S^2*dh: scores, g.v, and the products each
    writes)."""
    item = 2 if dtype_name == "bfloat16" else 4
    qkv = b * h * s * dh * item
    shared = 2 * b * s * s * 4 + 32 * h * 4  # tpl, ids, lut
    row = b * h * s * 4  # lse or delta
    work = {
        "fwd": (4 * qkv + shared + row, 4),  # q k v in, out and lse out
        "dq": (6 * qkv + shared + 2 * row + 32 * h * 4, 6),  # q k v out g in, dq delta dlut out
        "dkv": (6 * qkv + shared + 2 * row, 8),  # q k v g lse delta in, dk dv out
    }
    out = {}
    for name, (nbytes, per) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = per * b * h * s * s * dh / PEAK_FLOPS[dtype_name]
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def _fwd_and_grads(fn, q, k, v, template, ids, lut, g, **kw):
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v, lut)]
    out = fn(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], **kw)
    out.backward(g)
    return [out.detach()] + [x.grad for x in leaves]


def phase_kernel_train(seed: int):
    """K1 (rate 0.3, LSE) + K2 + K3 against the plain version's forward and
    autograd gradients; the adjoint identity in v; the kernel's mask read
    back against the plain Philox; times."""
    import torch
    import torch.nn.functional as F

    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    h, dh = 12, 64
    scale = dh ** -0.5
    rows = []
    for s, b in TRAIN_SHAPES:
        template, ids, lut = (t.cuda() for t in compact_inputs(s, b, h, seed + 7 * s))
        gen = torch.Generator(device="cuda").manual_seed(seed + s)
        q, k, v, g = (torch.randn(b, h, s, dh, device="cuda", generator=gen) for _ in range(4))
        dseed = seed * 1000003 + s
        row = {"S": s, "B": b, "H": h, "dh": dh, "rate": TRAIN_RATE, "errors": {}}
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            qq, kk, vv, gg = (x.to(dt).contiguous() for x in (q, k, v, g))
            got = _fwd_and_grads(ta.tree_attention, qq, kk, vv, template, ids, lut, gg, rate=TRAIN_RATE, seed=dseed)
            want = _fwd_and_grads(ta.tree_attention_dropout_reference, qq, kk, vv, template, ids, lut, gg, rate=TRAIN_RATE, seed=dseed)
            torch.cuda.synchronize()
            tol = TRAIN_F32_REL if name == "float32" else TRAIN_BF16_REL
            errs = {}
            for out_name, a, w in zip(("out", "dq", "dk", "dv", "dlut"), got, want):
                abs_err = (a.float() - w.float()).abs().max().item()
                errs[out_name] = {"max_abs_err": abs_err, "max_abs_ref": w.float().abs().max().item()}
                if not (torch.isfinite(a).all() and abs_err <= tol * errs[out_name]["max_abs_ref"]):
                    raise AssertionError(f"training kernels disagree at S={s} {name} {out_name}: {errs[out_name]} (rel tol {tol})")
            row["errors"][name] = errs
        # the adjoint identity in v: exact only if the backward regenerates
        # the forward's mask
        v2 = torch.randn(b, h, s, dh, device="cuda", generator=gen)
        vv = v.clone().requires_grad_(True)
        ta.tree_attention(q, k, vv, template, ids, lut, rate=TRAIN_RATE, seed=dseed).backward(g)
        lhs = (g.double() * ta.tree_attention(q, k, v2, template, ids, lut, rate=TRAIN_RATE, seed=dseed).double()).sum().item()
        rhs = (vv.grad.double() * v2.double()).sum().item()
        row["adjoint"] = {"lhs": lhs, "rhs": rhs, "rel_err": abs(lhs - rhs) / max(abs(lhs), 1.0), "rel_tol": ADJOINT_REL}
        if not abs(lhs - rhs) <= ADJOINT_REL * max(abs(lhs), 1.0):
            raise AssertionError(f"adjoint identity fails at S={s}: {row['adjoint']}")

        # times in the main path's type
        qq, kk, vv, gg = (x.to(torch.bfloat16).contiguous() for x in (q, k, v, g))
        out, lse = ta.tree_attention_fwd(qq, kk, vv, template, ids, lut, scale, True, TRAIN_RATE, dseed, True)
        _, _, delta = ta.tree_attention_bwd_dq(qq, kk, vv, out, gg, template, ids, lut, lse, scale, True, TRAIN_RATE, dseed)
        dense = ta.assemble_bias(template, ids, lut, True).to(torch.bfloat16)
        lib_leaves = [x.detach().clone().requires_grad_(True) for x in (qq, kk, vv, dense)]

        def plain_bwd():
            leaves = [x.detach().requires_grad_(True) for x in (qq, kk, vv, lut)]
            o = ta.tree_attention_dropout_reference(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], dseed, TRAIN_RATE, scale)
            o.backward(gg)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(*lib_leaves[:3], attn_mask=lib_leaves[3], scale=scale)
            o.backward(gg)

        calls = {
            "fwd": lambda: ta.tree_attention_fwd(qq, kk, vv, template, ids, lut, scale, True, TRAIN_RATE, dseed, True),
            "dq": lambda: ta.tree_attention_bwd_dq(qq, kk, vv, out, gg, template, ids, lut, lse, scale, True, TRAIN_RATE, dseed),
            "dkv": lambda: ta.tree_attention_bwd_dkv(qq, kk, vv, gg, template, ids, lut, lse, delta, scale, True, TRAIN_RATE, dseed),
            "plain_fwd": lambda: ta.tree_attention_dropout_reference(qq, kk, vv, template, ids, lut, dseed, TRAIN_RATE, scale),
            "plain_fwd_bwd": plain_bwd,
            "library_fwd": lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=dense, dropout_p=TRAIN_RATE, scale=scale),
            "library_fwd_bwd": sdpa_fwd_bwd,
        }
        row["ms"] = {}
        for name, fn in calls.items():
            dev = device_ms(fn)
            row["ms"][name] = dev if dev is not None else time_cuda(fn, 100)
        row["ms"]["plain_bwd"] = row["ms"]["plain_fwd_bwd"] - row["ms"]["plain_fwd"]
        row["bound"] = train_bounds(b, h, s, dh, "bfloat16")
        emit({"phase": "kernel_vs_plain_train", **row})
        rows.append(row)

    # the kernel's mask read back (q = k = 0, no bias, v = the identity:
    # out = keep / (S (1 - rate))) against the plain Philox, at S = 33
    s, b = 33, 12
    zeros = torch.zeros(b, h, s, dh, device="cuda")
    eye = torch.eye(s, dh, device="cuda").expand(b, h, s, dh).contiguous()
    out = ta.tree_attention(
        zeros, zeros, eye, torch.zeros(b, s, s, device="cuda"), torch.zeros(b, s, s, dtype=torch.int32, device="cuda"),
        torch.zeros(ta.LUT_SIZE, h, device="cuda"), rate=TRAIN_RATE, seed=seed + 99,
    )
    mask = (out[..., :s] * s * (1 - TRAIN_RATE)).round() > 0.5
    same = bool(torch.equal(mask, ta.dropout_keep_mask(seed + 99, b, h, s, TRAIN_RATE, "cuda")))
    kept = mask.float().mean().item()
    emit({"phase": "dropout_mask", "S": s, "B": b, "H": h, "rate": TRAIN_RATE, "kept_fraction": kept,
          "equals_plain_philox": same})
    if not same or abs(kept - (1 - TRAIN_RATE)) > 0.02:
        raise AssertionError(f"kernel mask: equals plain {same}, kept fraction {kept}")
    return rows


def graph_layers(mc):
    """(graph layers a forward runs, graph layers whose backward a node
    loss reaches). The final graph stack feeds only the global embedding,
    which the node loss does not read, so autograd never runs its backward
    (nor that of the stack the reference skips, where it is run)."""
    fwd = mc.num_graph_stack * (mc.num_fusion_stacks + (0 if mc.reproduce_dead_graph_stack else 1))
    return fwd, mc.num_graph_stack * (mc.num_fusion_stacks - 1)


def _counts():
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    return [fn.launches for fn in ta.KERNELS]


def phase_train(seed: int):
    """The canonical run through the port's entry points: launch's flag
    resolution, NodePredictionTask.build_trainer, Trainer.fit."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodaldiscussiontransformer_tpu_torch.data.loader import stack_microbatches
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
    from multimodaldiscussiontransformer_tpu_torch.tasks.node_prediction import NodePredictionTask
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args
    from multimodaldiscussiontransformer_tpu_torch.utils.flops import train_step_flops

    tmp = tempfile.TemporaryDirectory()
    args = build_parser().parse_args([
        "--synthetic", "--freeze-initial-encoders", "--no-save", "--batch-size", "12", "--update-freq", "3",
        "--positive-weight", "1.5", "--seed", str(seed + 1), "--validate-interval-updates", "0",
        "--log-interval", "1", "--save-dir", tmp.name,
    ])
    cfg = config_from_args(args)
    task = NodePredictionTask(cfg)
    t0 = time.perf_counter()
    ds = task.load_dataset(
        num_graphs=TRAIN_GRAPHS, seed=seed + 1, min_nodes=8, max_nodes=32, image_prob=0.25, seq_len=100,
        vocab_size=cfg.model.text_tower.vocab_size, image_shape=IMAGE_SHAPE,
    )
    data_s = time.perf_counter() - t0
    trainer = task.build_trainer(image_shape=IMAGE_SHAPE, device="cuda")
    t0 = time.perf_counter()
    state = trainer.init_state()
    init_s = time.perf_counter() - t0
    mc = cfg.model
    per_forward, per_backward = graph_layers(mc)
    if per_forward != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"the config runs {per_forward} graph layers, expected {LAUNCHES_PER_FORWARD}")
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}

    records = []
    inner = trainer.train_step

    def timed(state_, group, **kw):
        torch.cuda.synchronize()
        c0, start = _counts(), time.perf_counter()
        logs = inner(state_, group, **kw)
        torch.cuda.synchronize()
        end = time.perf_counter()
        flops = sum(
            train_step_flops(mc, batch=group["idx"].shape[1], node_capacity=group["input_ids"].shape[1],
                             image_capacity=group["images"].shape[1], seq_len=group["input_ids"].shape[2],
                             max_nodes=group["in_degree"].shape[2])["train_total"]
            for _ in range(group["idx"].shape[0])
        )
        records.append({
            "start": start, "end": end, "launches": [a - b for a, b in zip(_counts(), c0)],
            "loss": float(logs["loss"]) / max(float(logs["sample_size"]), 1.0), "gnorm": float(logs["gnorm"]),
            "graphs": int((group["idx"] >= 0).sum()), "flops": flops,
            "shapes": {"S": int(group["in_degree"].shape[2]) + 1, "C": int(group["input_ids"].shape[1]),
                       "T": int(group["input_ids"].shape[2]), "I": int(group["images"].shape[1]),
                       "L": int(group["y"].shape[1])},
        })
        return logs

    trainer.train_step = timed
    quiet = lambda msg: None  # noqa: E731
    state = trainer.fit(ds, state=state, max_updates=1, log_fn=quiet)  # untimed: warm-up
    warm = records.pop()
    for fn in ta.KERNELS:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.fit(ds, state=state, max_updates=1 + TIMED_UPDATES, log_fn=quiet)
    fit_s = time.perf_counter() - t0
    launches = _counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    trainer.train_step = inner

    if len(records) != TIMED_UPDATES:
        raise AssertionError(f"{len(records)} timed updates, expected {TIMED_UPDATES}")
    k = cfg.optim.update_freq
    want = [k * per_forward, k * per_backward, k * per_backward]  # 30, 24, 24
    bad = [r["launches"] for r in records if r["launches"] != want]
    if bad or launches != [w * TIMED_UPDATES for w in want]:
        raise AssertionError(f"kernel launches per update {bad or launches}, expected {want} each")
    losses = [r["loss"] for r in records]
    if not all(np.isfinite(losses)) or len(set(losses)) < 2:
        raise AssertionError(f"loss series not finite or constant: {losses}")

    frozen_prefixes = ("graph_encoder.text_model.", "graph_encoder.vit_model.")
    after = state.model.state_dict()
    frozen_moved = [k for k in before if k.startswith(frozen_prefixes) and not torch.equal(before[k], after[k])]
    # a tensor whose gradient is 0 (the last graph stack feeds only the
    # global embedding, which no node loss reads) moves only by weight
    # decay, which the warmup lr (~1e-8) leaves below float32 resolution
    grads = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
    trainable = [k for k in before if not k.startswith(frozen_prefixes)]
    zero_grad = [k for k in trainable if not grads[k].any()]
    trainable_still = [k for k in trainable if k not in zero_grad and torch.equal(before[k], after[k])]
    if frozen_moved or trainable_still:
        raise AssertionError(f"frozen tensors changed: {frozen_moved[:5]}; trainable tensors unchanged: {trainable_still[:5]}")

    step_ms = [(r["end"] - r["start"]) * 1e3 for r in records]
    gaps_ms = [(b["start"] - a["end"]) * 1e3 for a, b in zip(records, records[1:])]
    mfu = [r["flops"] / (r["end"] - r["start"]) / H100_BF16_PEAK for r in records]
    graphs = sum(r["graphs"] for r in records)

    # where an update's device time goes: one more update under the profiler
    group = next(iter(stack_microbatches(trainer.train_batches(ds, 2), 3, pad_tail=True)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.train_step(state, group)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3
    events = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3

    def cat_ms(*keys):
        return sum(e.self_device_time_total for e in events if any(k in e.key for k in keys)) / 1e3

    emit({
        "phase": "train", "config": "ModelConfig() canonical (launch flags: --freeze-initial-encoders, batch 12 x "
                                    "update_freq 3, dropout 0.4/0.3/0.3), bfloat16 compute, float32 params",
        "data_seconds": data_s, "init_seconds": init_s, "warmup_update_ms": (warm["end"] - warm["start"]) * 1e3,
        "timed_updates": TIMED_UPDATES, "update_ms_median": float(np.median(step_ms)), "update_ms": step_ms,
        "host_batch_ms_median": float(np.median(gaps_ms)) if gaps_ms else None,
        "fit_seconds": fit_s, "discussions_per_sec": graphs / fit_s,
        "discussions_per_sec_device_loop": graphs / (sum(step_ms) / 1e3),
        "mfu_median": float(np.median(mfu)), "peak_flops_assumed": H100_BF16_PEAK,
        "flops_per_update": [r["flops"] for r in records],
        "loss": losses, "gnorm": [r["gnorm"] for r in records], "shapes": [r["shapes"] for r in records],
        "launches_per_update": dict(zip(("tree_attention_fwd", "tree_attention_bwd_dq", "tree_attention_bwd_dkv"), want)),
        "max_memory_allocated_gb": peak_bytes / 2**30,
        "frozen_tensors_unchanged": sum(k.startswith(frozen_prefixes) for k in before),
        "trainable_tensors_changed": len(trainable) - len(zero_grad),
        "trainable_tensors_with_zero_grad": sorted({k.rsplit(".layer_", 1)[0] for k in zero_grad}),
    })
    top = [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count} for e in events[:15]]
    emit({
        "phase": "train_trace", "wall_ms": prof_wall_ms, "device_ms": dev_ms, "device_busy_share": dev_ms / prof_wall_ms,
        "tree_attention_ms": cat_ms("tree_attention"),
        "gemm_ms": cat_ms("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas"),
        "adamw_ms": cat_ms("multi_tensor_apply", "adam"),
        "dropout_rng_ms": cat_ms("distribution_elementwise"),
        "cast_and_layout_copy_ms": cat_ms("copy_kernel"),
        "host_to_device_ms": cat_ms("Memcpy HtoD"),
        "device_ops": sum(e.count for e in events), "top_kernels": top,
    })
    del state, trainer, before, after
    tmp.cleanup()
    return launches


def phase_train_cpu_agreement(seed: int):
    """One scan update of the tiny config with every dropout at 0, in
    float32, on the card and on the CPU from the same weights and batches."""
    import dataclasses

    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core.config import (
        DataConfig, OptimConfig, TaskConfig, TrainConfig, tiny_model_config,
    )
    from multimodaldiscussiontransformer_tpu_torch.data.loader import stack_microbatches
    from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_dataset
    from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

    m = tiny_model_config(dropout=0.0, attention_dropout=0.0, act_dropout=0.0)
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    m = m.replace(text_tower=dataclasses.replace(m.text_tower, **no_drop),
                  image_tower=dataclasses.replace(m.image_tower, **no_drop))
    cfg = TrainConfig(
        model=m, seed=seed,
        data=DataConfig(batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(64,),
                        image_capacity_buckets=(16,), label_capacity_buckets=(32,)),
        optim=OptimConfig(lr=1e-3, warmup_updates=2, total_num_update=20, update_freq=3),
        task_cfg=TaskConfig(dataset_name="synthetic", seed=seed),
    )
    img = (3, 32, 32)
    ds = synthetic_dataset(num_graphs=40, seed=seed, seq_len=16, vocab_size=128, image_shape=img, max_nodes=8)
    out = {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(cfg, image_shape=img, device=dev)
        state = trainer.init_state()
        group = next(iter(stack_microbatches(trainer.train_batches(ds, 1), 3)))
        c0 = _counts()
        logs = trainer.train_step(state, group, return_grads=True)
        out[dev] = {
            "grads": {k: v.cpu() for k, v in logs["grads"].items()},
            "params": {k: v.detach().cpu() for k, v in state.model.named_parameters()},
            "launches": [a - b for a, b in zip(_counts(), c0)],
            "loss": float(logs["loss"]),
        }
        lr0 = trainer.lr_schedule()(0)
    fwd, bwd = graph_layers(m)
    if out["cuda"]["launches"] != [3 * fwd, 3 * bwd, 3 * bwd]:
        raise AssertionError(f"card update launched {out['cuda']['launches']}")
    grad_err, param_err, small_err, bad = 0.0, 0.0, 0.0, []
    for k, gc in out["cpu"]["grads"].items():
        gg = out["cuda"]["grads"][k]
        e = (gg - gc).abs()
        grad_err = max(grad_err, e.max().item())
        if not (e <= AGREE_GRAD_ATOL + AGREE_GRAD_RTOL * gc.abs()).all():
            bad.append(("grad", k, e.max().item()))
        pc, pg = out["cpu"]["params"][k], out["cuda"]["params"][k]
        big = gc.abs() > 1e-4
        pe = (pg - pc).abs()
        if big.any():
            param_err = max(param_err, pe[big].max().item())
            if not (pe[big] <= AGREE_PARAM_ATOL + AGREE_PARAM_RTOL * pc[big].abs()).all():
                bad.append(("param", k, pe[big].max().item()))
        if (~big).any():
            small_err = max(small_err, pe[~big].max().item())
            if not (pe[~big] <= 2.05 * lr0 + 1e-7).all():
                bad.append(("param_small_grad", k, pe[~big].max().item()))
    emit({"phase": "train_cpu_agreement", "config": "tiny, every dropout 0, float32, one scan update of 3 x 4",
          "tensors": len(out["cpu"]["grads"]), "max_abs_err_grad": grad_err, "max_abs_err_param": param_err,
          "max_abs_err_param_small_grad": small_err, "loss_cuda": out["cuda"]["loss"], "loss_cpu": out["cpu"]["loss"],
          "card_launches": out["cuda"]["launches"],
          "tolerance": {"grad_rtol": AGREE_GRAD_RTOL, "grad_atol": AGREE_GRAD_ATOL, "param_rtol": AGREE_PARAM_RTOL,
                        "param_atol": AGREE_PARAM_ATOL, "param_small_grad_atol": 2.05 * lr0}})
    if bad:
        raise AssertionError(f"card and CPU updates disagree: {bad[:5]}")


def phase_launch():
    """``train.launch.main`` on the card: the canonical model, 2 updates."""
    import contextlib
    import io
    import tempfile

    from multimodaldiscussiontransformer_tpu_torch.train import launch

    with tempfile.TemporaryDirectory() as d:
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = launch.main(["--synthetic", "--max-updates", "2", "--no-save", "--save-dir", d, "--log-interval", "1"])
        seconds = time.perf_counter() - t
        records = [json.loads(ln) for ln in open(os.path.join(d, "metrics.jsonl"))]
    splits = [r["split"] for r in records]
    emit({"phase": "launch", "rc": rc, "seconds": seconds, "metrics_splits": splits,
          "last_train": records[[i for i, sp in enumerate(splits) if sp == "train"][-1]] if "train" in splits else None})
    if rc != 0 or splits.count("train") != 2:
        raise AssertionError(f"launch.main returned {rc} with metrics {splits}")


def _kernel_entry(name, source, replaces, also, launches, row, dtype_err, ms_key, plain_ms, library_ms, bound_key):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "also_replaces": also,
        "launches": launches, "max_abs_err": dtype_err, "ms": row["ms"][ms_key], "plain_ms": plain_ms,
        "bound_ms": row["bound"][bound_key][0], "bound_by": row["bound"][bound_key][1], "library_ms": library_ms,
    }


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
    train_rows = phase_kernel_train(args.seed)
    scorer, scoring_launches, rng = phase_scoring(args.seed)
    phase_latency(scorer, rng)
    del scorer
    torch.cuda.empty_cache()
    train_launches = phase_train(args.seed)
    torch.cuda.empty_cache()
    phase_train_cpu_agreement(args.seed)
    phase_launch()

    serve_row = rows[0]  # S=33, B=16: the canonical serving shape
    train_row = train_rows[0]  # S=33, B=12: the canonical training shape
    bf16 = train_row["errors"]["bfloat16"]
    ms = train_row["ms"]
    print(card, flush=True)
    emit({"kernels": [
        {**_kernel_entry(
            "tree_attention_fwd", KERNEL_SOURCE, f"{TPU_KERNELS}:1096",
            [f"{TPU_KERNELS}:973", f"{TPU_KERNELS}:103", f"{TPU_KERNELS}:66", f"{TPU_KERNELS}:228"],
            train_launches[0], train_row, bf16["out"]["max_abs_err"], "fwd", ms["plain_fwd"], ms["library_fwd"], "fwd"),
         "launches_by_path": {"train": train_launches[0], "scoring": scoring_launches},
         "serving_rate0": {k: serve_row[k] for k in ("S", "B", "ms", "plain_ms", "library_ms", "bound_ms",
                                                      "max_abs_err_bfloat16")},
         "shapes": train_rows},
        {**_kernel_entry(
            "tree_attention_bwd_dq", BWD_SOURCE, f"{TPU_KERNELS}:1148", [f"{TPU_KERNELS}:1007"],
            train_launches[1], train_row, max(bf16["dq"]["max_abs_err"], bf16["dlut"]["max_abs_err"]), "dq",
            ms["plain_bwd"], ms["library_fwd_bwd"], "dq"),
         "note": "plain_ms is the plain version's whole autograd backward (dq, dk, dv, dlut); "
                 "library_ms is SDPA forward + backward at rate 0 on the dense bias"},
        {**_kernel_entry(
            "tree_attention_bwd_dkv", BWD_SOURCE, f"{TPU_KERNELS}:1148", [f"{TPU_KERNELS}:1007"],
            train_launches[2], train_row, max(bf16["dk"]["max_abs_err"], bf16["dv"]["max_abs_err"]), "dkv",
            ms["plain_bwd"], ms["library_fwd_bwd"], "dkv"),
         "note": "plain_ms and library_ms as for tree_attention_bwd_dq"},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
