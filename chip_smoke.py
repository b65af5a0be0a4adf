#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --only kernels   # the build and phases 2-5 alone

Phases, each printing one JSON line; any failure exits non-zero:

1. build: compile every kernel library from ``csrc/`` with nvcc (sm_90a;
   one nvcc per source, all fifteen in parallel: the tree-attention
   forwards (CUDA-core K1, tensor-core bf16 and 3xTF32 float32) and
   backward pairs (CUDA-core K2/K3, tensor-core bf16 and 3xTF32 float32),
   the masked (tower) attention's three forwards (CUDA-core, tensor-core
   bf16 and 3xTF32 float32), its CUDA-core and 3xTF32 float32 backward
   pairs and its one-pass tensor-core backward, the dense-bias attention's
   three forwards (CUDA-core, tensor-core bf16 and 3xTF32 float32)),
   report each library's registers
   and any ptxas spill, and print the card's name and power limit as
   nvidia-smi reports them.
2. kernel_vs_plain: the tree-attention forwards at rate 0 against their
   plain PyTorch version on the card, at H=12, dh=64, double_add, with
   templates/ids collated from synthetic trees: S=33 (B=16), S=129 and
   S=257 (B=2), S=601 (B=1): float32 (TF32 off) through the route (the
   3xTF32 forward), bfloat16 through the route (the tensor-core
   forward, within 1e-2 of max |ref|) and through the CUDA-core forward's
   own wrapper (within one bf16 step elementwise). Each shape also gets
   times for both forwards on the same bf16 inputs, the plain version and
   one library call on the assembled dense bias
   (``F.scaled_dot_product_attention``, a yardstick the port never calls),
   beside the least time the card could take; and the float32 route's
   time (the 3xTF32 forward) on float32 inputs beside K1 and SDPA on the
   same inputs, the float32 bound and the 3xTF32 one.
3. kernel_vs_plain_train: the tree-attention forward with dropout and the
   LSE output and the backward pair against the plain version's forward
   and autograd gradients at S=33 (B=12), 129 (B=4), 257 (B=2) and the
   streaming sizes S=601 and 1025 (B=1), at rate 0.3 and 0, in float32
   (the "tf32" route: the 3xTF32 forward and pair; K1's output and LSE
   and K2/K3's float32 gradients beside them) and bfloat16 (the
   "tensor_core" route: the tensor-core
   forward and pair; K1's bf16 output and K2/K3's bf16 gradients beside
   them); the adjoint identity in v on both routes; times of each kernel
   (both forwards and the bf16 pairs on the same bf16 inputs), the plain
   version and SDPA (on the permuted bias and on a contiguous copy); the
   3xTF32 forward and pair, K1 and K2/K3 again on float32 inputs beside
   SDPA in float32, the float32 bound and the 3xTF32 one. Then
   dropout_mask: the 3xTF32 forward's mask read back in float32 at S=33
   and S=601 (ten tiles), the tensor-core forward's and both kernels of
   the tensor-core pair's in bf16 and both kernels of the 3xTF32 pair's
   in float32 at S=601 equal the plain Philox, and their kept fractions.
   Then kernel_vs_plain_train_dh16 at the workflows' width (S=33, B=12,
   H=4, DH 16): the float32 route against the plain version, K2/K3 and
   K1's LSE, the bf16 route (K1, K2/K3) against the plain version, and
   the float32 times.
4. masked_vs_plain: the tower (masked) attention forward and backward
   kernels against their plain version at the tower shapes (text bottom
   B=256 S=100, text fusion B=256 S=104, ViT fusion B=64 S=201 without a
   key bias), at ragged S = 1 .. 256 (B=8) and at S=300 (B=8), with
   capacity-padding rows (every key masked) in the key bias, rate 0.3 and
   0, float32 (the "tf32" route: the 3xTF32 forward and backward pair)
   and bfloat16 (the "tensor_core" route: the tensor-core forward and the
   one-pass backward; at S=300 the "cuda_core" route), each call's
   launches held to its route, plus the CUDA-core kernels' bf16 errors at
   the tower shapes and float32 errors at every shape (called directly),
   the 3xTF32 forward's statistics against the plain ones and the
   CUDA-core forward's float32 output against the plain version at every
   shape; the masks read back (q = k = 0, v = I) against the plain
   Philox: the 3xTF32 forward's in float32 (S=104, 201, 300), the
   tensor-core forward's in bf16 at dh=64, the one-pass backward's
   (through dv) and both kernels of the 3xTF32 pair's in float32 (through
   dv and dq, S=104 and 201); the adjoint
   identity; times of each kernel (the tensor-core forward beside the
   CUDA-core one, the one-pass backward beside the pair), the plain
   version, the towers' unfused path (matmul + f32 softmax + FastDropout +
   matmul) and SDPA with the key-padding mask (forward at dropout 0.3;
   forward + backward at rate 0 and 0.3), at a ragged S only the
   tensor-core forward and one-pass backward; at the tower shapes the
   3xTF32 forward and pair, the CUDA-core forward and pair and the plain
   forward and backward again on float32 inputs beside SDPA in float32
   (forward at rate 0.3, forward + backward at rate 0 and 0.3), the
   float32 bounds and the 3xTF32 ones.
5. biased_vs_plain: the dense-bias attention's routed forward kernel and
   the Function's gradients (dq, dk, dv, dbias) against the plain version
   at H=12, dh=64: S=33 (B=16, 12), 129 (B=12), 257 (B=4), 601 and 1025
   (B=1), with biases from the port's ``GraphAttnBias.forward`` on
   collated trees (-inf entries), per-head, head-shared and none, with the
   key-padding mask: float32 through the 3xTF32 forward (within 1e-4),
   bfloat16 through the tensor-core forward (within 1e-2 of max |ref|,
   also with the per-head bias in float32), and the CUDA-core forward's
   own wrapper on the same inputs (within 1e-4 in float32, one bf16 step
   elementwise in bf16); times of the bf16 kernels on the same bf16
   inputs, the plain version, the graph layer's unfused dense branch and
   SDPA on the combined bias, beside the least time the card could take;
   the 3xTF32 and the CUDA-core kernel and SDPA again on float32 inputs
   beside the float32 bound and the 3xTF32 one. Then
   biased_vs_plain_dh16: bf16 at DH 16 (S=33, B=12) through
   ``biased_attention``, every bias kind: the "cuda_core" route, the CUDA-
   core forward's one path, against the plain version.
6. scoring: the canonical ``ModelConfig()`` at full width with random
   weights from a seeded ``torch.Generator``, scored through
   ``BatchingScorer`` from 4 threads (discussions of ~20, ~100 and 600
   nodes, 100-token text, some nodes with a 3x224x224 image). Checks finite
   probabilities that sum to 1, exactly 10 launches of the tensor-core
   tree forward per forward (the CUDA-core forward at 0) and no backward
   launch, and agreement with the same model on the CPU (float32) on one
   small discussion.
7. scoring_fused: the same weights with both towers fused
   (``use_pallas_attention`` in the tower configs) score the same
   discussions through ``DiscussionScorer``: finite probabilities summing
   to 1, equal to the unfused scorer's (bfloat16 tolerance), exact
   masked-attention launches per forward (every tower layer through the
   tensor-core forward, the CUDA-core forward at 0), no backward launch;
   in float32 on one small discussion equal to the unfused CPU scores
   within 1e-4.
8. latency: per-request-batch scoring latency at batch 1, 4 and 16, and
   the device time of a batch-4 forward (``torch.profiler``) against its
   wall time, beside the host's time to collate that batch and copy it to
   the card.
9. train, train_fused, train_big: training runs through the launcher's
   flag resolution, ``NodePredictionTask(cfg).build_trainer()`` and
   ``Trainer.fit`` at full width:
   - train: the canonical run (batch 12 x update_freq 3, dropout
     0.4/0.3/0.3, frozen towers) on synthetic discussions of 8-32 nodes
     with 100-token text and 3x224x224 images on 25% of nodes: 1 untimed
     and 4 timed updates, then 2 profiled updates (train_trace) through
     ``Trainer.fit``'s profile window, after one more;
   - train_fused: the same run with both towers fused, on the same
     batches: 1 untimed and 4 timed updates, so that each update's peak
     memory compares with train's;
   - train_big: big discussions, both towers fused, ``--batch-size 1`` x
     update_freq 3 on discussions of 520-1000 nodes (padded S 521-1001,
     text capacity 1024) with images on 5% of nodes: 1 untimed and 3 timed
     updates, then 2 profiled updates (train_big_trace), as train's.
   Each checks a finite, changing loss, the exact launches of every kernel
   in every update (tree attention: 10 graph layers forward through the
   tensor-core forward and 8 backward through the tensor-core pair per
   microbatch, the CUDA-core kernels at 0, the last graph stack feeding
   only the global embedding;
   masked attention: every tower layer forward through the tensor-core
   forward and the 9 trainable fusion layers of each tower backward
   through the one-pass kernel in bf16 (the CUDA-core forward and the pair
   at 0), the ViT only where the microbatch has image slots), frozen
   towers unchanged and every tensor with a nonzero
   gradient changed; prints ms per update, discussions/s, MFU against 989
   TFLOP/s, each update's peak memory (statistics reset before every
   update), the S values seen, the ms the training thread waited for each
   update's input (the prefetch thread stages it) and the bytes sent to the
   card per update; the profiled updates add, per update, device time by
   kernel group (the tree and the tower attention's forward and backward
   apart) and the busy share of the window.
10. train_cpu_agreement, train_cpu_agreement_fused: one scan update of the
   tiny config with every dropout at 0 in float32, on the card and on the
   CPU, without and with fused towers: gradients and updated parameters
   agree (float32 runs the 3xTF32 tree forward and pair, and the fused
   towers' 3xTF32 forward and pair).
11. dense_graph: the dense-bias slice at ``ModelConfig()`` width
    (GraphNodeFeature -> dense GraphAttnBias -> 5 graph stacks of 2
    layers, ``use_pallas_attention``, bf16 compute): scoring forwards at
    S=33 B=16 and one 900-node discussion with exactly 10 launches each of
    the tensor-core dense-bias forward and no other kernel, finite, near the unfused branch in
    bf16 and equal to the CPU in float32; AdamW training steps (attention
    dropout 0, dropout 0.4 / 0.3) at S=33 B=12 and the 900-node discussion
    with ms per step, peak memory and gradients reaching the bias tables
    through dbias; one tiny float32 step, card (the 3xTF32 dense-bias
    forward) against CPU.
12. launch: ``train.launch.main`` with ``--synthetic --max-updates 2`` on
    the card returns 0.
13. checkpoint: the train phase's discussions written by the port's ingest
    writers as a ``hateful_discussions`` directory (192 train, 48 test; a
    few graphs as stubs naming a shared tree file). The canonical flags
    (bf16, frozen towers, batch 12 x update_freq 3) run 4 updates through
    ``train.launch.main`` in this process with saves at 2 and 4; beside
    it, the same command runs twice more, together, each in a process of
    its own that gets SIGTERM once its log shows update 1: one saving after every
    update (the signal lands while the asynchronous save of step 1 is
    still being written: its file is newer than the signal; it must stop
    at update 1 or 2), one with no interval save (it must stop at update 2,
    and the stop branch's own save must be its only step). Each must exit 0
    with "preempted: checkpoint saved at step <it>", and its relaunch (in
    this process) must auto-resume and run to 4.
    At step 4 each resumed run's generator states are byte-equal to the
    uninterrupted run's, its losses after the stop within 1e-2 relative
    and every parameter within 1e-2 of the largest change the 4 updates
    made; every update launches only the
    tensor-core tree kernels, as many as the config gives. The
    uninterrupted run's step 4, restored into a new state, saves and loads
    back byte-exact (bytes on disk against f32 params + two AdamW moments
    of the trainable elements); ``--eval-only --load-best`` and
    ``--eval-only --average-last 2 --predict-output`` run, with one row
    per real test node; ``DiscussionScorer.from_checkpoint`` and the
    ``serve.server`` CLI (another process, one POST) score a request batch
    bit-equal to the model that wrote the checkpoint, and so does a
    params-only checkpoint of the same weights in the scan layout. Prints
    the ms an asynchronous save stalls the caller and the ms until it is
    on disk, a synchronous save's ms and bytes beside it, restore and
    ``from_checkpoint`` ms, bytes per checkpoint and the resumed run's ms
    per update.

14. train_cpu_agreement_contrastive, _multisteps, _bf16_adam: as 10 (float32,
    tiny, the 3xTF32 tree kernels), for one scan update of the
    contrastive task (every graph layer's backward runs), one MultiSteps
    update (three ``train_microstep`` calls; the mean each ``.grad`` holds
    after the third) and one scan update with bf16 Adam moments.
15. contrastive: the reference's first training stage and the settings of
    the same slice at full width, through ``train.launch.main``:
    - contrastive pre-training (``--task contrastive_learning``, the
      canonical flags) on a ``hateful_discussions`` directory of 240
      contrastive discussions of 8-32 nodes (``hard_y`` written by the
      port's ingest writers): 4 updates, a save at 4, the test evaluation;
      exactly 30 / 30 / 30 launches of the tensor-core tree forward / dq /
      dk-dv per update (the loss reads the last graph stack's global
      embedding, so every graph layer's backward runs);
    - the transfer: the node task with ``--restore-file <that save dir>
      --reset-optimizer``, 2 updates and the test evaluation; before its
      first update every tensor on the card but ``node_classifier.weight``
      equals the checkpoint's (the bias is reset to 0, as it was);
    - ``--no-scan-microbatches``: 6 microbatches, 2 MultiSteps updates;
    - ``--bf16-adam-state``: 2 updates and a save, its bytes against the
      params plus two bf16 moments per trainable element;
    - ``param_dtype="bfloat16"`` through the Python API: 2 updates.
    Prints ms per update (median and last), discussions/s, peak memory
    and the losses of each run, the tree launches per update, and the
    AdamW step alone (device ms and span) on the same params with float32
    moments, bf16 moments and bf16 params.

16. input_ab: contrastive pre-training (a ``hateful_discussions``
    directory of contrastive discussions: lazy npz items) through
    ``Trainer.fit`` for 2 updates
    from one position on each input path, twice in mirrored order: the
    prefetch thread (the default) and the prefetcher's staging without its
    thread: ms per update, ms per cycle (update end to update end) and the
    training thread's ms on each update's input.
17. runtime_workers: the canonical run with ``--num-workers 4`` (collation
    in 4 spawned processes), 4 updates: ms per update, the groups' ``idx``
    equal to the in-process iterator's, the launches the config gives.
18. runtime_remat: ``train_big``'s discussions (both towers fused, batch 1
    x 3) without remat and under each ``--remat-policy``, 2 updates each
    from one state (weights, moments, generators): peak memory, ms per
    update, launches per update with the recompute counted (exactly as
    the config gives), the first update's loss within 1e-6 and the
    gradient norms within 5e-3 of no remat; then
    train_cpu_agreement_fused_remat_<policy>: as 10, fused, under each
    policy.
19. runtime_profile: ``--profile-trace`` through ``train.launch.main`` on
    the canonical synthetic run, updates 3-4 traced: one trace file, its
    size, exactly 2 x 78 tree-kernel events and the trainer's named ranges
    (2 x 3 ``microbatch``, 2 ``optimizer``).
20. ingest: raw discussion JSON to the card. A seeded
    ``pruned-with-images.json`` corpus in the reference's schema (60
    discussions of 8-32 comments and 2 of 520-600, URLs, "[deleted]"
    bodies, bot text, 224x224 uint8 images on a quarter of the comments,
    a few missing) and a WordPiece vocab built from it; ``data_prep.run
    splits`` and the ingest CLI (``--workers 4``) in processes of their
    own, once with the C++ host helper and once with
    ``MDT_TPU_NO_NATIVE=1``: equal npz arrays and index files, seconds per
    100 discussions of each; the helper against numpy on one 600-node tree
    (distances + spatial buckets) and on the scorer's host path
    (``Discussion.to_item`` + ``DiscussionScorer.collate``, batch 4 and 600
    nodes); 4 canonical updates from that ``--data-root`` through
    ``train.launch.main`` (30 / 24 / 24 tree launches per update, a finite
    changing loss), then ``--eval-only --predict-output`` with one row per
    test node.
21. weights_in: outside weights into ``ModelConfig()`` on the card. The
    seeded model exported as a reference (FairSeq) state dict with one
    layer's q/k/v fused into the legacy ``in_proj_weight``, imported into a
    model of no weights: scores of the scoring phase's first request batch
    bit-equal to the source's; HF-named BERT-base and ViT-base state dicts
    at their published shapes imported (every mapped tensor equal to its
    source, every other one kept) and scored; the same state dicts written
    as files in an HF cache (``write_hf_cache``: a gamma/beta
    ``model.safetensors`` BERT, a ``pytorch_model.bin`` ViT classifier)
    and read back by ``--hf-init``'s reader (read seconds and GB/s): the
    imported state and the scores bit-equal to the in-memory route's (which
    takes the classifier the reader drew), and ``--hf-init`` of a name in
    no cache exiting non-zero, naming it; the ingest run's checkpoint
    (update 4) written again in ``tools/orbax_to_npz.py``'s layout (params,
    AdamW moments, counters), restored with ``--restore-file X.npz`` into a
    run to update 6: moments equal to the checkpoint's, and its first
    update against the same update from the port's checkpoint with the
    same dropout bits (rtol 2e-4 + atol 1e-6);
    ``find_nonfinite`` over the trained state finds nothing.
22. parallel: training across ranks through ``train.launch.main``, one
    process per rank (``chip_smoke.py --parallel-rank R``), on the canonical
    setting at full width: the tree and tower kernels at H = 6 (a tp=2
    rank's heads) against their plain versions; the one-process run every
    parallel run is held against; NCCL at world size 1 (dp, fsdp, tp); then,
    with one card, 2 ranks on card 0 over gloo (dp=2, tp=2, ``--eval-only
    --predict-output``, tiny float32 node and contrastive updates, a SIGTERM
    to rank 1 alone), and with N >= 2 cards NCCL with one rank per card
    (dp, fsdp, tp=2 x dp, ``--num-slices 2 --fsdp``): ms per update,
    discussions/s, scaling against one card, peak memory per rank, the
    launches of every rank. ``--only parallel`` runs the build and this
    phase alone.
23. sequence_parallel: see ``phase_sequence_parallel``.
24. workflows: the last workflows of the port on one card
    (``phase_workflows``): ``two_stage.run`` (its TEST line, ms per update
    of each stage, the 3xTF32 tree kernels of its hidden-64 model),
    ``context_ablation.run`` at 300 trees, WF_ABLATION_UPDATES per arm
    (the full and the context-blind F1), ``readiness.main --full-model`` on stand-in assets with
    ``transformers`` unimportable (its HF checks ok on an HF cache of the
    published checkpoints' files), ``sample_run.sh`` through bash at
    ``ModelConfig()`` width on an ingested mini corpus (2 contrastive
    updates from towers read by ``--hf-init`` (``HF_INIT=1``) from that
    cache, then 2 node updates
    restored with ``--reset-optimizer``; the launcher argv the script
    builds for each runs in this process) and
    ``text_bert.train`` at BERT-base width (20 steps, one evaluation: ms per
    step, peak memory; then a 2-layer dropout-free run held against the
    same run on the CPU). ``--only workflows`` runs the build and this phase.
Every runtime line carries the card's name and power limit (``card``).
The phases whose default discussions match (runtime_workers and
checkpoint; input_ab and contrastive) read one directory, written once.

After the phases, ``seconds_by_phase`` (each phase's wall seconds, also
printed when a phase fails) and the card's name and power limit; the last
two lines are the kernels' summary (twenty kernels) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

# published H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
# "3xtf32": a float32 product as three dense TF32 products (495 TFLOP/s, the
# data sheet's 494.7): a third of the TF32 rate per float32 operation
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 494.7e12 / 3}
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
# fused vs unfused towers in bfloat16, per-node probabilities: the unfused
# path rounds the scores, the probabilities and the product to bf16 (8
# bits) in each of 24 tower layers and the fused kernels round only the
# output, so the two differ by bf16 noise carried through the model;
# 0.02 is a few bf16 steps of a probability near 1
FUSED_BF16_ATOL = 0.02

# the canonical model runs 5 graph stacks of 2 layers per forward
LAUNCHES_PER_FORWARD = 10
IMAGE_SHAPE = (3, 224, 224)

PKG = "multimodaldiscussiontransformer_tpu_torch"
KERNEL_SOURCE = f"{PKG}/csrc/tree_attention_fwd.cu"
KERNEL_MMA_SOURCE = f"{PKG}/csrc/tree_attention_fwd_mma.cu"
BWD_SOURCE = f"{PKG}/csrc/tree_attention_bwd.cu"
BWD_MMA_SOURCE = f"{PKG}/csrc/tree_attention_bwd_mma.cu"
BWD_TF32_SOURCE = f"{PKG}/csrc/tree_attention_bwd_tf32.cu"
KERNEL_TF32_SOURCE = f"{PKG}/csrc/tree_attention_fwd_tf32.cu"
MASKED_FWD_SOURCE = f"{PKG}/csrc/masked_attention_fwd.cu"
MASKED_FWD_MMA_SOURCE = f"{PKG}/csrc/masked_attention_fwd_mma.cu"
MASKED_FWD_TF32_SOURCE = f"{PKG}/csrc/masked_attention_fwd_tf32.cu"
MASKED_BWD_SOURCE = f"{PKG}/csrc/masked_attention_bwd.cu"
MASKED_BWD_MMA_SOURCE = f"{PKG}/csrc/masked_attention_bwd_mma.cu"
MASKED_BWD_TF32_SOURCE = f"{PKG}/csrc/masked_attention_bwd_tf32.cu"
BIASED_FWD_SOURCE = f"{PKG}/csrc/biased_attention_fwd.cu"
BIASED_FWD_MMA_SOURCE = f"{PKG}/csrc/biased_attention_fwd_mma.cu"
BIASED_FWD_TF32_SOURCE = f"{PKG}/csrc/biased_attention_fwd_tf32.cu"
TPU_KERNELS = "multimodaldiscussiontransformer_tpu/ops/tree_attention.py"
TPU_MASKED = "multimodaldiscussiontransformer_tpu/ops/masked_attention.py"
TPU_BIASED = "multimodaldiscussiontransformer_tpu/ops/biased_attention.py"


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


def timed_ms(fn, iters: int = 20) -> float:
    """Device ms per call where the profiler gives it, else CUDA-event ms."""
    dev = device_ms(fn, iters)
    return dev if dev is not None else time_cuda(fn, iters)


def bound(b: int, h: int, s: int, dh: int, dtype_name: str, bias_bytes: int):
    """(ms, "bytes"|"operations") of an attention forward: q, k, v, the
    output and ``bias_bytes`` (what the kernel reads of the bias: the tree
    template, ids and LUT; the dense bias and the pad mask), each read or
    written once, over the HBM rate; 4*B*H*S^2*dh operations over the peak
    rate of the input type."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * b * h * s * dh * item + bias_bytes
    flops = 4 * b * h * s * s * dh
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fused_towers(model_cfg):
    """``model_cfg`` with the fused tower attention on in both towers."""
    return model_cfg.replace(
        text_tower=dataclasses.replace(model_cfg.text_tower, use_pallas_attention=True),
        image_tower=dataclasses.replace(model_cfg.image_tower, use_pallas_attention=True),
    )


def _short_kernel_name(mangled: str) -> str:
    m = re.search(r"([a-z_]+_kernel)I(?:\d+)?(\w+?)Li(\d+)E", mangled)
    return f"{m.group(1)}<{m.group(2)},{m.group(3)}>" if m else mangled[:80]


def ptxas_report(libs):
    """Per library: the kernels ptxas compiled, the most registers one uses,
    and every kernel that spills (bytes of spill stores and loads)."""
    report = {}
    for lib in libs.values():
        fn, kernels, regs, spills = None, 0, 0, []
        for ln in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                fn, kernels = m.group(1), kernels + 1
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append({"kernel": _short_kernel_name(fn or ""), "stores": int(m.group(1)), "loads": int(m.group(2))})
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                regs = max(regs, int(m.group(1)))
        report[lib.name] = {"kernels": kernels, "max_registers": regs, "spills": spills}
    return report


def phase_build():
    from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    libs = cuda_lib.build()  # one nvcc per source, in parallel
    seconds = time.perf_counter() - t0
    cuda_lib.load_library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": round(seconds, 3), "libraries": [p.name for p in libs.values()],
          "ptxas": ptxas_report(libs)})
    print(card, flush=True)
    return card


def _all_kernels():
    from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
    from multimodaldiscussiontransformer_tpu_torch.ops.biased_attention import KERNELS as biased_kernels

    return ta.KERNELS + ma.KERNELS + biased_kernels


KERNEL_NAMES = (
    "tree_attention_fwd", "tree_attention_bwd_dq", "tree_attention_bwd_dkv", "tree_attention_fwd_fused",
    "tree_attention_bwd_dq_fused", "tree_attention_bwd_dkv_fused", "tree_attention_bwd_dq_tf32",
    "tree_attention_bwd_dkv_tf32", "tree_attention_fwd_tf32",
    "masked_attention_fwd", "masked_attention_bwd_dq", "masked_attention_bwd_dkv", "masked_attention_bwd_fused",
    "masked_attention_fwd_fused", "masked_attention_fwd_tf32", "masked_attention_bwd_dq_tf32",
    "masked_attention_bwd_dkv_tf32", "biased_attention_fwd", "biased_attention_fwd_fused", "biased_attention_fwd_tf32",
)


# the tree kernels of the bf16 route (DH 64), and those no bf16 path at DH
# 64 may launch: K1, K2/K3 and the 3xTF32 forward and pair
TREE_TENSOR_CORE = ("tree_attention_fwd_fused", "tree_attention_bwd_dq_fused", "tree_attention_bwd_dkv_fused")
TREE_NOT_BF16 = ("tree_attention_fwd", "tree_attention_bwd_dq", "tree_attention_bwd_dkv", "tree_attention_bwd_dq_tf32",
                 "tree_attention_bwd_dkv_tf32", "tree_attention_fwd_tf32")


def _counts():
    return [fn.launches for fn in _all_kernels()]


def _zero_counts() -> None:
    for fn in _all_kernels():
        fn.launches = 0


def graph_batch(s: int, b: int, seed: int):
    """A collated batch of ``b`` synthetic trees whose node bucket is s-1
    (the first tree fills it; beyond the node ladder the bucket is the
    largest tree)."""
    import numpy as np

    from multimodaldiscussiontransformer_tpu_torch.data.collator import collate
    from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_item

    rng = np.random.default_rng(seed)
    n = s - 1
    sizes = [n] + [int(rng.integers(n // 2 + 1, n + 1)) for _ in range(b - 1)]
    items = [
        synthetic_item(i, m, rng, seq_len=4, vocab_size=64, image_prob=0.0)
        for i, m in enumerate(sizes)
    ]
    batch = collate(items, image_capacity_buckets=(0,))
    assert batch.attn_bias.shape == (b, s, s), batch.attn_bias.shape
    return batch


def compact_inputs(s: int, b: int, h: int, seed: int):
    """Collated template/ids/lut for ``b`` synthetic trees whose node
    bucket is s-1."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    batch = graph_batch(s, b, seed)
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
            want = ta.tree_attention_reference(qq, kk, vv, template, ids, lut).float()
            c0 = _counts()
            got = ta.tree_attention(qq, kk, vv, template, ids, lut)  # the route's forward
            torch.cuda.synchronize()
            launched = dict(zip(KERNEL_NAMES, (y - x for x, y in zip(c0, _counts()))))
            forwards = ("tree_attention_fwd", "tree_attention_fwd_fused", "tree_attention_fwd_tf32")
            want_fwd = {"tensor_core": (0, 1, 0), "tf32": (0, 0, 1)}[ta.kernel_route(dt, dh)]
            if tuple(launched[n] for n in forwards) != want_fwd:
                raise AssertionError(f"{name} at S={s} took the wrong forward: {launched}")
            err = (got.float() - want).abs()
            if name == "float32":  # the 3xTF32 forward
                ok = bool((err <= F32_ATOL).all())
            else:  # the tensor-core forward, its bf16 P included
                ok = err.max().item() <= TRAIN_BF16_REL * want.abs().max().item()
            if not (ok and torch.isfinite(got).all()):
                raise AssertionError(f"kernel disagrees with plain version at S={s} B={b} {name}: max err {err.max().item()}")
            row[f"max_abs_err_{name}"] = err.max().item()
            if name == "bfloat16":
                # the CUDA-core forward in bf16 through its own wrapper: f32
                # arithmetic, so within one bf16 step elementwise
                got = ta.tree_attention_fwd(qq, kk, vv, template, ids, lut, dh ** -0.5)[0]
                torch.cuda.synchronize()
                err = (got.float() - want).abs()
                if not (bool((err <= BF16_ATOL + BF16_RTOL * want.abs()).all()) and torch.isfinite(got).all()):
                    raise AssertionError(f"CUDA-core forward disagrees at S={s} B={b} bf16: max err {err.max().item()}")
                row["max_abs_err_bfloat16_cuda_core"] = err.max().item()
        # times in the main path's type
        qq, kk, vv = (x.to(torch.bfloat16).contiguous() for x in (q, k, v))
        dense = ta.assemble_bias(template, ids, lut, True).to(torch.bfloat16)
        dense_c = dense.contiguous()
        calls = {
            "": lambda: ta.tree_attention(qq, kk, vv, template, ids, lut),  # the tensor-core forward
            "cuda_core_": lambda: ta.tree_attention_fwd(qq, kk, vv, template, ids, lut, dh ** -0.5),
            "plain_": lambda: ta.tree_attention_reference(qq, kk, vv, template, ids, lut),
            "library_": lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=dense, scale=dh ** -0.5),
            # assemble_bias returns the (B, H, S, S) bias in a (B, S, S, H)
            # memory layout; SDPA on a contiguous copy of it
            "library_contiguous_": lambda: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=dense_c, scale=dh ** -0.5),
        }
        for prefix, fn in calls.items():
            # per call as a caller sees it (host launch work included), and
            # the device time alone; "ms" is the device time where the
            # profiler gives one
            row[prefix + "call_ms"] = time_cuda(fn, 200 if s <= 257 else 50)
            row[prefix + "device_ms"] = device_ms(fn)
            row[prefix + "ms"] = row[prefix + "device_ms"] or row[prefix + "call_ms"]
        row["bound_ms"], row["bound_by"] = bound(b, h, s, dh, "bfloat16", 2 * b * s * s * 4 + 32 * h * 4)
        # the float32 route (the 3xTF32 forward) on float32 inputs, K1 (the
        # CUDA-core forward it replaces there) and SDPA on the same inputs
        # with a contiguous float32 bias, and the bounds: float32 on CUDA
        # cores, and 3xTF32
        dense32 = ta.assemble_bias(template, ids, lut, True).contiguous()
        row["float32"] = {
            "ms": timed_ms(lambda: ta.tree_attention_fwd_tf32(q, k, v, template, ids, lut, dh ** -0.5)),
            "cuda_core_ms": timed_ms(lambda: ta.tree_attention_fwd(q, k, v, template, ids, lut, dh ** -0.5)),
            "library_contiguous_ms": timed_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=dense32, scale=dh ** -0.5)),
        }
        shared = 2 * b * s * s * 4 + 32 * h * 4
        row["float32"]["bound_ms"], row["float32"]["bound_by"] = bound(b, h, s, dh, "float32", shared)
        row["float32"]["bound_3xtf32_ms"], row["float32"]["bound_3xtf32_by"] = bound(b, h, s, dh, "3xtf32", shared)
        row["tolerance"] = {"float32_atol": F32_ATOL, "bfloat16_rel_of_max": TRAIN_BF16_REL,
                            "bfloat16_cuda_core_rtol": BF16_RTOL, "bfloat16_cuda_core_atol": BF16_ATOL}
        emit({"phase": "kernel_vs_plain", **row})
        rows.append(row)
    return rows


TEXT_LEN = 100  # tokens of every synthetic comment: the text tower's length


def make_discussion(rng, n: int, image_prob: float, seq_len: int = TEXT_LEN, vocab: int = 30522):
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


def tower_forward_routes(mc, text_len: int, images: bool):
    """Masked-attention forward launches of one forward by kernel:
    (CUDA-core, tensor-core, 3xTF32). Each tower layer takes the kernel
    ``kernel_route`` names for the compute dtype, the tower's head dim and
    the layer's length (bottom layers: the tokens; fusion layers: the
    tokens and the bottleneck tokens); the ViT runs only where the batch
    has image slots."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.ops.masked_attention import kernel_route

    dtype = getattr(torch, mc.dtype)
    fusion = mc.num_fusion_layers + 1
    towers = [(mc.text_tower, text_len, mc.num_bottom_text_layers)]
    if images:
        towers.append((mc.image_tower, mc.image_tower.seq_len, mc.num_bottom_image_layers))
    n = {"cuda_core": 0, "tensor_core": 0, "tf32": 0}
    for tower, s, bottom in towers:
        n[kernel_route(dtype, tower.head_dim, s)] += bottom
        n[kernel_route(dtype, tower.head_dim, s + mc.num_bottleneck_tokens)] += fusion
    return n["cuda_core"], n["tensor_core"], n["tf32"]


def tower_launches(mc):
    """Masked-attention launches per microbatch or forward: (text forward,
    ViT forward, text backward, ViT backward). Every tower layer runs the
    fused forward (the ViT's only where the batch has image slots); the
    backward runs in the fusion layers, the bottom towers being frozen."""
    fusion = mc.num_fusion_layers + 1
    text_bwd = fusion + (0 if mc.freeze_initial_encoders else mc.num_bottom_text_layers)
    vit_bwd = fusion + (0 if mc.freeze_initial_encoders else mc.num_bottom_image_layers)
    return mc.num_bottom_text_layers + fusion, mc.num_bottom_image_layers + fusion, text_bwd, vit_bwd


def phase_scoring(seed: int):
    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
    from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
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

    _zero_counts()
    threads = [threading.Thread(target=worker, args=(name,)) for name in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    counts = dict(zip(KERNEL_NAMES, _counts()))
    launches = counts["tree_attention_fwd_fused"]  # bf16 at dh 64: the tensor-core forward
    if any(n for name, n in counts.items() if name != "tree_attention_fwd_fused"):
        raise AssertionError(f"the scoring path launched a backward, a tower or the CUDA-core tree kernel: {counts}")
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
    unfused = {"state": state, "requests": requests, "results": results, "small": small,
               "small_cpu_f32": probs["cpu"], "small_bf16": bf16}
    return scorer, counts, rng, unfused


def phase_scoring_fused(unfused):
    """Both towers fused, the scoring phase's weights and discussions, one
    forward per discussion through ``DiscussionScorer``."""
    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
    from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
    from multimodaldiscussiontransformer_tpu_torch.serve.incremental import DiscussionScorer

    cfg = fused_towers(ModelConfig())
    model = MDTModel(cfg)
    model.load_state_dict(unfused["state"])
    scorer = DiscussionScorer(model, device="cuda", image_shape=IMAGE_SHAPE)
    text_fwd, vit_fwd, _, _ = tower_launches(cfg)
    scorer.score(unfused["requests"]["small_images"][0])  # warm-up, outside the counted run
    torch.cuda.synchronize()

    _zero_counts()
    want_cuda_core, want_tensor_core, errs, forwards, seconds = 0, 0, {}, 0, []
    for name, ds in unfused["requests"].items():
        errs[name] = []
        for d, ref in zip(ds, unfused["results"][name]):
            t = time.perf_counter()
            p = scorer.score(d)
            seconds.append(time.perf_counter() - t)
            forwards += 1
            cuda_core, tensor_core, _ = tower_forward_routes(cfg, TEXT_LEN, len(d.images) > 0)
            want_cuda_core += cuda_core
            want_tensor_core += tensor_core
            if p.shape != ref.shape or not np.isfinite(p).all() or np.abs(p.sum(-1) - 1.0).max() > 1e-5:
                raise AssertionError(f"{name}: bad fused probabilities {p.shape}")
            errs[name].append(float(np.abs(p - ref).max()))
    counts = dict(zip(KERNEL_NAMES, _counts()))
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["tree_attention_fwd_fused"] = LAUNCHES_PER_FORWARD * forwards
    want["masked_attention_fwd"] = want_cuda_core
    want["masked_attention_fwd_fused"] = want_tensor_core
    worst = max(max(e) for e in errs.values())

    # float32: the fused model on the card (TF32 off) against the unfused
    # CPU scores of the scoring phase
    m32 = MDTModel(cfg.replace(dtype="float32"))
    m32.load_state_dict(unfused["state"])
    small = unfused["small"]
    p32 = DiscussionScorer(m32, device="cuda", image_shape=IMAGE_SHAPE).score(small)
    err32 = float(np.abs(p32 - unfused["small_cpu_f32"]).max())
    err_bf16_small = float(np.abs(scorer.score(small) - unfused["small_cpu_f32"]).max())
    emit({"phase": "scoring_fused", "config": "ModelConfig() with both towers fused, bfloat16 compute",
          "forwards": forwards, "launches": counts, "expected_launches": want,
          "masked_launches_per_forward": {"text": text_fwd, "vit_when_images": vit_fwd},
          "max_abs_err_vs_unfused_bf16": errs, "bf16_atol": FUSED_BF16_ATOL,
          "max_abs_err_f32_vs_unfused_cpu": err32, "f32_atol": MODEL_ATOL,
          "small_bf16_vs_cpu_f32": {"fused": err_bf16_small,
                                    "unfused": float(np.abs(unfused["small_bf16"] - unfused["small_cpu_f32"]).max())},
          "forward_seconds": seconds})
    if counts != want:
        raise AssertionError(f"fused scoring launches {counts}, expected {want}")
    if counts["masked_attention_fwd"] or not counts["masked_attention_fwd_fused"]:
        raise AssertionError(f"bf16 fused scoring must take the tensor-core forward only: {counts}")
    if not worst <= FUSED_BF16_ATOL:
        raise AssertionError(f"fused bf16 scores differ from the unfused ones by {worst}")
    if not err32 <= MODEL_ATOL:
        raise AssertionError(f"fused float32 scores differ from the unfused CPU ones by {err32}")
    del scorer, model, m32
    return counts


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
    tree_fwd_ms = sum(e.self_device_time_total for e in events if "tree_attention_fwd" in e.key) / reps / 1e3
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
          "tree_attention_ms": tree_ms, "tree_attention_fwd_ms": tree_fwd_ms,
          "tree_attention_bwd_ms": tree_ms - tree_fwd_ms, "device_ops_per_forward": sum(e.count for e in events) // reps,
          "host_collate_ms": float(np.median(collate_ms)), "host_to_device_ms": float(np.median(copy_ms)),
          "batch_bytes": sum(v.nbytes for v in batch.asdict().values()),
          "top_kernels": top})


# training kernels: the canonical node buckets 32, 128, 256 (S = 33, 129,
# 257) at the batch sizes whose tensors a 12-discussion microbatch gives,
# and the streaming sizes a big discussion gives (S = 601, 1025 at one
# discussion per microbatch)
TRAIN_SHAPES = ((33, 12), (129, 4), (257, 2), (601, 1), (1025, 1))
TRAIN_RATE = 0.3
# kernels vs plain version, relative to the largest |ref| of each output:
# float32 (TF32 off) differs by sum order and, for dlut, by the atomics'
# run-to-run order; bfloat16 by the kernels' bf16 rounding of out and g
# before g . out and of every output (a few steps of 2^-8)
TRAIN_F32_REL = 1e-4
TRAIN_BF16_REL = 1e-2
ADJOINT_REL = 1e-4
# the adjoint identity through the bf16 kernels, with g = f(v2) so that the
# left side is ||f(v2)||^2 > 0: each side rounds its output (out, dv) to
# bf16 (2^-9 of each element) and the forward rounds P where the backward
# rounds P / (1 - rate); those add up to ~1e-4 of the sum, while a wrong
# mask at rate 0.3 moves it by tens of percent
BF16_ADJOINT_REL = 1e-3
# train and train_fused: 1 untimed update, then this many timed ones on the
# same batches; train_big takes BIG_TIMED_UPDATES (train and train_fused
# took 5 before sequence_parallel; 4 keep the whole run near 1,050 s)
TIMED_UPDATES = 4
BIG_TIMED_UPDATES = 3
TRAIN_GRAPHS = 240  # 192 train graphs: 16 microbatches of 12, 6 updates an epoch
BIG_GRAPHS = 20  # 16 train graphs of 520-1000 nodes: 5 updates of 3 an epoch
# train_cpu_agreement: tiny config, float32, card (TF32 off) vs CPU:
# gradients within rtol 2e-4 + atol 1e-6 (sum order); parameters after
# AdamW within rtol 2e-4 + atol 2e-5 where |grad| > 1e-4, and within
# 2.05 lr elsewhere (Adam's first step is lr * g / (|g| + eps))
AGREE_GRAD_RTOL, AGREE_GRAD_ATOL = 2e-4, 1e-6
AGREE_PARAM_RTOL, AGREE_PARAM_ATOL = 2e-4, 2e-5
H100_BF16_PEAK = 989e12


def work_bounds(b: int, h: int, s: int, dh: int, dtype_name: str, shared_bytes: int, stat_planes: int = 1):
    """{kernel: (ms, "bytes"|"operations")} for an attention forward (with
    its softmax statistics), its two backward kernels and the one-pass
    backward: each input read once and each output written once over the
    HBM rate, against the operations of each kernel's function over the
    peak of its type (fwd 4, dq 6, dkv 8, one pass 10 x B*H*S^2*dh: scores,
    g.v, and the products each writes).
    ``shared_bytes`` is what every kernel reads besides q, k, v, g, out and
    the per-row vectors (the tree template, ids and LUT; the towers' key
    bias); ``stat_planes`` f32 values per row hold the statistics (the tree
    kernels' LSE: 1; the tower kernels' row max and log sum: 2)."""
    item = 2 if dtype_name == "bfloat16" else 4
    qkv = b * h * s * dh * item
    row = b * h * s * 4  # one f32 per row: delta, or one plane of the statistics
    stats = stat_planes * row
    work = {
        "fwd": (4 * qkv + shared_bytes + stats, 4),  # q k v in, out and stats out
        "dq": (6 * qkv + shared_bytes + stats + row, 6),  # q k v out g stats in, dq delta out
        "dkv": (6 * qkv + shared_bytes + stats + row, 8),  # q k v g stats delta in, dk dv out
        "bwd_fused": (8 * qkv + shared_bytes + stats, 10),  # q k v out g stats in, dq dk dv out
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


def _check_errors(got, want, names, tol, what, floor: float = 0.0):
    """{name: max abs error, max |ref|}; raise unless finite and within
    tol x max(max |ref|, floor)."""
    errs = _errors(got, want, names, tol, floor)
    if errs.pop("failed"):
        raise AssertionError(f"{what}: {errs} (rel tol {tol}, floor {floor})")
    return errs


def _errors(got, want, names, tol, floor: float = 0.0) -> dict:
    """{name: max abs error, max |ref|} and ``failed``: the outputs not
    finite or off by more than tol x max(max |ref|, floor) (None when all
    agree)."""
    import torch

    errs, bad = {}, []
    for name, a, w in zip(names, got, want):
        e = (a.float() - w.float()).abs().max().item()
        errs[name] = {"max_abs_err": e, "max_abs_ref": w.float().abs().max().item()}
        if not (torch.isfinite(a).all() and e <= tol * max(errs[name]["max_abs_ref"], floor)):
            bad.append(name)
    errs["failed"] = f"{bad} beyond {tol} of max |ref|" if bad else None
    return errs


# an LSE or a row-statistics plane against another's on the same inputs,
# elementwise: both are f32 sums of products taken in other orders
STAT_RTOL = 1e-4


def _check_stat(got, want, what: str) -> dict:
    """{max abs error, max |ref|}; raise unless finite and within STAT_RTOL
    x max(1, |ref|) elementwise."""
    import torch

    err = (got - want).abs()
    out = {"max_abs_err": err.max().item(), "max_abs_ref": want.abs().max().item(), "rtol": STAT_RTOL}
    if not (torch.isfinite(got).all() and bool((err <= STAT_RTOL * want.abs().clamp_min(1.0)).all())):
        raise AssertionError(f"{what}: {out}")
    return out


def phase_kernel_train(seed: int):
    """The routed kernels (float32: the 3xTF32 forward and pair; bf16: the
    tensor-core forward and backward pair) against the plain version's
    forward and autograd gradients at rate 0.3 and 0, K1's float32 output
    and LSE (the 3xTF32 forward's LSE held against it) and K2/K3's float32
    gradients, K1's bf16 output and K2/K3's bf16 gradients beside them; the
    adjoint identity in v on both routes; the forwards' and both
    tensor-core pairs' masks read back against the plain Philox; times;
    then the DH-16 shape (``kernel_train_dh16``). Returns (rows, the DH-16
    row)."""
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
        row = {"S": s, "B": b, "H": h, "dh": dh, "rate": TRAIN_RATE, "errors": {}, "errors_rate0": {}}
        for rate, key in ((TRAIN_RATE, "errors"), (0.0, "errors_rate0")):
            for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                qq, kk, vv, gg = (x.to(dt).contiguous() for x in (q, k, v, g))
                got = _fwd_and_grads(ta.tree_attention, qq, kk, vv, template, ids, lut, gg, rate=rate, seed=dseed)
                want = _fwd_and_grads(ta.tree_attention_dropout_reference, qq, kk, vv, template, ids, lut, gg, rate=rate, seed=dseed)
                torch.cuda.synchronize()
                tol = TRAIN_F32_REL if name == "float32" else TRAIN_BF16_REL
                row[key][name] = _check_errors(got, want, ("out", "dq", "dk", "dv", "dlut"), tol,
                                               f"training kernels disagree at S={s} rate {rate} {name}")
                if name == "float32":
                    # the route took the 3xTF32 forward and pair; K1 and
                    # K2/K3 on the same inputs (from K1's LSE), called
                    # directly, and the 3xTF32 forward's LSE against K1's
                    k23 = cuda_core_pair(ta, qq, kk, vv, template, ids, lut, gg, scale, rate, dseed,
                                         fwd=ta.tree_attention_fwd)
                    k1, lse_k1 = ta.tree_attention_fwd(qq, kk, vv, template, ids, lut, scale, True, rate, dseed, True)
                    _, lse_tf32 = ta.tree_attention_fwd_tf32(qq, kk, vv, template, ids, lut, scale, True, rate, dseed,
                                                             True)
                    torch.cuda.synchronize()
                    row[key]["float32_cuda_core_pair"] = _check_errors(
                        k23, want[1:], ("dq", "dk", "dv", "dlut"), tol, f"K2/K3 disagree at S={s} rate {rate} f32")
                    row[key]["float32_k1"] = _check_errors(
                        [k1], want[:1], ("out",), tol, f"K1 disagrees at S={s} rate {rate} f32")
                    row[key]["float32_lse_vs_k1"] = _check_stat(lse_tf32, lse_k1, f"3xTF32 LSE against K1's at S={s}")
                if name == "bfloat16":
                    # K1 on the same bf16 inputs, through its own wrapper
                    k1 = ta.tree_attention_fwd(qq, kk, vv, template, ids, lut, scale, True, rate, dseed)[0]
                    # and K2/K3 from the tensor-core forward's LSE
                    k23 = cuda_core_pair(ta, qq, kk, vv, template, ids, lut, gg, scale, rate, dseed)
                    torch.cuda.synchronize()
                    row[key]["bfloat16_cuda_core"] = _check_errors(
                        [k1], want[:1], ("out",), tol, f"the CUDA-core forward disagrees at S={s} rate {rate} bf16")
                    row[key]["bfloat16_cuda_core_pair"] = _check_errors(
                        k23, want[1:], ("dq", "dk", "dv", "dlut"), tol, f"K2/K3 disagree at S={s} rate {rate} bf16")
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
        # and in bf16 through the tensor-core forward and pair, g = f(v2)
        qq, kk, vv2 = (x.to(torch.bfloat16).contiguous() for x in (q, k, v2))
        fv2 = ta.tree_attention(qq, kk, vv2, template, ids, lut, rate=TRAIN_RATE, seed=dseed)
        vv = v.to(torch.bfloat16).requires_grad_(True)
        ta.tree_attention(qq, kk, vv, template, ids, lut, rate=TRAIN_RATE, seed=dseed).backward(fv2)
        lhs = (fv2.double() * fv2.double()).sum().item()
        rhs = (vv.grad.double() * vv2.double()).sum().item()
        row["adjoint_bfloat16"] = {"lhs": lhs, "rhs": rhs, "rel_err": abs(lhs - rhs) / abs(lhs),
                                   "rel_tol": BF16_ADJOINT_REL}
        if not abs(lhs - rhs) <= BF16_ADJOINT_REL * abs(lhs):
            raise AssertionError(f"bf16 adjoint identity fails at S={s}: {row['adjoint_bfloat16']}")

        # times in the main path's type
        qq, kk, vv, gg = (x.to(torch.bfloat16).contiguous() for x in (q, k, v, g))
        out, lse = ta.tree_attention_fwd_fused(qq, kk, vv, template, ids, lut, scale, True, TRAIN_RATE, dseed, True)
        _, _, delta = ta.tree_attention_bwd_dq_fused(qq, kk, vv, out, gg, template, ids, lut, lse, scale, True, TRAIN_RATE,
                                                     dseed)
        dense = ta.assemble_bias(template, ids, lut, True).to(torch.bfloat16)
        dense_c = dense.contiguous()  # assemble_bias's layout is (B, S, S, H)

        def plain_bwd_of(q_, k_, v_, g_):
            def run():
                leaves = [x.detach().requires_grad_(True) for x in (q_, k_, v_, lut)]
                o = ta.tree_attention_dropout_reference(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], dseed,
                                                        TRAIN_RATE, scale)
                o.backward(g_)
            return run

        def sdpa_fwd_bwd(bias, q_=qq, k_=kk, v_=vv, g_=gg):
            def run():
                leaves = [x.detach().requires_grad_(True) for x in (q_, k_, v_, bias)]
                F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=scale).backward(g_)
            return run

        calls = {
            "fwd": lambda: ta.tree_attention_fwd_fused(qq, kk, vv, template, ids, lut, scale, True, TRAIN_RATE, dseed, True),
            "fwd_cuda_core": lambda: ta.tree_attention_fwd(qq, kk, vv, template, ids, lut, scale, True, TRAIN_RATE, dseed,
                                                           True),
            "dq": lambda: ta.tree_attention_bwd_dq_fused(qq, kk, vv, out, gg, template, ids, lut, lse, scale, True, TRAIN_RATE,
                                                         dseed),
            "dkv": lambda: ta.tree_attention_bwd_dkv_fused(qq, kk, vv, gg, template, ids, lut, lse, delta, scale, True,
                                                           TRAIN_RATE, dseed),
            "dq_cuda_core": lambda: ta.tree_attention_bwd_dq(qq, kk, vv, out, gg, template, ids, lut, lse, scale, True,
                                                             TRAIN_RATE, dseed),
            "dkv_cuda_core": lambda: ta.tree_attention_bwd_dkv(qq, kk, vv, gg, template, ids, lut, lse, delta, scale, True,
                                                               TRAIN_RATE, dseed),
            "plain_fwd": lambda: ta.tree_attention_dropout_reference(qq, kk, vv, template, ids, lut, dseed, TRAIN_RATE, scale),
            "plain_fwd_bwd": plain_bwd_of(qq, kk, vv, gg),
            "library_fwd": lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=dense, dropout_p=TRAIN_RATE, scale=scale),
            "library_fwd_bwd": sdpa_fwd_bwd(dense),
            "library_contiguous_fwd": lambda: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=dense_c, dropout_p=TRAIN_RATE, scale=scale),
            "library_contiguous_fwd_bwd": sdpa_fwd_bwd(dense_c),
        }
        row["ms"] = {name: timed_ms(fn) for name, fn in calls.items()}
        row["ms"]["plain_bwd"] = row["ms"]["plain_fwd_bwd"] - row["ms"]["plain_fwd"]
        row["bound"] = work_bounds(b, h, s, dh, "bfloat16", 2 * b * s * s * 4 + 32 * h * 4)
        row["fwd_vs_cuda_core"] = row["ms"]["fwd_cuda_core"] / row["ms"]["fwd"]
        row["ms"]["pair"] = row["ms"]["dq"] + row["ms"]["dkv"]
        row["ms"]["pair_cuda_core"] = row["ms"]["dq_cuda_core"] + row["ms"]["dkv_cuda_core"]
        row["pair_vs_cuda_core"] = row["ms"]["pair_cuda_core"] / row["ms"]["pair"]
        row["pair_vs_library_contiguous_fwd_bwd"] = row["ms"]["pair"] / row["ms"]["library_contiguous_fwd_bwd"]
        row["fwd_vs_library_contiguous"] = row["ms"]["fwd"] / row["ms"]["library_contiguous_fwd"]
        # the float32 route (the 3xTF32 forward, then the 3xTF32 pair) on
        # float32 inputs, K1 and K2/K3 on the same inputs, SDPA on them with
        # a contiguous float32 bias, and the bounds: float32 on CUDA cores,
        # and 3xTF32
        out32, lse32 = ta.tree_attention_fwd_tf32(q, k, v, template, ids, lut, scale, True, TRAIN_RATE, dseed, True)
        _, _, delta32 = ta.tree_attention_bwd_dq(q, k, v, out32, g, template, ids, lut, lse32, scale, True, TRAIN_RATE,
                                                 dseed)
        dense32 = ta.assemble_bias(template, ids, lut, True).contiguous()
        calls32 = {
            "fwd_tf32": lambda: ta.tree_attention_fwd_tf32(q, k, v, template, ids, lut, scale, True, TRAIN_RATE, dseed,
                                                           True),
            "dq_tf32": lambda: ta.tree_attention_bwd_dq_tf32(q, k, v, out32, g, template, ids, lut, lse32, scale, True,
                                                             TRAIN_RATE, dseed),
            "dkv_tf32": lambda: ta.tree_attention_bwd_dkv_tf32(q, k, v, g, template, ids, lut, lse32, delta32, scale,
                                                               True, TRAIN_RATE, dseed),
            "fwd_cuda_core": lambda: ta.tree_attention_fwd(q, k, v, template, ids, lut, scale, True, TRAIN_RATE, dseed,
                                                           True),
            "dq_cuda_core": lambda: ta.tree_attention_bwd_dq(q, k, v, out32, g, template, ids, lut, lse32, scale, True,
                                                             TRAIN_RATE, dseed),
            "dkv_cuda_core": lambda: ta.tree_attention_bwd_dkv(q, k, v, g, template, ids, lut, lse32, delta32, scale, True,
                                                               TRAIN_RATE, dseed),
            "library_contiguous_fwd": lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=dense32, dropout_p=TRAIN_RATE, scale=scale),
            "library_contiguous_fwd_bwd": sdpa_fwd_bwd(dense32, q, k, v, g),
        }
        if (s, b) == TRAIN_SHAPES[0]:  # the plain version in float32 at the canonical shape
            calls32["plain_fwd"] = lambda: ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, dseed,
                                                                               TRAIN_RATE, scale)
            calls32["plain_fwd_bwd"] = plain_bwd_of(q, k, v, g)
        row["float32"] = {"ms": {name: timed_ms(fn) for name, fn in calls32.items()},
                          "bound": work_bounds(b, h, s, dh, "float32", 2 * b * s * s * 4 + 32 * h * 4),
                          "bound_3xtf32": work_bounds(b, h, s, dh, "3xtf32", 2 * b * s * s * 4 + 32 * h * 4)}
        f32ms = row["float32"]["ms"]
        f32ms["pair_tf32"] = f32ms["dq_tf32"] + f32ms["dkv_tf32"]
        f32ms["pair_cuda_core"] = f32ms["dq_cuda_core"] + f32ms["dkv_cuda_core"]
        if "plain_fwd_bwd" in f32ms:
            f32ms["plain_bwd"] = f32ms["plain_fwd_bwd"] - f32ms["plain_fwd"]
        row["float32"]["pair_tf32_vs_cuda_core"] = f32ms["pair_cuda_core"] / f32ms["pair_tf32"]
        row["float32"]["fwd_tf32_vs_cuda_core"] = f32ms["fwd_cuda_core"] / f32ms["fwd_tf32"]
        row["float32"]["fwd_tf32_vs_library_contiguous"] = f32ms["fwd_tf32"] / f32ms["library_contiguous_fwd"]
        row["float32"]["pair_tf32_vs_library_contiguous_fwd_bwd"] = f32ms["pair_tf32"] / f32ms["library_contiguous_fwd_bwd"]
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
    # the tensor-core forward's mask in bf16 over ten key tiles: v one-hot
    # in keys c*dh .. c*dh+dh-1 reads keep / (S (1 - rate)) there, within a
    # bf16 step of it
    s_mma, b_mma = 601, 1
    zeros = torch.zeros(b_mma, h, s_mma, dh, device="cuda", dtype=torch.bfloat16)
    c0, chunks = _counts(), []
    for c in range(-(-s_mma // dh)):
        v1 = torch.zeros(s_mma + dh, dh, device="cuda")
        v1[c * dh: (c + 1) * dh] = torch.eye(dh, device="cuda")
        out = ta.tree_attention(
            zeros, zeros, v1[:s_mma].to(torch.bfloat16).expand(b_mma, h, s_mma, dh).contiguous(),
            torch.zeros(b_mma, s_mma, s_mma, device="cuda"),
            torch.zeros(b_mma, s_mma, s_mma, dtype=torch.int32, device="cuda"),
            torch.zeros(ta.LUT_SIZE, h, device="cuda"), rate=TRAIN_RATE, seed=seed + 98,
        )
        chunks.append((out.float() * s_mma * (1 - TRAIN_RATE)).round() > 0.5)
    launched = dict(zip(KERNEL_NAMES, (y - x for x, y in zip(c0, _counts()))))
    mask_mma = torch.cat(chunks, dim=-1)[..., :s_mma]
    same_mma = bool(torch.equal(mask_mma, ta.dropout_keep_mask(seed + 98, b_mma, h, s_mma, TRAIN_RATE, "cuda")))
    kept_mma = mask_mma.float().mean().item()
    # the 3xTF32 forward's mask in float32 on the same chunks
    zeros = torch.zeros(b_mma, h, s_mma, dh, device="cuda")
    c0, chunks32 = _counts(), []
    for c in range(-(-s_mma // dh)):
        v1 = torch.zeros(s_mma + dh, dh, device="cuda")
        v1[c * dh: (c + 1) * dh] = torch.eye(dh, device="cuda")
        out = ta.tree_attention(
            zeros, zeros, v1[:s_mma].expand(b_mma, h, s_mma, dh).contiguous(),
            torch.zeros(b_mma, s_mma, s_mma, device="cuda"),
            torch.zeros(b_mma, s_mma, s_mma, dtype=torch.int32, device="cuda"),
            torch.zeros(ta.LUT_SIZE, h, device="cuda"), rate=TRAIN_RATE, seed=seed + 95,
        )
        chunks32.append((out * s_mma * (1 - TRAIN_RATE)).round() > 0.5)
    launched_tf32_fwd = dict(zip(KERNEL_NAMES, (y - x for x, y in zip(c0, _counts()))))
    mask_tf32 = torch.cat(chunks32, dim=-1)[..., :s_mma]
    same_tf32_fwd = bool(torch.equal(mask_tf32, ta.dropout_keep_mask(seed + 95, b_mma, h, s_mma, TRAIN_RATE, "cuda")))
    kept_tf32_fwd = mask_tf32.float().mean().item()
    # the tensor-core backward pair's masks, both kernels, over ten 64-row
    # and 64-key chunks
    c0 = _counts()
    by_dv, by_dq = read_back_tree_bwd_masks(ta, b_mma, h, s_mma, TRAIN_RATE, seed + 97)
    launched_bwd = dict(zip(KERNEL_NAMES, (y - x for x, y in zip(c0, _counts()))))
    want_bwd = ta.dropout_keep_mask(seed + 97, b_mma, h, s_mma, TRAIN_RATE, "cuda")
    same_bwd = {"dkv_kernel": bool(torch.equal(by_dv, want_bwd)), "dq_kernel": bool(torch.equal(by_dq, want_bwd))}
    kept_bwd = by_dv.float().mean().item()
    # the 3xTF32 pair's, both kernels, in float32 on the same chunks
    c0 = _counts()
    by_dv, by_dq = read_back_tree_bwd_masks(ta, b_mma, h, s_mma, TRAIN_RATE, seed + 96, "float32")
    launched_tf32 = dict(zip(KERNEL_NAMES, (y - x for x, y in zip(c0, _counts()))))
    want_tf32 = ta.dropout_keep_mask(seed + 96, b_mma, h, s_mma, TRAIN_RATE, "cuda")
    same_tf32 = {"dkv_kernel": bool(torch.equal(by_dv, want_tf32)), "dq_kernel": bool(torch.equal(by_dq, want_tf32))}
    kept_tf32 = by_dv.float().mean().item()
    emit({"phase": "dropout_mask", "S": s, "B": b, "H": h, "rate": TRAIN_RATE, "kept_fraction": kept,
          "equals_plain_philox": same,
          "tensor_core_bf16": {"S": s_mma, "B": b_mma, "kept_fraction": kept_mma, "equals_plain_philox": same_mma,
                               "launches": launched},
          "tensor_core_bwd_bf16": {"S": s_mma, "B": b_mma, "kept_fraction": kept_bwd, "equals_plain_philox": same_bwd,
                                   "launches": launched_bwd},
          "tf32_fwd_float32": {"S": s_mma, "B": b_mma, "kept_fraction": kept_tf32_fwd,
                               "equals_plain_philox": same_tf32_fwd, "launches": launched_tf32_fwd},
          "tf32_bwd_float32": {"S": s_mma, "B": b_mma, "kept_fraction": kept_tf32, "equals_plain_philox": same_tf32,
                               "launches": launched_tf32}})
    if not same or abs(kept - (1 - TRAIN_RATE)) > 0.02:
        raise AssertionError(f"kernel mask: equals plain {same}, kept fraction {kept}")
    if not same_mma or abs(kept_mma - (1 - TRAIN_RATE)) > 0.02 or launched["tree_attention_fwd_fused"] != len(chunks) \
            or launched["tree_attention_fwd"]:
        raise AssertionError(f"tensor-core forward mask: equals plain {same_mma}, kept fraction {kept_mma}, {launched}")
    if not same_tf32_fwd or abs(kept_tf32_fwd - (1 - TRAIN_RATE)) > 0.02 \
            or launched_tf32_fwd["tree_attention_fwd_tf32"] != len(chunks32) or launched_tf32_fwd["tree_attention_fwd"]:
        raise AssertionError(f"3xTF32 forward mask: equals plain {same_tf32_fwd}, kept fraction {kept_tf32_fwd}, "
                             f"{launched_tf32_fwd}")
    n_bwd = 2 * -(-s_mma // dh)  # two backward calls a chunk
    if not all(same_bwd.values()) or abs(kept_bwd - (1 - TRAIN_RATE)) > 0.02 \
            or (launched_bwd["tree_attention_bwd_dq_fused"], launched_bwd["tree_attention_bwd_dkv_fused"]) != (n_bwd, n_bwd) \
            or launched_bwd["tree_attention_bwd_dq"] or launched_bwd["tree_attention_bwd_dkv"]:
        raise AssertionError(f"tensor-core backward masks: equal plain {same_bwd}, kept fraction {kept_bwd}, {launched_bwd}")
    if not all(same_tf32.values()) or abs(kept_tf32 - (1 - TRAIN_RATE)) > 0.02 \
            or (launched_tf32["tree_attention_bwd_dq_tf32"], launched_tf32["tree_attention_bwd_dkv_tf32"]) != (n_bwd, n_bwd) \
            or launched_tf32["tree_attention_bwd_dq"] or launched_tf32["tree_attention_bwd_dkv"]:
        raise AssertionError(f"3xTF32 backward masks: equal plain {same_tf32}, kept fraction {kept_tf32}, {launched_tf32}")
    return rows, kernel_train_dh16(ta, seed)


# the workflows' graph attention (hidden 64 over 4 heads) at the canonical
# bucket: float32 takes the 3xTF32 forward and pair there, bf16 K1 and K2/K3
DH16_SHAPE = {"S": 33, "B": 12, "H": 4, "dh": 16}


def kernel_train_dh16(ta, seed: int) -> dict:
    """The tree kernels at DH 16 (``DH16_SHAPE``, rate 0.3 and 0): float32
    through ``tree_attention`` (the 3xTF32 forward and pair) against the
    plain version and, from K1's LSE, against K2/K3 called directly, the
    3xTF32 forward's LSE against K1's; bf16 through ``tree_attention`` (K1
    and K2/K3: the "cuda_core" route) against the plain version, its
    launches counted as the bf16 DH-16 path's; times of the 3xTF32 forward
    and pair, K1, K2/K3 and SDPA in float32 beside both bounds."""
    import torch
    import torch.nn.functional as F

    s, b, h, dh = (DH16_SHAPE[n] for n in ("S", "B", "H", "dh"))
    scale = dh ** -0.5
    template, ids, lut = (t.cuda() for t in compact_inputs(s, b, h, seed + 16))
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    q, k, v, g = (torch.randn(b, h, s, dh, device="cuda", generator=gen) for _ in range(4))
    dseed = seed * 1000003 + 16
    row = {"phase": "kernel_vs_plain_train_dh16", **DH16_SHAPE, "rate": TRAIN_RATE, "errors": {}, "errors_rate0": {}}
    for rate, key in ((TRAIN_RATE, "errors"), (0.0, "errors_rate0")):
        c0 = _counts()
        got = _fwd_and_grads(ta.tree_attention, q, k, v, template, ids, lut, g, rate=rate, seed=dseed)
        launched = dict(zip(KERNEL_NAMES, (y - x for x, y in zip(c0, _counts()))))
        want = _fwd_and_grads(ta.tree_attention_dropout_reference, q, k, v, template, ids, lut, g, rate=rate, seed=dseed)
        k23 = cuda_core_pair(ta, q, k, v, template, ids, lut, g, scale, rate, dseed, fwd=ta.tree_attention_fwd)
        torch.cuda.synchronize()
        names = ("out", "dq", "dk", "dv", "dlut")
        row[key]["float32"] = _check_errors(got, want, names, TRAIN_F32_REL, f"DH-16 float32 route at rate {rate}")
        row[key]["float32_vs_cuda_core_pair"] = _check_errors(got[1:], k23, names[1:], TRAIN_F32_REL,
                                                              f"DH-16 3xTF32 pair against K2/K3 at rate {rate}")
        row[key]["float32_cuda_core_pair"] = _check_errors(k23, want[1:], names[1:], TRAIN_F32_REL,
                                                           f"DH-16 K2/K3 at rate {rate}")
        _, lse_k1 = ta.tree_attention_fwd(q, k, v, template, ids, lut, scale, True, rate, dseed, True)
        _, lse_tf32 = ta.tree_attention_fwd_tf32(q, k, v, template, ids, lut, scale, True, rate, dseed, True)
        row[key]["float32_lse_vs_k1"] = _check_stat(lse_tf32, lse_k1, f"DH-16 3xTF32 LSE against K1's at rate {rate}")
        want_launch = {"tree_attention_fwd_tf32": 1, "tree_attention_bwd_dq_tf32": 1, "tree_attention_bwd_dkv_tf32": 1}
        if launched != {n: want_launch.get(n, 0) for n in KERNEL_NAMES}:
            raise AssertionError(f"DH-16 float32 route launched {launched}")
        qq, kk, vv, gg = (x.to(torch.bfloat16) for x in (q, k, v, g))
        _zero_counts()
        got = _fwd_and_grads(ta.tree_attention, qq, kk, vv, template, ids, lut, gg, rate=rate, seed=dseed)
        launched = dict(zip(KERNEL_NAMES, _counts()))
        want = _fwd_and_grads(ta.tree_attention_dropout_reference, qq, kk, vv, template, ids, lut, gg, rate=rate,
                              seed=dseed)
        torch.cuda.synchronize()
        row[key]["bfloat16"] = _check_errors(got, want, names, TRAIN_BF16_REL, f"DH-16 bf16 route at rate {rate}")
        want_launch = {"tree_attention_fwd": 1, "tree_attention_bwd_dq": 1, "tree_attention_bwd_dkv": 1}
        if launched != {n: want_launch.get(n, 0) for n in KERNEL_NAMES}:
            raise AssertionError(f"DH-16 bf16 route launched {launched}")
        row.setdefault("launches_bfloat16", launched)  # the rate-0.3 call's

    out, lse = ta.tree_attention_fwd_tf32(q, k, v, template, ids, lut, scale, True, TRAIN_RATE, dseed, True)
    _, _, delta = ta.tree_attention_bwd_dq_tf32(q, k, v, out, g, template, ids, lut, lse, scale, True, TRAIN_RATE, dseed)
    dense = ta.assemble_bias(template, ids, lut, True).contiguous()

    def sdpa_fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v, dense)]
        F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=scale).backward(g)

    def plain_fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v, lut)]
        ta.tree_attention_dropout_reference(leaves[0], leaves[1], leaves[2], template, ids, leaves[3], dseed,
                                            TRAIN_RATE, scale).backward(g)

    calls = {
        "fwd_tf32": lambda: ta.tree_attention_fwd_tf32(q, k, v, template, ids, lut, scale, True, TRAIN_RATE, dseed,
                                                       True),
        "fwd_cuda_core": lambda: ta.tree_attention_fwd(q, k, v, template, ids, lut, scale, True, TRAIN_RATE, dseed,
                                                       True),
        "library_contiguous_fwd": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=dense, dropout_p=TRAIN_RATE,
                                                                         scale=scale),
        "dq_tf32": lambda: ta.tree_attention_bwd_dq_tf32(q, k, v, out, g, template, ids, lut, lse, scale, True,
                                                         TRAIN_RATE, dseed),
        "dkv_tf32": lambda: ta.tree_attention_bwd_dkv_tf32(q, k, v, g, template, ids, lut, lse, delta, scale, True,
                                                           TRAIN_RATE, dseed),
        "dq_cuda_core": lambda: ta.tree_attention_bwd_dq(q, k, v, out, g, template, ids, lut, lse, scale, True,
                                                         TRAIN_RATE, dseed),
        "dkv_cuda_core": lambda: ta.tree_attention_bwd_dkv(q, k, v, g, template, ids, lut, lse, delta, scale, True,
                                                           TRAIN_RATE, dseed),
        "plain_fwd": lambda: ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, dseed, TRAIN_RATE, scale),
        "plain_fwd_bwd": plain_fwd_bwd,
        "library_contiguous_fwd_bwd": sdpa_fwd_bwd,
    }
    row["ms"] = {name: timed_ms(fn) for name, fn in calls.items()}
    row["ms"]["plain_bwd"] = row["ms"]["plain_fwd_bwd"] - row["ms"]["plain_fwd"]
    row["ms"]["pair_tf32"] = row["ms"]["dq_tf32"] + row["ms"]["dkv_tf32"]
    row["ms"]["pair_cuda_core"] = row["ms"]["dq_cuda_core"] + row["ms"]["dkv_cuda_core"]
    shared = 2 * b * s * s * 4 + 32 * h * 4
    row["bound"] = work_bounds(b, h, s, dh, "float32", shared)
    row["bound_3xtf32"] = work_bounds(b, h, s, dh, "3xtf32", shared)
    # bf16, the route K1 and K2/K3 take now: their times beside SDPA in
    # bf16 (contiguous bias) and the bf16 bound
    qq, kk, vv, gg = (x.to(torch.bfloat16) for x in (q, k, v, g))
    out16, lse16 = ta.tree_attention_fwd(qq, kk, vv, template, ids, lut, scale, True, TRAIN_RATE, dseed, True)
    _, _, delta16 = ta.tree_attention_bwd_dq(qq, kk, vv, out16, gg, template, ids, lut, lse16, scale, True,
                                             TRAIN_RATE, dseed)
    dense16 = dense.to(torch.bfloat16)

    def sdpa16_fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (qq, kk, vv)]
        F.scaled_dot_product_attention(*leaves, attn_mask=dense16, dropout_p=TRAIN_RATE, scale=scale).backward(gg)

    row["bfloat16_cuda_core"] = {"ms": {
        "fwd": timed_ms(lambda: ta.tree_attention_fwd(qq, kk, vv, template, ids, lut, scale, True, TRAIN_RATE, dseed,
                                                      True)),
        "dq": timed_ms(lambda: ta.tree_attention_bwd_dq(qq, kk, vv, out16, gg, template, ids, lut, lse16, scale, True,
                                                        TRAIN_RATE, dseed)),
        "dkv": timed_ms(lambda: ta.tree_attention_bwd_dkv(qq, kk, vv, gg, template, ids, lut, lse16, delta16, scale,
                                                          True, TRAIN_RATE, dseed)),
        "library_fwd": timed_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=dense16,
                                                                       dropout_p=TRAIN_RATE, scale=scale)),
        "library_fwd_bwd": timed_ms(sdpa16_fwd_bwd)},
        "bound": work_bounds(b, h, s, dh, "bfloat16", shared)}
    emit(row)
    return row


def cuda_core_pair(ta, q, k, v, template, ids, lut, g, scale, rate, seed, fwd=None):
    """dq, dk, dv, dlut of K2/K3 called directly (the route sends bf16 at
    DH 64 to the tensor-core pair and float32 to the 3xTF32 one), from the
    LSE of ``fwd`` (the tensor-core forward unless given)."""
    fwd = ta.tree_attention_fwd_fused if fwd is None else fwd
    out, lse = fwd(q, k, v, template, ids, lut, scale, True, rate, seed, with_lse=True)
    dq, dlut, delta = ta.tree_attention_bwd_dq(q, k, v, out, g, template, ids, lut, lse, scale, True, rate, seed)
    dk, dv = ta.tree_attention_bwd_dkv(q, k, v, g, template, ids, lut, lse, delta, scale, True, rate, seed)
    return [dq, dk, dv, dlut]


def read_back_tree_bwd_masks(ta, b, h, s, rate, seed, dtype_name: str = "bfloat16"):
    """The routed backward pair's keep masks (bf16: the tensor-core pair;
    float32: the 3xTF32 pair), read back in ``dtype_name`` with q = 0 and no
    bias (every weight 1/S), one 64-row or 64-key chunk c at a time:
    - the dk/dv kernel's, through dv: with g one-hot in rows c*64 ..
      c*64+63, dv[j, d] = keep[c*64 + d, j] / (S (1 - rate));
    - the dq kernel's, through dq: with v and g = e_0 on every row, ds_ij =
      (keep_ij / (1 - rate) - D_i) / S where D_i, the kept share over 1 -
      rate, is below 1 / (1 - rate), so ds > 0 exactly where kept; with k
      one-hot in keys c*64 .. c*64+63, dq[i, d] = ds[i, c*64 + d] / 8."""
    import torch

    dh = 64
    dt = getattr(torch, dtype_name)
    zeros = torch.zeros(b, h, s, dh, device="cuda", dtype=dt)
    template = torch.zeros(b, s, s, device="cuda")
    ids = torch.zeros(b, s, s, dtype=torch.int32, device="cuda")
    lut = torch.zeros(ta.LUT_SIZE, h, device="cuda")
    e0 = zeros.clone()
    e0[..., 0] = 1.0
    by_dv, by_dq = [], []
    for c in range(-(-s // dh)):
        onehot = torch.zeros(s + dh, dh, device="cuda")
        onehot[c * dh: (c + 1) * dh] = torch.eye(dh, device="cuda")
        onehot = onehot[:s].to(dt).expand(b, h, s, dh).contiguous()
        v = zeros.clone().requires_grad_(True)
        ta.tree_attention(zeros, zeros, v, template, ids, lut, rate=rate, seed=seed).backward(onehot)
        by_dv.append(v.grad.float().transpose(-1, -2) != 0)
        q = zeros.clone().requires_grad_(True)
        ta.tree_attention(q, onehot, e0, template, ids, lut, rate=rate, seed=seed).backward(e0)
        by_dq.append(q.grad.float() > 0)
    return torch.cat(by_dv, dim=-2)[..., :s, :], torch.cat(by_dq, dim=-1)[..., :s]


# the tower shapes: (label, B, S, key bias) at H = 12, dh = 64. Text rows
# carry 100 tokens (bottom) and 4 bottleneck tokens more (fusion) at the
# canonical text capacity of 256; the ViT carries 196 patches, its CLS
# token and 4 bottleneck tokens at an image capacity of 64, without a bias
MASKED_SHAPES = (("text_bottom", 256, 100, True), ("text_fusion", 256, 104, True),
                 ("vit_fusion", 64, 201, False))
# ragged lengths for the one-pass backward (B = 8, one capacity-padding
# row): the ends of its range and the edges of its 16-key steps, 64-row
# tiles and 8-/16-warp blocks
RAGGED_S = (1, 16, 17, 36, 100, 104, 127, 128, 129, 197, 201, 256)
RAGGED_B = 8
# past the tensor-core route's S <= 256: float32 takes the 3xTF32 forward
# there, bf16 the CUDA-core forward (checked, not timed)
MASKED_LONG = ("long_300", 8, 300, True)
MASKED_RATE = 0.3
# the launches of one masked_attention forward and backward, by route
MASKED_ROUTE_LAUNCHES = {
    "tf32": {"masked_attention_fwd_tf32": 1, "masked_attention_bwd_dq_tf32": 1, "masked_attention_bwd_dkv_tf32": 1},
    "tensor_core": {"masked_attention_fwd_fused": 1, "masked_attention_bwd_fused": 1},
    "cuda_core": {"masked_attention_fwd": 1, "masked_attention_bwd_dq": 1, "masked_attention_bwd_dkv": 1},
}


def tower_key_bias(b: int, s: int, bottleneck: int, gen):
    """(B, S) f32 key bias as the towers build it: each row attends to its
    bottleneck columns and its first 5..S-bottleneck tokens; the last eighth
    of the rows is capacity padding, every key masked, where the row has no
    bottleneck columns."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.ops.masked_attention import MASK_BIAS

    tokens = s - bottleneck
    lengths = torch.randint(min(5, tokens), tokens + 1, (b, 1), generator=gen, device="cuda")
    open_ = torch.arange(tokens, device="cuda")[None] < lengths
    if bottleneck:
        open_ = torch.cat([torch.ones(b, bottleneck, dtype=torch.bool, device="cuda"), open_], dim=1)
    else:
        open_[b - b // 8:] = False
    return torch.where(open_, 0.0, MASK_BIAS).float().contiguous()


def read_back_mask(ma, b, h, s, dh, rate, seed, dtype):
    """The keep mask of the forward kernel that ``dtype`` routes to: with q
    = k = 0 and no bias, every row weighs its keys equally, so with v
    holding one-hot columns for keys c*dh .. c*dh+dh-1, out = keep / (S (1 -
    rate)) there (within a bf16 step in bf16, far from the 0.5 the rounding
    cuts at)."""
    import torch

    zeros = torch.zeros(b, h, s, dh, device="cuda", dtype=dtype)
    chunks = []
    for c in range(-(-s // dh)):
        v = torch.zeros(s + dh, dh, device="cuda")
        v[c * dh: (c + 1) * dh] = torch.eye(dh, device="cuda")
        out = ma.masked_attention(zeros, zeros, v[:s].to(dtype).expand(b, h, s, dh).contiguous(), None,
                                  seed=seed, rate=rate)
        chunks.append((out.float() * s * (1 - rate)).round() > 0.5)
    return torch.cat(chunks, dim=-1)[..., :s]


def read_back_bwd_mask(ma, b, h, s, dh, rate, seed):
    """The one-pass backward's keep mask, read through dv (bf16): with q = k
    = 0 and no bias every weight is 1/S, so with g one-hot in rows c*dh ..
    c*dh+dh-1, dv[j, d] = keep[c*dh + d, j] / (S (1 - rate))."""
    import torch

    zeros = torch.zeros(b, h, s, dh, device="cuda", dtype=torch.bfloat16)
    chunks = []
    for c in range(-(-s // dh)):
        g = torch.zeros(s + dh, dh, device="cuda")
        g[c * dh: (c + 1) * dh] = torch.eye(dh, device="cuda")
        v = zeros.clone().requires_grad_(True)
        ma.masked_attention(zeros, zeros, v, None, seed=seed, rate=rate).backward(
            g[:s].to(torch.bfloat16).expand(b, h, s, dh).contiguous())
        chunks.append(v.grad.float().transpose(-1, -2) != 0)
    return torch.cat(chunks, dim=-2)[..., :s, :]


def read_back_tf32_pair_masks(ma, b, h, s, dh, rate, seed):
    """The 3xTF32 tower pair's keep masks (float32), read back with q = 0
    and no bias (every weight 1/S), one dh-row or dh-key chunk c at a time:
    the dk/dv kernel's through dv (g one-hot in rows c*dh .. c*dh+dh-1:
    dv[j, d] = keep[c*dh + d, j] / (S (1 - rate))); the dq kernel's through
    dq (v = g = e_0 on every row: ds_ij = (keep_ij / (1 - rate) - D_i) / S,
    positive exactly where kept unless a row keeps every key; k one-hot in
    keys c*dh .. c*dh+dh-1: dq[i, d] = scale ds[i, c*dh + d])."""
    import torch

    zeros = torch.zeros(b, h, s, dh, device="cuda")
    e0 = zeros.clone()
    e0[..., 0] = 1.0
    by_dv, by_dq = [], []
    for c in range(-(-s // dh)):
        onehot = torch.zeros(s + dh, dh, device="cuda")
        onehot[c * dh: (c + 1) * dh] = torch.eye(dh, device="cuda")
        onehot = onehot[:s].expand(b, h, s, dh).contiguous()
        v = zeros.clone().requires_grad_(True)
        ma.masked_attention(zeros, zeros, v, None, seed=seed, rate=rate).backward(onehot)
        by_dv.append(v.grad.transpose(-1, -2) != 0)
        q = zeros.clone().requires_grad_(True)
        ma.masked_attention(q, onehot, e0, None, seed=seed, rate=rate).backward(e0)
        by_dq.append(q.grad > 0)
    return torch.cat(by_dv, dim=-2)[..., :s, :], torch.cat(by_dq, dim=-1)[..., :s]


def plain_tower_stats(q, k, bias, scale):
    """(row max clamped at -1e9, log of the clamped undropped row sum), f32
    (2, B, H, S), as the tower forwards store them."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.ops.masked_attention import MASK_BIAS

    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float().clamp_min(MASK_BIAS)[:, None, None, :]
    m = s.amax(-1).clamp_min(MASK_BIAS)
    return torch.stack([m, torch.exp(s - m[..., None]).sum(-1).clamp_min(1e-30).log()])


def pair_outputs(ma, q, k, v, bias, g, scale, rate, seed):
    """out, dq, dk, dv from the CUDA-core forward and backward pair, called
    directly (the route sends bf16 to the tensor-core kernels)."""
    out, stats = ma.masked_attention_fwd(q, k, v, bias, scale, rate, seed, with_stats=True)
    dq, delta = ma.masked_attention_bwd_dq(q, k, v, out, g, bias, stats, scale, rate, seed)
    dk, dv = ma.masked_attention_bwd_dkv(q, k, v, g, bias, stats, delta, scale, rate, seed)
    return [out, dq, dk, dv]


def phase_masked(seed: int):
    """The tower kernels against their plain version, each call's launches
    against its route; the 3xTF32 forward's statistics against the plain
    ones; the masks read back; the adjoint identity; times beside the
    unfused path and SDPA."""
    import torch
    import torch.nn.functional as F

    from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import fast_dropout
    from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    h, dh = 12, 64
    scale = dh ** -0.5
    rows = []
    shapes = [(*shape, True) for shape in MASKED_SHAPES] + [(f"ragged_{s}", RAGGED_B, s, True, False) for s in RAGGED_S]
    shapes.append((*MASKED_LONG, False))
    for label, b, s, with_bias, tower in shapes:
        gen = torch.Generator(device="cuda").manual_seed(seed + 31 * s + b)
        q, k, v, g = (torch.randn(b, h, s, dh, device="cuda", generator=gen) for _ in range(4))
        bias = tower_key_bias(b, s, 4 if "fusion" in label else 0, gen) if with_bias else None
        dseed = seed * 1000003 + 7 * s + b
        row = {"shape": label, "B": b, "S": s, "H": h, "dh": dh, "key_bias": with_bias,
               "fully_masked_rows": 0 if bias is None else int((bias <= ma.MASK_BIAS).all(dim=1).sum()),
               "rate": MASKED_RATE, "kernel_route": {n: ma.kernel_route(getattr(torch, n), dh, s)
                                                     for n in ("float32", "bfloat16")},
               "errors": {}, "errors_rate0": {}}
        for rate, key in ((MASKED_RATE, "errors"), (0.0, "errors_rate0")):
            for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                qq, kk, vv, gg = (x.to(dt).contiguous() for x in (q, k, v, g))

                def fwd_bwd(fn):
                    leaves = [x.detach().clone().requires_grad_(True) for x in (qq, kk, vv)]
                    o = fn(*leaves, bias, seed=dseed, rate=rate)
                    o.backward(gg)
                    return [o.detach()] + [x.grad for x in leaves]

                c0 = _counts()
                got = fwd_bwd(ma.masked_attention)
                launched = {n: y - x for n, x, y in zip(KERNEL_NAMES, c0, _counts()) if y != x}
                row.setdefault("launches", {})[f"{name}_rate{rate}"] = launched
                if launched != MASKED_ROUTE_LAUNCHES[row["kernel_route"][name]]:
                    raise AssertionError(f"masked kernels at {label} {name} launched {launched}")
                want = fwd_bwd(ma.masked_attention_dropout_reference)
                torch.cuda.synchronize()
                if name == "float32" and rate == MASKED_RATE:
                    want_out32 = want[0]
                tol = TRAIN_F32_REL if name == "float32" else TRAIN_BF16_REL
                # at S = 1 dq and dk are 0 in exact arithmetic (softmax over
                # one key has no gradient): what remains is the rounding of
                # g . v / (1 - rate) - g . out, terms of the size of dv
                floor = want[3].float().abs().max().item() if s == 1 else 0.0
                row[key][name] = _check_errors(got, want, ("out", "dq", "dk", "dv"), tol,
                                               f"masked kernels disagree at {label} rate {rate} {name}", floor)
                if name == "float32" or tower:
                    # the CUDA-core kernels on the same inputs, called
                    # directly: in float32 the kernels the 3xTF32 ones
                    # replace, in bf16 what the tensor-core kernels' bf16 P
                    # and dS cost beside their f32
                    pair = pair_outputs(ma, qq, kk, vv, bias, gg, scale, rate, dseed)
                    torch.cuda.synchronize()
                    row[key][f"{name}_pair"] = _check_errors(pair, want, ("out", "dq", "dk", "dv"), tol,
                                                             f"masked pair disagrees at {label} rate {rate} {name}",
                                                             floor)
        # the 3xTF32 forward's statistics (float32) against the plain ones
        # (a capacity-padding row's max is -1e9 exactly), and the CUDA-core
        # forward it replaces there, called directly, against the plain
        # version and the 3xTF32 statistics
        _, stats32 = ma.masked_attention_fwd_tf32(q, k, v, bias, scale, MASKED_RATE, dseed, with_stats=True)
        cc_out, cc_stats = ma.masked_attention_fwd(q, k, v, bias, scale, MASKED_RATE, dseed, with_stats=True)
        ref = plain_tower_stats(q, k, bias, scale)
        row["stats_float32"] = {"row_max": _check_stat(stats32[0], ref[0], f"3xTF32 row max at {label}"),
                                "log_sum": _check_stat(stats32[1], ref[1], f"3xTF32 log-sum at {label}"),
                                "vs_cuda_core": _check_stat(stats32, cc_stats, f"3xTF32 against CUDA-core stats at {label}")}
        padding = ref[0] <= ma.MASK_BIAS
        if not torch.equal(stats32[0][padding], ref[0][padding]):
            raise AssertionError(f"3xTF32 row max of the padding rows at {label}")
        row["float32_cuda_core_fwd"] = _check_errors([cc_out], [want_out32], ("out",), TRAIN_F32_REL,
                                                     f"CUDA-core forward disagrees at {label} f32")
        del ref, cc_out, cc_stats, want_out32
        if label == "text_fusion":
            # the adjoint identity in v, float32, on 16 of the rows
            q16, k16, v16, g16 = (x[:16].contiguous() for x in (q, k, v, g))
            v2 = torch.randn(q16.shape, device="cuda", generator=gen)
            vv = v16.clone().requires_grad_(True)
            ma.masked_attention(q16, k16, vv, bias[:16], seed=dseed, rate=MASKED_RATE).backward(g16)
            lhs = (g16.double() * ma.masked_attention(q16, k16, v2, bias[:16], seed=dseed, rate=MASKED_RATE).double()).sum().item()
            rhs = (vv.grad.double() * v2.double()).sum().item()
            row["adjoint"] = {"lhs": lhs, "rhs": rhs, "rel_err": abs(lhs - rhs) / max(abs(lhs), 1.0), "rel_tol": ADJOINT_REL}
            if not abs(lhs - rhs) <= ADJOINT_REL * max(abs(lhs), 1.0):
                raise AssertionError(f"masked adjoint identity fails: {row['adjoint']}")

        if s > ma.TENSOR_CORE_MAX_S:
            # past the tensor-core kernels: bf16 takes the CUDA-core forward
            # and pair here, timed beside SDPA in bf16 and the bf16 bound
            qq, kk, vv, gg = (x.to(torch.bfloat16).contiguous() for x in (q, k, v, g))
            out, stats = ma.masked_attention_fwd(qq, kk, vv, bias, scale, MASKED_RATE, dseed, with_stats=True)
            bias4 = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)

            def pair_long():
                _, delta_ = ma.masked_attention_bwd_dq(qq, kk, vv, out, gg, bias, stats, scale, MASKED_RATE, dseed)
                ma.masked_attention_bwd_dkv(qq, kk, vv, gg, bias, stats, delta_, scale, MASKED_RATE, dseed)

            def sdpa_long():
                leaves = [x.detach().requires_grad_(True) for x in (qq, kk, vv)]
                F.scaled_dot_product_attention(*leaves, attn_mask=bias4, dropout_p=MASKED_RATE,
                                               scale=scale).backward(gg)

            row["bfloat16_cuda_core"] = {
                "ms": {"fwd": timed_ms(lambda: ma.masked_attention_fwd(qq, kk, vv, bias, scale, MASKED_RATE, dseed,
                                                                       with_stats=True)),
                       "pair": timed_ms(pair_long),
                       "library_fwd": timed_ms(lambda: F.scaled_dot_product_attention(
                           qq, kk, vv, attn_mask=bias4, dropout_p=MASKED_RATE, scale=scale)),
                       "library_fwd_bwd": timed_ms(sdpa_long)},
                "bound": work_bounds(b, h, s, dh, "bfloat16", 0 if bias is None else b * s * 4, stat_planes=2)}
            emit({"phase": "masked_vs_plain", **row})
            rows.append(row)
            continue

        # times in the main path's type
        qq, kk, vv, gg = (x.to(torch.bfloat16).contiguous() for x in (q, k, v, g))
        out, stats = ma.masked_attention_fwd_fused(qq, kk, vv, bias, scale, MASKED_RATE, dseed, with_stats=True)
        _, delta = ma.masked_attention_bwd_dq(qq, kk, vv, out, gg, bias, stats, scale, MASKED_RATE, dseed)
        bias4 = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
        drop_gen = torch.Generator(device="cuda").manual_seed(seed)

        def unfused(q_, k_, v_):
            # the towers' unfused path (models/bert.py SelfAttention)
            scores = torch.matmul(q_, k_.transpose(-1, -2)) / math.sqrt(dh)
            if bias4 is not None:
                scores = scores + bias4
            probs = torch.softmax(scores.float(), dim=-1).to(q_.dtype)
            return torch.matmul(fast_dropout(probs, MASKED_RATE, drop_gen), v_)

        def with_grad(fn):
            def run():
                leaves = [x.detach().requires_grad_(True) for x in (qq, kk, vv)]
                fn(*leaves).backward(gg)
            return run

        def pair():
            _, delta_ = ma.masked_attention_bwd_dq(qq, kk, vv, out, gg, bias, stats, scale, MASKED_RATE, dseed)
            ma.masked_attention_bwd_dkv(qq, kk, vv, gg, bias, stats, delta_, scale, MASKED_RATE, dseed)

        calls = {
            "fwd_fused": lambda: ma.masked_attention_fwd_fused(qq, kk, vv, bias, scale, MASKED_RATE, dseed, with_stats=True),
            "bwd_fused": lambda: ma.masked_attention_bwd_fused(qq, kk, vv, out, gg, bias, stats, scale, MASKED_RATE, dseed),
        }
        if not tower:  # a ragged shape: checked above; timed only in the main path's two kernels
            row["ms"] = {name: timed_ms(fn) for name, fn in calls.items()}
            emit({"phase": "masked_vs_plain", **row})
            rows.append(row)
            continue
        calls.update({
            "fwd_fused_rate0": lambda: ma.masked_attention_fwd_fused(qq, kk, vv, bias, scale),
            "fwd": lambda: ma.masked_attention_fwd(qq, kk, vv, bias, scale, MASKED_RATE, dseed, with_stats=True),
            "pair": pair,
            "plain_fwd": lambda: ma.masked_attention_dropout_reference(qq, kk, vv, bias, dseed, MASKED_RATE, scale),
            "library_fwd": lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bias4, dropout_p=MASKED_RATE, scale=scale),
            "plain_fwd_bwd": with_grad(lambda q_, k_, v_: ma.masked_attention_dropout_reference(q_, k_, v_, bias, dseed, MASKED_RATE, scale)),
            "library_fwd_bwd_rate": with_grad(lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=bias4, dropout_p=MASKED_RATE, scale=scale)),
            "fwd_rate0": lambda: ma.masked_attention_fwd(qq, kk, vv, bias, scale),
            "dq": lambda: ma.masked_attention_bwd_dq(qq, kk, vv, out, gg, bias, stats, scale, MASKED_RATE, dseed),
            "dkv": lambda: ma.masked_attention_bwd_dkv(qq, kk, vv, gg, bias, stats, delta, scale, MASKED_RATE, dseed),
            "unfused_fwd": lambda: unfused(qq, kk, vv),
            "unfused_fwd_bwd": with_grad(unfused),
            "library_fwd_bwd": with_grad(lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=bias4, scale=scale)),
        })
        row["ms"] = {name: timed_ms(fn) for name, fn in calls.items()}
        row["ms"]["plain_bwd"] = row["ms"]["plain_fwd_bwd"] - row["ms"]["plain_fwd"]
        row["bound"] = work_bounds(b, h, s, dh, "bfloat16", 0 if bias is None else b * s * 4, stat_planes=2)
        row["fused_vs_pair"] = row["ms"]["pair"] / row["ms"]["bwd_fused"]
        row["fwd_fused_vs_cuda_core"] = row["ms"]["fwd"] / row["ms"]["fwd_fused"]
        row["fwd_fused_vs_library"] = row["ms"]["fwd_fused"] / row["ms"]["library_fwd"]
        # the float32 route (the 3xTF32 forward, then the 3xTF32 pair) on
        # float32 inputs, the CUDA-core kernels it replaces there and SDPA
        # on the same inputs, and the bounds: float32 on CUDA cores, and
        # 3xTF32
        out32, stats32 = ma.masked_attention_fwd_tf32(q, k, v, bias, scale, MASKED_RATE, dseed, with_stats=True)
        _, delta32 = ma.masked_attention_bwd_dq_tf32(q, k, v, out32, g, bias, stats32, scale, MASKED_RATE, dseed)
        bias4_32 = None if bias is None else bias[:, None, None, :]

        def with_grad32(fn):
            def run():
                leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
                fn(*leaves).backward(g)
            return run

        def sdpa32(rate):
            return with_grad32(lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=bias4_32, dropout_p=rate, scale=scale))

        calls32 = {
            "fwd_tf32": lambda: ma.masked_attention_fwd_tf32(q, k, v, bias, scale, MASKED_RATE, dseed, with_stats=True),
            "fwd": lambda: ma.masked_attention_fwd(q, k, v, bias, scale, MASKED_RATE, dseed, with_stats=True),
            "plain_fwd": lambda: ma.masked_attention_dropout_reference(q, k, v, bias, dseed, MASKED_RATE, scale),
            "dq_tf32": lambda: ma.masked_attention_bwd_dq_tf32(q, k, v, out32, g, bias, stats32, scale, MASKED_RATE,
                                                               dseed),
            "dkv_tf32": lambda: ma.masked_attention_bwd_dkv_tf32(q, k, v, g, bias, stats32, delta32, scale,
                                                                 MASKED_RATE, dseed),
            "dq": lambda: ma.masked_attention_bwd_dq(q, k, v, out32, g, bias, stats32, scale, MASKED_RATE, dseed),
            "dkv": lambda: ma.masked_attention_bwd_dkv(q, k, v, g, bias, stats32, delta32, scale, MASKED_RATE, dseed),
            "plain_fwd_bwd": with_grad32(lambda q_, k_, v_: ma.masked_attention_dropout_reference(
                q_, k_, v_, bias, dseed, MASKED_RATE, scale)),
            "library_fwd": lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias4_32, dropout_p=MASKED_RATE, scale=scale),
            "library_fwd_bwd": sdpa32(0.0),
            "library_fwd_bwd_rate": sdpa32(MASKED_RATE),
        }
        row["float32"] = {"ms": {name: timed_ms(fn) for name, fn in calls32.items()},
                          "bound": work_bounds(b, h, s, dh, "float32", 0 if bias is None else b * s * 4, stat_planes=2),
                          "bound_3xtf32": work_bounds(b, h, s, dh, "3xtf32", 0 if bias is None else b * s * 4,
                                                      stat_planes=2)}
        f32ms = row["float32"]["ms"]
        f32ms["plain_bwd"] = f32ms["plain_fwd_bwd"] - f32ms["plain_fwd"]
        f32ms["pair_tf32"] = f32ms["dq_tf32"] + f32ms["dkv_tf32"]
        f32ms["pair"] = f32ms["dq"] + f32ms["dkv"]
        f32ms["fwd_pair_tf32"] = f32ms["fwd_tf32"] + f32ms["pair_tf32"]
        row["float32"]["fwd_tf32_vs_cuda_core"] = f32ms["fwd"] / f32ms["fwd_tf32"]
        row["float32"]["fwd_tf32_vs_library"] = f32ms["fwd_tf32"] / f32ms["library_fwd"]
        row["float32"]["pair_tf32_vs_cuda_core"] = f32ms["pair"] / f32ms["pair_tf32"]
        # the pair alone against SDPA's forward and backward at rate 0.3,
        # and the route's forward and pair against the same
        row["float32"]["pair_tf32_vs_library_fwd_bwd_rate"] = f32ms["pair_tf32"] / f32ms["library_fwd_bwd_rate"]
        row["float32"]["fwd_pair_tf32_vs_library_fwd_bwd_rate"] = \
            f32ms["fwd_pair_tf32"] / f32ms["library_fwd_bwd_rate"]
        emit({"phase": "masked_vs_plain", **row})
        rows.append(row)

    # each forward kernel's mask, and the one-pass backward's, read back
    # against the plain Philox: float32 routes to the 3xTF32 forward, bf16
    # at dh=64 to the tensor-core one (the launch counts show which ran)
    masks = {}
    for s, b in ((104, 8), (201, 2)):
        plain = ta.dropout_keep_mask(seed + 101, b, h, s, MASKED_RATE, "cuda")
        c0 = _counts()
        mask = read_back_mask(ma, b, h, s, dh, MASKED_RATE, seed + 101, torch.float32)
        c1 = _counts()
        fwd_fused_mask = read_back_mask(ma, b, h, s, dh, MASKED_RATE, seed + 101, torch.bfloat16)
        c2 = _counts()
        bwd_mask = read_back_bwd_mask(ma, b, h, s, dh, MASKED_RATE, seed + 101)
        c3 = _counts()
        by_dv, by_dq = read_back_tf32_pair_masks(ma, b, h, s, dh, MASKED_RATE, seed + 101)
        masks[str(s)] = {"B": b, "equals_plain_philox": bool(torch.equal(mask, plain)),
                         "fwd_fused_equals_plain_philox": bool(torch.equal(fwd_fused_mask, plain)),
                         "bwd_fused_equals_plain_philox": bool(torch.equal(bwd_mask, plain)),
                         "tf32_pair_equals_plain_philox": {"dkv_kernel": bool(torch.equal(by_dv, plain)),
                                                           "dq_kernel": bool(torch.equal(by_dq, plain))},
                         "launches_float32": dict(zip(KERNEL_NAMES, (y - x for x, y in zip(c0, c1)))),
                         "launches_bfloat16": dict(zip(KERNEL_NAMES, (y - x for x, y in zip(c1, c2)))),
                         "launches_tf32_pair": dict(zip(KERNEL_NAMES, (y - x for x, y in zip(c3, _counts())))),
                         "kept_fraction": mask.float().mean().item()}
    # and the 3xTF32 forward's past S = 256
    s, b = MASKED_LONG[2], 2
    c0 = _counts()
    mask = read_back_mask(ma, b, h, s, dh, MASKED_RATE, seed + 102, torch.float32)
    masks[str(s)] = {"B": b, "equals_plain_philox": bool(torch.equal(mask, ta.dropout_keep_mask(
                         seed + 102, b, h, s, MASKED_RATE, "cuda"))),
                     "launches_float32": dict(zip(KERNEL_NAMES, (y - x for x, y in zip(c0, _counts())))),
                     "kept_fraction": mask.float().mean().item()}
    emit({"phase": "masked_dropout_mask", "H": h, "rate": MASKED_RATE, "by_S": masks})
    forwards = ("masked_attention_fwd", "masked_attention_fwd_fused", "masked_attention_fwd_tf32")
    for s, m in masks.items():
        chunks = -(-int(s) // dh)
        read = tuple(m["launches_float32"][n] for n in forwards)
        if "launches_bfloat16" in m:
            read += tuple(m["launches_bfloat16"][n] for n in forwards)
        if read != ((0, 0, chunks) + ((0, chunks, 0) if "launches_bfloat16" in m else ())):
            raise AssertionError(f"masked mask read-back took the wrong forward kernel: {masks}")
        if not all(m.get(key, True) for key in ("equals_plain_philox", "fwd_fused_equals_plain_philox",
                                                 "bwd_fused_equals_plain_philox")) \
                or not all(m.get("tf32_pair_equals_plain_philox", {}).values()) \
                or abs(m["kept_fraction"] - (1 - MASKED_RATE)) > 0.02:
            raise AssertionError(f"masked kernel mask: {masks}")
        if "launches_tf32_pair" in m and any(
                m["launches_tf32_pair"][n] != (2 * chunks if n in MASKED_ROUTE_LAUNCHES["tf32"] else 0)
                for n in KERNEL_NAMES):
            raise AssertionError(f"masked 3xTF32 pair mask read-back took the wrong kernels: {masks}")
    return rows


# the dense-bias kernel: the canonical node buckets at the batch sizes a
# scoring (16) and a training (12) batch give, and single big discussions
BIASED_SHAPES = ((33, 16), (33, 12), (129, 12), (257, 4), (601, 1), (1025, 1))


def key_padding_mask(batch):
    """(B, S) bool, True = pad: the graph token's key is always open."""
    import torch

    grid = batch["grid_mask"]
    return torch.cat([grid.new_zeros(grid.shape[0], 1), ~grid], dim=1)


def dense_biases(batch, dt, seed: int):
    """{"head": (B, H, S, S), "shared": (B, 1, S, S), "none": None} in ``dt``
    from the port's ``GraphAttnBias.forward`` on the collated template (its
    -inf entries included), with N(0, 1) bucket and virtual-distance tables;
    the shared bias is head 0's plane."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
    from multimodaldiscussiontransformer_tpu_torch.models.graphormer import GraphAttnBias

    mod = GraphAttnBias(ModelConfig(), dt).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(generator=gen)
        dense = mod(batch["attn_bias"], batch["spatial_pos"])
    return {"head": dense, "shared": dense[:, :1].contiguous(), "none": None}


# the forward kernel each dense-bias route launches
BIASED_ROUTE_KERNEL = {"tensor_core": "biased_attention_fwd_fused", "tf32": "biased_attention_fwd_tf32",
                       "cuda_core": "biased_attention_fwd"}


def phase_biased(seed: int):
    """The routed dense-bias forward kernels and the Function's gradients
    against the plain version, the CUDA-core kernel's output beside the
    routed one's (bf16 and float32), and a bf16 DH-16 call through the
    CUDA-core route; times of the three kernels beside the unfused dense
    branch and SDPA, in bf16 and (the 3xTF32 and the CUDA-core kernel) in
    float32."""
    import torch
    import torch.nn.functional as F

    from multimodaldiscussiontransformer_tpu_torch.data.collator import to_tensors
    from multimodaldiscussiontransformer_tpu_torch.ops.biased_attention import (
        MASK_BIAS, biased_attention, biased_attention_fwd, biased_attention_fwd_fused, biased_attention_fwd_tf32,
        biased_attention_reference, combined_bias, kernel_route,
    )

    h, dh = 12, 64
    scale = dh ** -0.5
    rows = []

    def fwd_and_grads(fn, q, k, v, bias, kpm, g):
        leaves = [None if x is None else x.detach().clone().requires_grad_(True) for x in (q, k, v, bias)]
        out = fn(*leaves, kpm)
        out.backward(g)
        return [out.detach()] + [None if x is None else x.grad for x in leaves]

    for s, b in BIASED_SHAPES:
        batch = to_tensors(graph_batch(s, b, seed + 3 * s + b), "cuda")
        kpm = key_padding_mask(batch)
        gen = torch.Generator(device="cuda").manual_seed(seed + 5 * s + b)
        q, k, v, g = (torch.randn(b, h, s, dh, device="cuda", generator=gen) for _ in range(4))
        row = {"S": s, "B": b, "H": h, "dh": dh, "padded_keys": int(kpm.sum()),
               "kernel_route": {n: kernel_route(getattr(torch, n), dh) for n in ("float32", "bfloat16")},
               "errors": {"float32": {}, "bfloat16": {}, "float32_cuda_core": {}, "bfloat16_cuda_core": {}}}
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            biases = dense_biases(batch, dt, seed + s)
            if name == "bfloat16":  # the tensor-core kernel reads a float32 bias too
                biases["head_float32_bias"] = biases["head"].float()
            qq, kk, vv, gg = (x.to(dt).contiguous() for x in (q, k, v, g))
            routed = BIASED_ROUTE_KERNEL[row["kernel_route"][name]]
            for kind, bias in biases.items():
                c0 = _counts()
                got = fwd_and_grads(biased_attention, qq, kk, vv, bias, kpm, gg)
                launched = {n: y - x for n, x, y in zip(KERNEL_NAMES, c0, _counts()) if y != x}
                want = fwd_and_grads(biased_attention_reference, qq, kk, vv, bias, kpm, gg)
                torch.cuda.synchronize()
                what = f"dense-bias kernel disagrees at S={s} B={b} {kind} bias {name}"
                if launched != {routed: 1}:
                    raise AssertionError(f"{what}: launched {launched}, expected one {routed}")
                err = (got[0].float() - want[0].float()).abs()
                ref_max = want[0].float().abs().max().item()
                if name == "float32":  # the 3xTF32 kernel
                    ok = bool((err <= F32_ATOL).all())
                else:  # the tensor-core kernel, its bf16 P included
                    ok = err.max().item() <= TRAIN_BF16_REL * ref_max
                if not (ok and torch.isfinite(got[0]).all()):
                    raise AssertionError(f"{what}: max err {err.max().item()} (max |ref| {ref_max})")
                pairs = [(n, a, w) for n, a, w in zip(("dq", "dk", "dv", "dbias"), got[1:], want[1:]) if w is not None]
                errs = _check_errors([a for _, a, _ in pairs], [w for _, _, w in pairs], [n for n, _, _ in pairs],
                                     TRAIN_F32_REL if name == "float32" else TRAIN_BF16_REL, what)
                row["errors"][name][kind] = {"out": err.max().item(), "out_max_abs_ref": ref_max, **errs}
                # the CUDA-core kernel on the same inputs, through its own
                # wrapper: f32 arithmetic, so within F32_ATOL in float32
                # and within one bf16 step elementwise in bf16
                cuda_core = biased_attention_fwd(qq, kk, vv, bias, kpm, scale)
                torch.cuda.synchronize()
                err = (cuda_core.float() - want[0].float()).abs()
                tol = F32_ATOL if name == "float32" else BF16_ATOL + BF16_RTOL * want[0].float().abs()
                if not (bool((err <= tol).all()) and torch.isfinite(cuda_core).all()):
                    raise AssertionError(f"CUDA-core dense-bias kernel disagrees at S={s} B={b} {kind} bias {name}: "
                                         f"max err {err.max().item()}")
                row["errors"][f"{name}_cuda_core"][kind] = {"out": err.max().item()}

        # times in the main path's type, with the per-head bias the graph
        # layers give
        biases = dense_biases(batch, torch.bfloat16, seed + s)
        bias, shared = biases["head"], biases["shared"]
        bias32 = bias.float()
        qq, kk, vv, gg = (x.to(torch.bfloat16).contiguous() for x in (q, k, v, g))
        combined = combined_bias(qq, bias, kpm).to(torch.bfloat16)

        def unfused(q_, k_, v_, b_):
            # the graph layer's plain dense branch (models/graphormer.py)
            scores = torch.matmul(q_ * scale, k_.transpose(-1, -2)) + b_
            scores = scores.masked_fill(kpm[:, None, None, :], MASK_BIAS)
            return torch.matmul(torch.softmax(scores.float(), dim=-1).to(q_.dtype), v_)

        def with_grad(fn, inputs, g_=gg):
            def run():
                leaves = [x.detach().requires_grad_(True) for x in inputs]
                fn(*leaves).backward(g_)
            return run

        calls = {
            "fwd": lambda: biased_attention_fwd_fused(qq, kk, vv, bias, kpm, scale),
            "fwd_cuda_core": lambda: biased_attention_fwd(qq, kk, vv, bias, kpm, scale),
            "fwd_shared": lambda: biased_attention_fwd_fused(qq, kk, vv, shared, kpm, scale),
            "fwd_shared_cuda_core": lambda: biased_attention_fwd(qq, kk, vv, shared, kpm, scale),
            "fwd_no_bias": lambda: biased_attention_fwd_fused(qq, kk, vv, None, kpm, scale),
            "fwd_no_bias_cuda_core": lambda: biased_attention_fwd(qq, kk, vv, None, kpm, scale),
            "fwd_float32_bias": lambda: biased_attention_fwd_fused(qq, kk, vv, bias32, kpm, scale),
            "plain_fwd": lambda: biased_attention_reference(qq, kk, vv, bias, kpm, scale),
            "unfused_fwd": lambda: unfused(qq, kk, vv, bias),
            "library_fwd": lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=combined, scale=scale),
            "fwd_bwd": with_grad(lambda q_, k_, v_, b_: biased_attention(q_, k_, v_, b_, kpm, scale),
                                 (qq, kk, vv, bias)),
            "unfused_fwd_bwd": with_grad(unfused, (qq, kk, vv, bias)),
            "library_fwd_bwd": with_grad(lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=combined, scale=scale), (qq, kk, vv)),
        }
        row["ms"] = {name: timed_ms(fn) for name, fn in calls.items()}
        # the bf16 bias (per head, or shared) and the (B, S) bool pad mask
        row["bound_ms"], row["bound_by"] = bound(b, h, s, dh, "bfloat16", b * h * s * s * 2 + b * s)
        row["bound_shared_ms"] = bound(b, h, s, dh, "bfloat16", b * s * s * 2 + b * s)[0]
        row["fwd_vs_cuda_core"] = row["ms"]["fwd_cuda_core"] / row["ms"]["fwd"]
        row["fwd_vs_library"] = row["ms"]["fwd"] / row["ms"]["library_fwd"]
        # the float32 route (the 3xTF32 kernel) on float32 inputs with the
        # float32 per-head bias, the CUDA-core kernel it replaces there and
        # SDPA on the same inputs, and the bounds: float32 on CUDA cores,
        # and 3xTF32
        combined32 = combined_bias(q, bias32, kpm)
        row["float32"] = {"ms": {
            "fwd_tf32": timed_ms(lambda: biased_attention_fwd_tf32(q, k, v, bias32, kpm, scale)),
            "fwd_cuda_core": timed_ms(lambda: biased_attention_fwd(q, k, v, bias32, kpm, scale)),
            "plain_fwd": timed_ms(lambda: biased_attention_reference(q, k, v, bias32, kpm, scale)),
            "library_fwd": timed_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=combined32, scale=scale)),
        }}
        row["float32"]["bound"] = {"fwd": bound(b, h, s, dh, "float32", b * h * s * s * 4 + b * s)}
        row["float32"]["bound_3xtf32"] = {"fwd": bound(b, h, s, dh, "3xtf32", b * h * s * s * 4 + b * s)}
        f32ms = row["float32"]["ms"]
        row["float32"]["fwd_tf32_vs_cuda_core"] = f32ms["fwd_cuda_core"] / f32ms["fwd_tf32"]
        row["float32"]["fwd_tf32_vs_library"] = f32ms["fwd_tf32"] / f32ms["library_fwd"]
        row["tolerance"] = {"float32_atol": F32_ATOL, "bfloat16_rel_of_max": TRAIN_BF16_REL,
                            "bfloat16_cuda_core_rtol": BF16_RTOL, "bfloat16_cuda_core_atol": BF16_ATOL,
                            "grad_rel_float32": TRAIN_F32_REL, "grad_rel_bfloat16": TRAIN_BF16_REL}
        emit({"phase": "biased_vs_plain", **row})
        rows.append(row)

    # bf16 at DH 16 through biased_attention: the "cuda_core" route, the one
    # path that launches the CUDA-core forward (at the canonical training
    # shape, every bias kind)
    s, b, dh16 = BIASED_SHAPES[1][0], BIASED_SHAPES[1][1], 16
    batch = to_tensors(graph_batch(s, b, seed + 7), "cuda")
    kpm = key_padding_mask(batch)
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    q, k, v, g = (torch.randn(b, h, s, dh16, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(4))
    dh16_row = {"S": s, "B": b, "H": h, "dh": dh16, "dtype": "bfloat16", "kernel_route": kernel_route(torch.bfloat16, dh16),
                "errors": {}, "launches": dict.fromkeys(KERNEL_NAMES, 0)}
    for kind, bias in dense_biases(batch, torch.bfloat16, seed + 16).items():
        c0 = _counts()
        got = fwd_and_grads(biased_attention, q, k, v, bias, kpm, g)
        for n, x, y in zip(KERNEL_NAMES, c0, _counts()):
            dh16_row["launches"][n] += y - x
        want = fwd_and_grads(biased_attention_reference, q, k, v, bias, kpm, g)
        torch.cuda.synchronize()
        err = (got[0].float() - want[0].float()).abs()
        if not (bool((err <= BF16_ATOL + BF16_RTOL * want[0].float().abs()).all()) and torch.isfinite(got[0]).all()):
            raise AssertionError(f"dense-bias DH-16 bf16 call disagrees with {kind} bias: max err {err.max().item()}")
        pairs = [(n, a, w) for n, a, w in zip(("dq", "dk", "dv", "dbias"), got[1:], want[1:]) if w is not None]
        dh16_row["errors"][kind] = {"out": err.max().item(), **_check_errors(
            [a for _, a, _ in pairs], [w for _, _, w in pairs], [n for n, _, _ in pairs], TRAIN_BF16_REL,
            f"dense-bias DH-16 bf16 gradients with {kind} bias")}
    want_launches = {**dict.fromkeys(KERNEL_NAMES, 0), "biased_attention_fwd": 3}
    # the CUDA-core forward's one route now, timed beside SDPA in bf16 (the
    # per-head bias with the pad mask folded in) and the bf16 bound
    bias = dense_biases(batch, torch.bfloat16, seed + 16)["head"]
    mask = combined_bias(q, bias, kpm).to(torch.bfloat16)
    dh16_row["ms"] = {
        "fwd_cuda_core": timed_ms(lambda: biased_attention_fwd(q, k, v, bias, kpm, dh16 ** -0.5)),
        "library_fwd": timed_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=dh16 ** -0.5))}
    dh16_row["bound"] = bound(b, h, s, dh16, "bfloat16", bias.numel() * bias.element_size() + kpm.numel())
    emit({"phase": "biased_vs_plain_dh16", **dh16_row})
    if dh16_row["kernel_route"] != "cuda_core" or dh16_row["launches"] != want_launches:
        raise AssertionError(f"dense-bias DH-16 bf16 calls launched {dh16_row['launches']}, expected {want_launches}")
    return rows, dh16_row


def dense_graph_path(cfg, generator=None):
    """The slice's path from the port's graph modules: ``GraphNodeFeature``
    -> dense ``GraphAttnBias`` -> the config's live graph stacks (5 of 2
    layers for ``ModelConfig()``), with ``init_weights`` from ``generator``
    (float32 parameters, compute in ``cfg.dtype``)."""
    import torch
    from torch import nn

    from multimodaldiscussiontransformer_tpu_torch.models.graphormer import (
        GraphAttnBias, GraphEncoderStack, GraphNodeFeature,
    )
    from multimodaldiscussiontransformer_tpu_torch.models.mdt import init_weights

    class DenseGraphPath(nn.Module):
        def __init__(self):
            super().__init__()
            dt = getattr(torch, cfg.dtype)
            self.config = cfg
            self.graph_node_feature = GraphNodeFeature(cfg, dt)
            self.graph_attn_bias = GraphAttnBias(cfg, dt)
            n_stacks = graph_layers(cfg)[0] // cfg.num_graph_stack
            self.stacks = nn.ModuleList(GraphEncoderStack(cfg, cfg.num_graph_stack, dt) for _ in range(n_stacks))

        def forward(self, batch, x, deterministic: bool = True):
            h = self.graph_node_feature(x, batch["in_degree"], batch["out_degree"])
            bias = self.graph_attn_bias(batch["attn_bias"], batch["spatial_pos"])
            kpm = key_padding_mask(batch)
            for stack in self.stacks:
                h = stack(h, bias, kpm, deterministic)
            return h

    path = DenseGraphPath()
    init_weights(path, generator if generator is not None else torch.Generator().manual_seed(0))
    return path


# dense_graph: the fused path against the unfused one in bfloat16, on the
# layer-normed node states (|x| up to ~4) of 10 post-LN layers. The unfused
# branch rounds the scores, the probabilities and the product to bf16 in
# every layer and the fused op rounds only its output, so the two differ by
# bf16 noise (2^-8 relative per rounding) carried through the stack: a few
# hundredths; 0.25 is some 16 bf16 steps of a state of 4
DENSE_BF16_ATOL = 0.25
DENSE_TRAIN_STEPS = 3


def profile_step(fn):
    """Where one call's device time goes: wall ms (synced), device ms,
    busy share, the dense-bias kernel's ms and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "device_busy_share": dev_ms / wall_ms,
            "biased_attention_ms": sum(e.self_device_time_total for e in events if "biased_attention" in e.key) / 1e3,
            "device_ops": sum(e.count for e in events),
            "top_kernels": [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count}
                            for e in events[:8]]}


def phase_dense_graph(seed: int):
    """GraphNodeFeature -> dense GraphAttnBias -> 5 graph stacks of 2 layers
    at ``ModelConfig()`` width with the fused dense-bias branch: scoring
    (deterministic) and training (attention dropout 0, dropout 0.4 / 0.3,
    AdamW) on S = 33 batches and one ~900-node discussion."""
    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig, OptimConfig, tiny_model_config
    from multimodaldiscussiontransformer_tpu_torch.data.collator import to_tensors
    from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import dropout_rngs
    from multimodaldiscussiontransformer_tpu_torch.train.optimizer import make_optimizer

    cfg = ModelConfig()
    per_forward = graph_layers(cfg)[0]
    if per_forward != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"the path runs {per_forward} graph layers, expected {LAUNCHES_PER_FORWARD}")
    path = dense_graph_path(cfg, torch.Generator().manual_seed(seed)).cuda().eval()
    state = {k: v.clone() for k, v in path.state_dict().items()}

    def inputs(s, b, salt):
        batch = to_tensors(graph_batch(s, b, seed + salt), "cuda")
        gen = torch.Generator().manual_seed(seed + salt)
        x = torch.randn(b, s - 1, cfg.encoder_embed_dim, generator=gen).cuda().to(torch.bfloat16)
        return batch, x

    scoring = {"S33_B16": inputs(33, 16, 1), "S901_B1": inputs(901, 1, 2)}
    with torch.no_grad():
        for batch, x in scoring.values():  # warm-up, outside the counted run
            path(batch, x)
        torch.cuda.synchronize()
        _zero_counts()
        outs = {name: path(batch, x) for name, (batch, x) in scoring.items()}
        torch.cuda.synchronize()
        counts = dict(zip(KERNEL_NAMES, _counts()))
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["biased_attention_fwd_fused"] = per_forward * len(scoring)  # bf16: the tensor-core forward
    if counts != want:
        raise AssertionError(f"dense-graph scoring launches {counts}, expected {want}")

    unfused = dense_graph_path(cfg.replace(use_pallas_attention=False)).cuda().eval()
    unfused.load_state_dict(state)
    score_rows = {}
    with torch.no_grad():
        for name, (batch, x) in scoring.items():
            out = outs[name]
            if out.shape != (x.shape[0], x.shape[1] + 1, cfg.encoder_embed_dim) or not torch.isfinite(out).all():
                raise AssertionError(f"dense-graph scoring {name}: bad output {tuple(out.shape)}")
            ref = unfused(batch, x)
            err = (out.float() - ref.float()).abs().max().item()
            score_rows[name] = {
                "S": x.shape[1] + 1, "B": x.shape[0], "max_abs_err_vs_unfused_bf16": err,
                "max_abs_unfused": ref.float().abs().max().item(),
                "forward_ms": time_cuda(lambda: path(batch, x), 10),
                "unfused_forward_ms": time_cuda(lambda: unfused(batch, x), 10),
            }
            if not err <= DENSE_BF16_ATOL:
                raise AssertionError(f"dense-graph fused bf16 states differ from the unfused ones by {err}")

        # float32: the fused path on the card (TF32 off) against the CPU
        batch, _ = scoring["S33_B16"]
        x32 = torch.randn(16, 32, cfg.encoder_embed_dim, generator=torch.Generator().manual_seed(seed))
        out32 = {}
        for dev in ("cuda", "cpu"):
            p32 = dense_graph_path(cfg.replace(dtype="float32")).to(dev).eval()
            p32.load_state_dict(state)
            out32[dev] = p32({k: v.to(dev) for k, v in batch.items()}, x32.to(dev)).cpu()
            del p32
    err32 = (out32["cuda"] - out32["cpu"]).abs().max().item()
    del unfused
    if not err32 <= MODEL_ATOL:
        raise AssertionError(f"dense-graph float32 card states differ from the CPU's by {err32}")

    # training: attention dropout 0 (the fused branch), dropout 0.4 / 0.3,
    # a fixed random cotangent as the loss, AdamW from train/optimizer.py
    tcfg = cfg.replace(attention_dropout=0.0)
    tpath = dense_graph_path(tcfg).cuda().train()
    tpath.load_state_dict(state)
    params = list(tpath.parameters())
    opt = make_optimizer(OptimConfig(), params)
    host, device = torch.Generator().manual_seed(seed), torch.Generator(device="cuda").manual_seed(seed)
    training = {"S33_B12": inputs(33, 12, 3), "S901_B1": inputs(901, 1, 4)}
    cots = {name: torch.randn(x.shape[0], x.shape[1] + 1, cfg.encoder_embed_dim, device="cuda", generator=device)
            for name, (_, x) in training.items()}
    bias_table_names = ("graph_attn_bias.spatial_pos_encoder", "graph_attn_bias.graph_token_virtual_distance")

    def step(name):
        batch, x = training[name]
        opt.zero_grad(set_to_none=True)
        with dropout_rngs(host, device):
            out = tpath(batch, x, deterministic=False)
        loss = (out.float() * cots[name]).sum()
        loss.backward()
        opt.step()
        return loss.item()

    for name in training:  # warm-up, outside the counted run
        step(name)
    before = {k: v.detach().clone() for k, v in tpath.state_dict().items()}
    train_rows = {name: {"S": x.shape[1] + 1, "B": x.shape[0], "step_ms": [], "peak_gb": [], "loss": []}
                  for name, (_, x) in training.items()}
    torch.cuda.synchronize()
    _zero_counts()
    for name in training:
        for _ in range(DENSE_TRAIN_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loss = step(name)
            torch.cuda.synchronize()
            train_rows[name]["step_ms"].append((time.perf_counter() - t) * 1e3)
            train_rows[name]["peak_gb"].append(torch.cuda.max_memory_allocated() / 2**30)
            train_rows[name]["loss"].append(loss)
        grads = dict(tpath.named_parameters())
        train_rows[name]["bias_table_grad_max"] = {n: grads[n].grad.abs().max().item() for n in bias_table_names}
        for n in bias_table_names:
            gr = grads[n].grad
            if gr is None or not torch.isfinite(gr).all() or not gr.any():
                raise AssertionError(f"dense-graph training {name}: no finite nonzero gradient reaches {n}")
    train_counts = dict(zip(KERNEL_NAMES, _counts()))
    steps = DENSE_TRAIN_STEPS * len(training)
    trace = {name: profile_step(lambda: step(name)) for name in training}
    want_train = dict.fromkeys(KERNEL_NAMES, 0)
    want_train["biased_attention_fwd_fused"] = per_forward * steps
    if train_counts != want_train:
        raise AssertionError(f"dense-graph training launches {train_counts}, expected {want_train}")
    # a tensor whose gradient is 0 (k_proj's bias: softmax ignores a
    # constant added to a row's scores) moves only by weight decay
    after = tpath.state_dict()
    unchanged = [k for k in before if torch.equal(before[k], after[k]) and grads[k].grad.any()]
    losses = [x for r in train_rows.values() for x in r["loss"]]
    if unchanged or not np.isfinite(losses).all():
        raise AssertionError(f"dense-graph training: unchanged {unchanged[:5]}, losses {losses}")
    del tpath, opt, before, after, grads
    torch.cuda.empty_cache()

    # one tiny float32 step with every dropout at 0 (deterministic=False,
    # attention dropout 0: the fused branch), card against CPU
    tiny = tiny_model_config(dropout=0.0, attention_dropout=0.0, act_dropout=0.0)
    tiny_state = dense_graph_path(tiny, torch.Generator().manual_seed(seed + 5)).state_dict()
    tb = to_tensors(graph_batch(9, 4, seed + 6), "cpu")
    tx = torch.randn(4, 8, tiny.encoder_embed_dim, generator=torch.Generator().manual_seed(seed + 7))
    tcot = torch.randn(4, 9, tiny.encoder_embed_dim, generator=torch.Generator().manual_seed(seed + 8))
    # the loss is a mean, as the node loss is, so that the gradients have
    # the scale train_cpu_agreement's tolerance was set for
    tiny_grads, tiny_launches = {}, {}
    for dev in ("cpu", "cuda"):
        p = dense_graph_path(tiny).to(dev).train()
        p.load_state_dict(tiny_state)
        torch.cuda.synchronize()
        _zero_counts()
        with dropout_rngs(torch.Generator().manual_seed(0), torch.Generator(device=dev).manual_seed(0)):
            out = p({k: v.to(dev) for k, v in tb.items()}, tx.to(dev), deterministic=False)
        (out * tcot.to(dev)).mean().backward()
        torch.cuda.synchronize()
        tiny_launches[dev] = dict(zip(KERNEL_NAMES, _counts()))
        tiny_grads[dev] = {n: q.grad.cpu() for n, q in p.named_parameters()}
    bad, tiny_err = [], 0.0
    for n, gc in tiny_grads["cpu"].items():
        e = (tiny_grads["cuda"][n] - gc).abs()
        tiny_err = max(tiny_err, e.max().item())
        if not (e <= AGREE_GRAD_ATOL + AGREE_GRAD_RTOL * gc.abs()).all():
            bad.append((n, e.max().item()))
    tiny_layers = graph_layers(tiny)[0]
    emit({"phase": "dense_graph",
          "config": "ModelConfig() graph path (GraphNodeFeature -> dense GraphAttnBias -> 5 graph stacks of 2 "
                    "layers), d=768, 12 heads, bfloat16 compute over float32 params, use_pallas_attention",
          "scoring": score_rows, "scoring_launches": counts, "launches_per_forward": per_forward,
          "bf16_atol_vs_unfused": DENSE_BF16_ATOL, "max_abs_err_f32_vs_cpu": err32, "f32_atol": MODEL_ATOL,
          "training": {name: {**r, "step_ms_median": float(np.median(r["step_ms"]))} for name, r in train_rows.items()},
          "training_config": "attention_dropout 0, dropout 0.4, act_dropout 0.3, OptimConfig() AdamW, "
                             "loss = sum(out * fixed random cotangent)",
          "training_launches": train_counts,
          "trace": trace,
          "tiny_f32_step": {"max_abs_err_grad": tiny_err, "grad_rtol": AGREE_GRAD_RTOL, "grad_atol": AGREE_GRAD_ATOL,
                            "max_abs_grad": max(g.abs().max().item() for g in tiny_grads["cpu"].values()),
                            "card_launches": tiny_launches["cuda"],
                            "cpu_launches": sum(tiny_launches["cpu"].values())}})
    # float32: the 3xTF32 forward in every graph layer, nothing else
    want_tiny = {**dict.fromkeys(KERNEL_NAMES, 0), "biased_attention_fwd_tf32": tiny_layers}
    if bad or tiny_launches["cuda"] != want_tiny or any(tiny_launches["cpu"].values()):
        raise AssertionError(f"tiny dense-graph step: card and CPU gradients disagree {bad[:5]}; launches {tiny_launches}")
    return {"scoring": counts, "training": train_counts, "float32_step": tiny_launches["cuda"]}


def graph_layers(mc, contrastive: bool = False):
    """(graph layers a forward runs, graph layers whose backward the loss
    reaches). The final graph stack feeds only the global embedding, which
    the node loss does not read, so under the node loss autograd never runs
    its backward (nor that of the stack the reference skips, where it is
    run); the contrastive loss reads only the global embedding, so every
    graph layer a forward runs has its backward."""
    fwd = mc.num_graph_stack * (mc.num_fusion_stacks + (0 if mc.reproduce_dead_graph_stack else 1))
    return fwd, fwd if contrastive else mc.num_graph_stack * (mc.num_fusion_stacks - 1)


def expected_launches(mc, fused: bool, k: int, images: bool, text_len: int, contrastive: bool = False):
    """Launches of every kernel (KERNEL_NAMES order) in one update of k
    microbatches of ``text_len``-token text, from the config (the
    contrastive loss's backward reaches every graph layer). Each tower
    layer's forward takes the tensor-core, the 3xTF32 or the CUDA-core
    kernel, and each tower's backward the one-pass kernel or the pair, as
    ``kernel_route`` says for the compute dtype, the tower's head dim and
    the layer's length (the backward runs in the fusion layers: tokens +
    bottleneck). The graph layers take the tensor-core, the 3xTF32 or the
    CUDA-core tree forward and backward pair as the tree attention's
    ``kernel_route`` says for the compute dtype and the graph head dim.
    Under ``mc.remat`` the backward
    reruns the forward of every graph layer whose backward runs and of
    every fusion layer's towers (the bottom towers stay outside remat)."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
    from multimodaldiscussiontransformer_tpu_torch.ops.masked_attention import kernel_route

    fwd, bwd = graph_layers(mc, contrastive)
    route = ta.kernel_route(getattr(torch, mc.dtype), mc.encoder_embed_dim // mc.encoder_attention_heads)
    recompute = bwd if mc.remat else 0
    f, d = k * (fwd + recompute), k * bwd  # forwards; dq and dk/dv each
    # (CUDA-core fwd, dq, dkv; tensor-core fwd, dq, dkv; 3xTF32 dq, dkv, fwd)
    tree = {"tensor_core": [0, 0, 0, f, d, d, 0, 0, 0], "tf32": [0, 0, 0, 0, 0, 0, d, d, f],
            "cuda_core": [f, d, d, 0, 0, 0, 0, 0, 0]}[route]
    if not fused:
        return tree + [0] * 11
    _, _, text_bwd, vit_bwd = tower_launches(mc)
    tower_fwd = dict(zip(("cuda_core", "tensor_core", "tf32"),
                         (k * n for n in tower_forward_routes(mc, text_len, images))))
    if mc.remat:
        for tower, s in ((mc.text_tower, text_len), (mc.image_tower, mc.image_tower.seq_len))[:2 if images else 1]:
            tower_fwd[kernel_route(getattr(torch, mc.dtype), tower.head_dim, s + mc.num_bottleneck_tokens)] += \
                k * (mc.num_fusion_layers + 1)
    tower_bwd = dict.fromkeys(("cuda_core", "tensor_core", "tf32"), 0)  # the pairs' dq and dk/dv each, or one pass
    extra = mc.num_bottleneck_tokens
    for n, tower, s in ((text_bwd, mc.text_tower, text_len + extra),
                        (vit_bwd if images else 0, mc.image_tower, mc.image_tower.seq_len + extra)):
        tower_bwd[kernel_route(getattr(torch, mc.dtype), tower.head_dim, s)] += k * n
    pair, tf32_pair = tower_bwd["cuda_core"], tower_bwd["tf32"]
    # MDTModel never takes the dense-bias branch
    return tree + [tower_fwd["cuda_core"], pair, pair, tower_bwd["tensor_core"], tower_fwd["tensor_core"],
                   tower_fwd["tf32"], tf32_pair, tf32_pair, 0, 0, 0]


TRACE_UPDATES = 2


class _ProfileWindow:
    """Inside the block, the profile window of ``Trainer.fit`` (its
    ``profiling.start_trace`` / ``stop_trace`` calls) runs a
    ``torch.profiler`` session of the card's activity, kept in
    ``session`` and written nowhere, and measures the window's wall time up
    to the end of the traced work (``wall_ms``)."""

    def __enter__(self):
        import torch

        from multimodaldiscussiontransformer_tpu_torch.utils import profiling

        self._module, self._orig = profiling, (profiling.start_trace, profiling.stop_trace)

        def start(log_dir):
            # the card's activity only: tracing the host too would slow the
            # host and so lower the busy share it measures
            self.session = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self.session.start()
            self._t0 = time.perf_counter()
            return self.session

        def stop(session):
            torch.cuda.synchronize()
            self.wall_ms = (time.perf_counter() - self._t0) * 1e3
            session.stop()

        profiling.start_trace, profiling.stop_trace = start, stop
        return self

    def __exit__(self, *exc):
        self._module.start_trace, self._module.stop_trace = self._orig
        return False


def run_train(seed: int, phase: str, *, batch_size: int, fused: bool, dataset_kw: dict, timed_updates: int,
              trace: bool, card: str = ""):
    """A training run through the port's entry points: launch's flag
    resolution, NodePredictionTask.build_trainer, Trainer.fit. One untimed
    update, then ``timed_updates`` with every kernel's launches checked."""
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from multimodaldiscussiontransformer_tpu_torch.tasks.node_prediction import NodePredictionTask
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args
    from multimodaldiscussiontransformer_tpu_torch.utils.flops import train_step_flops

    tmp = tempfile.TemporaryDirectory()
    args = build_parser().parse_args([
        "--synthetic", "--freeze-initial-encoders", "--no-save", "--batch-size", str(batch_size), "--update-freq", "3",
        "--positive-weight", "1.5", "--seed", str(seed + 1), "--validate-interval-updates", "0",
        "--log-interval", "1", "--save-dir", tmp.name,
    ])
    cfg = config_from_args(args)
    if fused:  # no launcher flag turns the tower kernels on, as in the JAX package
        cfg = dataclasses.replace(cfg, model=fused_towers(cfg.model))
    task = NodePredictionTask(cfg)
    t0 = time.perf_counter()
    ds = task.load_dataset(seed=seed + 1, seq_len=100, vocab_size=cfg.model.text_tower.vocab_size,
                           image_shape=IMAGE_SHAPE, **dataset_kw)
    data_s = time.perf_counter() - t0
    trainer = task.build_trainer(image_shape=IMAGE_SHAPE, device="cuda")
    t0 = time.perf_counter()
    state = trainer.init_state()
    init_s = time.perf_counter() - t0
    mc = cfg.model
    if graph_layers(mc)[0] != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"the config runs {graph_layers(mc)[0]} graph layers, expected {LAUNCHES_PER_FORWARD}")
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}

    records = []
    inner = trainer.train_step

    def timed(state_, group, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0, start = _counts(), time.perf_counter()
        logs = inner(state_, group, **kw)
        torch.cuda.synchronize()
        end = time.perf_counter()
        k = group["idx"].shape[0]
        flops = k * train_step_flops(
            mc, batch=group["idx"].shape[1], node_capacity=group["input_ids"].shape[1],
            image_capacity=group["images"].shape[1], seq_len=group["input_ids"].shape[2],
            max_nodes=group["in_degree"].shape[2])["train_total"]
        records.append({
            "start": start, "end": end, "launches": [a - b for a, b in zip(_counts(), c0)],
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "want": expected_launches(mc, fused, k, group["images"].shape[1] > 0, group["input_ids"].shape[2]),
            "loss": float(logs["loss"]) / max(float(logs["sample_size"]), 1.0), "gnorm": float(logs["gnorm"]),
            "graphs": int((group["idx"] >= 0).sum()), "flops": flops,
            # what the prefetch thread sent to the card for this update
            "h2d_bytes": sum(v.numel() * v.element_size() for v in group.values()),
            "shapes": {"S": int(group["in_degree"].shape[2]) + 1, "C": int(group["input_ids"].shape[1]),
                       "T": int(group["input_ids"].shape[2]), "I": int(group["images"].shape[1]),
                       "L": int(group["y"].shape[1])},
        })
        return logs

    trainer.train_step = timed
    quiet = lambda msg: None  # noqa: E731
    state = trainer.fit(ds, state=state, max_updates=1, log_fn=quiet)  # untimed: warm-up
    warm = records.pop()
    _zero_counts()
    t0 = time.perf_counter()
    state = trainer.fit(ds, state=state, max_updates=1 + timed_updates, log_fn=quiet)
    fit_s = time.perf_counter() - t0
    launches = _counts()
    trainer.train_step = inner
    input_wait_ms = [w * 1e3 for w in trainer.input_waits]

    if len(records) != timed_updates:
        raise AssertionError(f"{phase}: {len(records)} timed updates, expected {timed_updates}")
    bad = [(r["launches"], r["want"]) for r in records if r["launches"] != r["want"]]
    total_want = [sum(col) for col in zip(*(r["want"] for r in records))]
    if bad or launches != total_want:
        raise AssertionError(f"{phase}: kernel launches per update (got, expected) {bad}; run {launches} vs {total_want}")
    by_name = dict(zip(KERNEL_NAMES, launches))
    if any(by_name[n] for n in TREE_NOT_BF16) or not all(by_name[n] for n in TREE_TENSOR_CORE):
        raise AssertionError(f"{phase}: bf16 graph layers must take the tensor-core tree kernels only: {by_name}")
    if fused and not (by_name["masked_attention_fwd_fused"] and by_name["masked_attention_bwd_fused"]):
        raise AssertionError(f"{phase}: a tensor-core tower kernel never launched: {by_name}")
    cuda_core = {n: by_name[n] for n in ("masked_attention_fwd", "masked_attention_bwd_dq", "masked_attention_bwd_dkv")}
    if any(cuda_core.values()):  # bf16 at the tower shapes: the "tensor_core" route only
        raise AssertionError(f"{phase}: a CUDA-core tower kernel launched in bf16: {cuda_core}")
    losses = [r["loss"] for r in records]
    if not all(np.isfinite(losses)) or len(set(losses)) < 2:
        raise AssertionError(f"{phase}: loss series not finite or constant: {losses}")

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
        raise AssertionError(f"{phase}: frozen tensors changed: {frozen_moved[:5]}; trainable tensors unchanged: {trainable_still[:5]}")

    step_ms = [(r["end"] - r["start"]) * 1e3 for r in records]
    gaps_ms = [(b["start"] - a["end"]) * 1e3 for a, b in zip(records, records[1:])]
    mfu = [r["flops"] / (r["end"] - r["start"]) / H100_BF16_PEAK for r in records]
    graphs = sum(r["graphs"] for r in records)
    emit({
        "phase": phase, "card": card,
        "config": f"ModelConfig(){' with both towers fused' if fused else ''} (launch flags: "
                                  f"--freeze-initial-encoders, batch {batch_size} x update_freq 3, dropout 0.4/0.3/0.3), "
                                  "bfloat16 compute, float32 params",
        "dataset": dataset_kw, "data_seconds": data_s, "init_seconds": init_s,
        "warmup_update_ms": (warm["end"] - warm["start"]) * 1e3,
        "timed_updates": timed_updates, "update_ms_median": float(np.median(step_ms)), "update_ms": step_ms,
        "host_batch_ms_median": float(np.median(gaps_ms)) if gaps_ms else None,
        "input_wait_ms": input_wait_ms, "input_wait_ms_median": float(np.median(input_wait_ms)),
        "h2d_bytes_per_update": [r["h2d_bytes"] for r in records],
        "fit_seconds": fit_s, "discussions_per_sec": graphs / fit_s,
        "discussions_per_sec_device_loop": graphs / (sum(step_ms) / 1e3),
        "mfu_median": float(np.median(mfu)), "peak_flops_assumed": H100_BF16_PEAK,
        "flops_per_update": [r["flops"] for r in records],
        "loss": losses, "gnorm": [r["gnorm"] for r in records], "shapes": [r["shapes"] for r in records],
        "S_seen": sorted({r["shapes"]["S"] for r in records}),
        "launches_per_update": [dict(zip(KERNEL_NAMES, r["launches"])) for r in records],
        "launches": dict(zip(KERNEL_NAMES, launches)),
        # the statistics are reset before each update: the run's peak is
        # the largest update's
        "max_memory_allocated_gb": max(r["peak_gb"] for r in records),
        "max_memory_allocated_gb_per_update": [r["peak_gb"] for r in records],
        "frozen_tensors_unchanged": sum(k.startswith(frozen_prefixes) for k in before),
        "trainable_tensors_changed": len(trainable) - len(zero_grad),
        "trainable_tensors_with_zero_grad": sorted({k.rsplit(".layer_", 1)[0] for k in zero_grad}),
    })

    if trace:
        # where an update's device time goes on the default path: fit's own
        # profile window over TRACE_UPDATES updates, after one more update
        # that lets the prefetch thread stage ahead
        n0 = state.num_updates
        trainer.cfg = dataclasses.replace(cfg, profile_trace_dir=os.path.join(tmp.name, "trace"),
                                          profile_trace_start=n0 + 1, profile_trace_steps=TRACE_UPDATES)
        with _ProfileWindow() as window:
            state = trainer.fit(ds, state=state, max_updates=n0 + 1 + TRACE_UPDATES, log_fn=quiet)
        trainer.cfg = cfg
        prof, prof_wall_ms = window.session, window.wall_ms / TRACE_UPDATES
        # the window traces the host too: keep the device's own events (the
        # host ops' rows repeat their kernels' time)
        events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                        key=lambda e: -e.self_device_time_total)
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / TRACE_UPDATES

        def cat_ms(*keys):
            return sum(e.self_device_time_total for e in events if any(k in e.key for k in keys)) / 1e3 / TRACE_UPDATES

        top = [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3 / TRACE_UPDATES,
                "count": e.count / TRACE_UPDATES} for e in events[:15]]
        emit({
            "phase": phase + "_trace", "card": card,
            "updates_traced": TRACE_UPDATES, "through": "Trainer.fit's profile window (prefetch on); per update",
            "wall_ms": prof_wall_ms, "device_ms": dev_ms, "device_busy_share": dev_ms / prof_wall_ms,
            "device_busy_share_without_h2d": (dev_ms - cat_ms("Memcpy HtoD")) / prof_wall_ms,
            "tree_attention_ms": cat_ms("tree_attention"),
            "tree_attention_fwd_ms": cat_ms("tree_attention_fwd"),
            "tree_attention_bwd_ms": cat_ms("tree_attention_bwd"),
            "tree_attention_bwd_tensor_core_ms": cat_ms("tree_attention_bwd_dq_mma", "tree_attention_bwd_dkv_mma"),
            "masked_attention_ms": cat_ms("masked_attention"),
            "masked_attention_fwd_ms": cat_ms("masked_attention_fwd"),
            "masked_attention_bwd_ms": cat_ms("masked_attention_bwd"),
            "gemm_ms": cat_ms("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas"),
            "softmax_ms": cat_ms("softmax"),
            "adamw_ms": cat_ms("multi_tensor_apply", "adam"),
            "dropout_rng_ms": cat_ms("distribution_elementwise"),
            "cast_and_layout_copy_ms": cat_ms("copy_kernel"),
            "host_to_device_ms": cat_ms("Memcpy HtoD"),
            "device_ops": sum(e.count for e in events) / TRACE_UPDATES, "top_kernels": top,
        })
    del state, trainer, before, after, grads, ds
    tmp.cleanup()
    torch.cuda.empty_cache()
    return dict(zip(KERNEL_NAMES, launches))


WORKER_UPDATES = 4


def phase_workers(seed: int, card: str):
    """The canonical run with ``--num-workers 4`` on the train phase's
    discussions as a ``hateful_discussions`` directory (lazy npz items, as
    the reference's loader workers read them): 4 updates through
    ``Trainer.fit`` with the graphs loaded and collated in 4 spawned
    processes; the groups' ``idx`` against the in-process iterator's, the
    launches against the config's, ms per update."""
    import tempfile
    from itertools import islice

    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.data.loader import stack_microbatches
    from multimodaldiscussiontransformer_tpu_torch.tasks.node_prediction import NodePredictionTask
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args
    from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

    tmp = tempfile.TemporaryDirectory()
    data, written = shared_discussions(seed + 1)
    cfg = config_from_args(build_parser().parse_args(
        [*CANONICAL_FLAGS, "--seed", str(seed + 1), "--data-root", data, "--no-save", "--save-dir", tmp.name,
         "--num-workers", "4"]))
    task = NodePredictionTask(cfg)
    ds = task.load_dataset(root=data, split=0, seed=cfg.seed)
    trainer = task.build_trainer(image_shape=IMAGE_SHAPE, device="cuda")
    state = trainer.init_state()
    records, inner = [], trainer.train_step

    def timed(state_, group, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs = inner(state_, group, **kw)
        torch.cuda.synchronize()
        records.append({"ms": (time.perf_counter() - t) * 1e3, "idx": group["idx"].cpu().numpy(),
                        "want": expected_launches(cfg.model, False, group["idx"].shape[0], group["images"].shape[1] > 0,
                                                  group["input_ids"].shape[2])})
        return logs

    trainer.train_step = timed
    _zero_counts()
    t0 = time.perf_counter()
    state = trainer.fit(ds, state=state, max_updates=WORKER_UPDATES, log_fn=lambda m: None)
    fit_s = time.perf_counter() - t0
    launches = dict(zip(KERNEL_NAMES, _counts()))
    waits_ms = [w * 1e3 for w in trainer.input_waits]
    in_process = Trainer(dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, num_workers=0)),
                         image_shape=IMAGE_SHAPE, device="cpu")
    want_idx = [g["idx"] for g in islice(stack_microbatches(in_process.train_batches(ds, 1), 3, pad_tail=True),
                                         WORKER_UPDATES)]
    same = len(records) == WORKER_UPDATES and all(np.array_equal(r["idx"], w) for r, w in zip(records, want_idx))
    total_want = dict(zip(KERNEL_NAMES, [sum(col) for col in zip(*(r["want"] for r in records))]))
    ms = [r["ms"] for r in records]
    emit({"phase": "runtime_workers", "card": card,
          "config": "ModelConfig() (canonical launch flags, --num-workers 4: spawned loading and collation workers) "
                    "on a hateful_discussions directory of the train phase's discussions",
          "dataset": written,
          "updates": len(records), "update_ms": ms, "update_ms_median": float(np.median(ms)),
          "input_wait_ms": waits_ms, "fit_seconds": fit_s, "fit_ms_per_update": fit_s * 1e3 / max(len(records), 1),
          "idx_equal_in_process": same, "launches": launches})
    if not same or launches != total_want:
        raise AssertionError(f"runtime_workers: groups equal {same}; launches {launches} vs {total_want}")
    del state, trainer
    tmp.cleanup()
    torch.cuda.empty_cache()
    return launches


INPUT_AB_UPDATES = 2  # fewer than the 4 it took before sequence_parallel, to keep the whole run short
# each input path twice, in mirrored order, from one position on the same
# batches: prefetch (the default) and sync_staged (collation and the
# pinned, bf16 staging on the training thread: the prefetcher's work
# without its thread)
INPUT_AB_ORDER = ("prefetch", "sync_staged", "sync_staged", "prefetch")


class _InlineInput:
    """What ``Trainer.prefetch`` returns, run on the training thread: each
    item is produced and ``put`` when the loop asks for it; ``waits`` holds
    the seconds that took."""

    def __init__(self, items, put):
        self._items, self._put, self.waits = iter(items), put, []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        close = getattr(self._items, "close", None)
        if close is not None:
            close()
        return False

    def __iter__(self):
        while True:
            t = time.perf_counter()
            try:
                host = next(self._items)
            except StopIteration:
                return
            item = self._put(host)
            self.waits.append(time.perf_counter() - t)
            yield item


def input_ab(trainer, state, ds, what: str, card: str) -> dict:
    """``Trainer.fit`` over the same ``INPUT_AB_UPDATES`` updates on each
    input path of ``INPUT_AB_ORDER``, every run from the same position
    (step, epoch, update): ms per update (``profiling.StepTimer`` around a
    synchronised ``train_step``), ms from one update's end to the next's
    (the cycle: the update plus the input work between updates), and the ms
    the training thread spent on each update's input (blocked on the
    prefetch thread, or collating and copying itself)."""
    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.utils.profiling import StepTimer

    quiet = lambda msg: None  # noqa: E731
    state = trainer.fit(ds, state=state, max_updates=state.num_updates + 1, log_fn=quiet)  # warm-up
    pos = (state.step, state.epoch, state.num_updates, state.mini_step)
    inner = trainer.train_step
    runs = []
    for variant in INPUT_AB_ORDER:
        timer, ends = StepTimer(warmup=0), []

        def timed(state_, group, **kw):
            torch.cuda.synchronize()
            with timer.step(items=int((group["idx"] >= 0).sum())):
                logs = inner(state_, group, **kw)
                torch.cuda.synchronize()
            ends.append(time.perf_counter())
            return logs

        trainer.train_step = timed
        if variant != "prefetch":
            trainer.prefetch = _InlineInput
        state.step, state.epoch, state.num_updates, state.mini_step = pos
        t0 = time.perf_counter()
        try:
            state = trainer.fit(ds, state=state, max_updates=pos[2] + INPUT_AB_UPDATES, log_fn=quiet)
        finally:
            for name in ("train_step", "prefetch"):
                trainer.__dict__.pop(name, None)
        fit_ms = (time.perf_counter() - t0) * 1e3
        if len(timer.times) != INPUT_AB_UPDATES:
            raise AssertionError(f"input_ab {what}: {variant} ran {len(timer.times)} updates")
        runs.append({"variant": variant, "update_ms": [t * 1e3 for t in timer.times],
                     "cycle_ms": [(b - a) * 1e3 for a, b in zip(ends, ends[1:])],
                     "input_ms": [w * 1e3 for w in trainer.input_waits],
                     "fit_ms_per_update": fit_ms / INPUT_AB_UPDATES, "step_timer": timer.summary()})
    by_variant = {}
    for variant in dict.fromkeys(INPUT_AB_ORDER):
        mine = [r for r in runs if r["variant"] == variant]
        pooled = lambda key, first=0: [x for r in mine for x in r[key][first:]]  # noqa: E731
        by_variant[variant] = {
            "update_ms_median": float(np.median(pooled("update_ms"))),
            "cycle_ms_median": float(np.median(pooled("cycle_ms"))),
            # the first update's input also holds the skipped groups' collation
            "input_ms_median_after_first": float(np.median(pooled("input_ms", 1))),
            "fit_ms_per_update": [r["fit_ms_per_update"] for r in mine]}
    row = {"phase": "input_ab", "card": card, "what": what, "updates_per_run": INPUT_AB_UPDATES,
           "order": list(INPUT_AB_ORDER), "by_variant": by_variant, "runs": runs}
    emit(row)
    return row


def phase_input_ab(seed: int, card: str):
    """``input_ab`` on contrastive pre-training (the ``contrastive``
    phase's config, on a ``hateful_discussions`` directory of contrastive
    discussions): the lazy npz path, where the input costs more than an
    update. The canonical node run's in-memory input is timed by the
    ``train`` phase (its input wait per update)."""
    import tempfile

    import torch

    from multimodaldiscussiontransformer_tpu_torch.core import registry
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args

    registry.populate()
    with tempfile.TemporaryDirectory() as tmp:
        data, _ = shared_discussions(seed + 2, contrastive=True)
        cfg = config_from_args(build_parser().parse_args(
            [*CANONICAL_FLAGS, "--task", "contrastive_learning", "--data-root", data, "--seed", str(seed + 2),
             "--no-save", "--save-dir", tmp]))
        task = registry.TASKS.get(cfg.task)(cfg)
        ds = task.load_dataset(root=data, split=0, seed=seed + 2)
        trainer = task.build_trainer(image_shape=IMAGE_SHAPE, device="cuda")
        row = input_ab(trainer, trainer.init_state(), ds, "contrastive", card)
        del trainer, ds, task
        torch.cuda.empty_cache()
    return row


REMAT_UPDATES = 2
REMAT_LOSS_RTOL = 1e-6  # the first update's loss: remat changes no forward value
REMAT_RTOL = 5e-3  # its gradient norm and the second update's loss: the backward's atomics sum in another order


def phase_remat(seed: int, card: str):
    """``train_big``'s discussions (S 521-1001, both towers fused, batch 1
    x update_freq 3) without remat and under each remat policy: 2 updates
    each from one state (weights, AdamW moments, both generators); peak
    memory, ms per update, the launches per update with the recompute
    counted, the loss and the gradient norm against no remat."""
    from itertools import islice

    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.data.loader import stack_microbatches
    from multimodaldiscussiontransformer_tpu_torch.tasks.node_prediction import NodePredictionTask
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args
    from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer
    from multimodaldiscussiontransformer_tpu_torch.utils import checkpoints as ckpt
    from multimodaldiscussiontransformer_tpu_torch.utils import profiling

    cfg = config_from_args(build_parser().parse_args(
        ["--synthetic", *CANONICAL_FLAGS, "--batch-size", "1", "--seed", str(seed + 1), "--no-save"]))
    cfg = dataclasses.replace(cfg, model=fused_towers(cfg.model))
    task = NodePredictionTask(cfg)
    ds = task.load_dataset(seed=seed + 1, seq_len=TEXT_LEN, vocab_size=cfg.model.text_tower.vocab_size,
                           image_shape=IMAGE_SHAPE, num_graphs=BIG_GRAPHS, min_nodes=520, max_nodes=1000, image_prob=0.05)
    trainer = task.build_trainer(image_shape=IMAGE_SHAPE, device="cuda")
    groups = list(islice(stack_microbatches(trainer.train_batches(ds, 1), 3, pad_tail=True), REMAT_UPDATES))
    state = trainer.init_state()
    saved = ckpt.state_dict_of(state)
    trainer.train_step(state, groups[0])  # untimed: the first update's one-off costs
    del state
    torch.cuda.empty_cache()
    rows, by_policy = {}, {}
    for policy in ("none",) + REMAT_POLICIES:
        mc = cfg.model.replace(remat=policy != "none", remat_policy="full" if policy == "none" else policy)
        trainer = Trainer(dataclasses.replace(cfg, model=mc), image_shape=IMAGE_SHAPE, device="cuda")
        state = ckpt.restore_params_into_state(trainer, trainer.init_state(params=saved["params"]), saved, False)
        updates = []
        _zero_counts()
        for group in groups:
            batch = trainer.stage(group).ready()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            c0, t = _counts(), time.perf_counter()
            logs = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            got = [a - b for a, b in zip(_counts(), c0)]
            want = expected_launches(mc, True, group["idx"].shape[0], group["images"].shape[1] > 0,
                                     group["input_ids"].shape[2])
            updates.append({"ms": ms, "peak_gb": profiling.memory_stats()["allocated_bytes.all.peak"] / 2**30,
                            "loss": float(logs["loss"]) / max(float(logs["sample_size"]), 1.0),
                            "gnorm": float(logs["gnorm"]), "launches": dict(zip(KERNEL_NAMES, got)),
                            "launches_ok": got == want, "S": int(group["in_degree"].shape[2]) + 1})
        by_policy[policy] = dict(zip(KERNEL_NAMES, _counts()))
        rows[policy] = updates
        del state, trainer, batch
        torch.cuda.empty_cache()
    ref = rows["none"]
    bad = []
    for policy, updates in rows.items():
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
        for i, (u, r) in enumerate(zip(updates, ref)):
            u["loss_rel_vs_none"], u["gnorm_rel_vs_none"] = rel(u["loss"], r["loss"]), rel(u["gnorm"], r["gnorm"])
            tol = REMAT_LOSS_RTOL if i == 0 else REMAT_RTOL
            if not u["launches_ok"] or u["loss_rel_vs_none"] > tol or u["gnorm_rel_vs_none"] > REMAT_RTOL:
                bad.append((policy, i, u["launches_ok"], u["loss_rel_vs_none"], u["gnorm_rel_vs_none"]))
    emit({"phase": "runtime_remat", "card": card,
          "config": "ModelConfig() with both towers fused, --freeze-initial-encoders, batch 1 x update_freq 3 on "
                    f"discussions of 520-1000 nodes; {REMAT_UPDATES} updates per policy from one state",
          "tolerance": {"first_update_loss_rtol": REMAT_LOSS_RTOL, "rtol": REMAT_RTOL},
          "peak_gb": {p: max(u["peak_gb"] for u in us) for p, us in rows.items()},
          "update_ms": {p: [u["ms"] for u in us] for p, us in rows.items()},
          "tree_fwd_launches_per_update": {p: [u["launches"]["tree_attention_fwd_fused"] for u in us] for p, us in rows.items()},
          "tower_fwd_launches_per_update": {p: [u["launches"]["masked_attention_fwd_fused"] for u in us]
                                            for p, us in rows.items()},
          "updates": rows})
    if bad:
        raise AssertionError(f"runtime_remat: (policy, update, launches ok, loss rel, gnorm rel) {bad}")
    return by_policy


PROFILE_UPDATES = 2


def phase_profile(seed: int, card: str):
    """``--profile-trace`` on the canonical synthetic run through
    ``train.launch.main``: the trace of updates 3-4 (after 2, as the JAX
    launcher starts), its size, and its tree and tower kernel events
    against the launches those updates make."""
    import tempfile

    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args

    mc = config_from_args(build_parser().parse_args(["--synthetic", *CANONICAL_FLAGS])).model
    # every canonical update launches the same tree kernels (k = 3, the tail padded)
    per_update = sum(expected_launches(mc, False, 3, False, TEXT_LEN)[:9])
    with tempfile.TemporaryDirectory() as d:
        trace_dir = os.path.join(d, "trace")
        _zero_counts()
        t = time.perf_counter()
        rc, out = _main_quiet(["--synthetic", *CANONICAL_FLAGS, "--seed", str(seed + 1), "--no-save",
                               "--save-dir", os.path.join(d, "run"), "--max-updates", str(2 + PROFILE_UPDATES),
                               "--profile-trace", trace_dir, "--profile-steps", str(PROFILE_UPDATES)])
        seconds = time.perf_counter() - t
        launches = dict(zip(KERNEL_NAMES, _counts()))
        files = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
        events = []
        if files:
            with open(os.path.join(trace_dir, files[0])) as f:
                events = json.load(f)["traceEvents"]
        size = os.path.getsize(os.path.join(trace_dir, files[0])) if files else 0
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    tree = sum("tree_attention" in k for k in kernels)
    tower = sum("masked_attention" in k for k in kernels)
    # the trainer's named ranges: 3 microbatches and one optimizer step per update
    ranges = [e.get("name", "") for e in events if e.get("cat") == "user_annotation"]
    named = {n: ranges.count(n) for n in ("microbatch", "optimizer")}
    emit({"phase": "runtime_profile", "card": card, "rc": rc, "seconds": seconds, "trace_files": files,
          "trace_bytes": size, "trace_events": len(events), "kernel_events": len(kernels),
          "tree_attention_kernel_events": tree, "masked_attention_kernel_events": tower,
          "tree_launches_per_update": per_update, "updates_traced": PROFILE_UPDATES, "named_ranges": named,
          "logged": "profile trace written to" in out})
    if rc != 0 or len(files) != 1 or tree != PROFILE_UPDATES * per_update or "profile trace written to" not in out \
            or named != {"microbatch": 3 * PROFILE_UPDATES, "optimizer": PROFILE_UPDATES}:
        raise AssertionError(f"runtime_profile: rc {rc}, files {files}, tree kernel events {tree} for "
                             f"{PROFILE_UPDATES} x {per_update} launches, named ranges {named}:\n{out[-2000:]}")
    return launches


REMAT_POLICIES = ("full", "dots", "dots_saveable", "names", "names_heavy")
AGREE_VARIANTS = {
    "node": "one scan update of 3 x 4",
    "contrastive": "one scan update of the contrastive task, 3 x 4",
    "multisteps": "one MultiSteps update (scan_microbatches off): 3 microbatches of 4",
    "bf16_adam": "one scan update of 3 x 4 with bf16 Adam moments",
    **{f"remat_{p}": f"one scan update of 3 x 4 under --remat --remat-policy {p}" for p in REMAT_POLICIES},
}


def phase_train_cpu_agreement(seed: int, fused: bool, variant: str = "node", card: str = ""):
    """One update of the tiny config with every dropout at 0, in float32,
    on the card and on the CPU from the same weights and batches: the scan
    update of the node task, or (``variant``) of the contrastive task, a
    MultiSteps update, or a scan update with bf16 Adam moments."""
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
    if fused:
        m = fused_towers(m)
    if variant.startswith("remat_"):
        m = m.replace(remat=True, remat_policy=variant[len("remat_"):])
    contrastive = variant == "contrastive"
    task = dict(task="contrastive_learning", criterion="contrastive_loss") if contrastive else {}
    cfg = TrainConfig(
        model=m, seed=seed, **task,
        data=DataConfig(batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(64,),
                        image_capacity_buckets=(16,), label_capacity_buckets=(32,)),
        optim=OptimConfig(lr=1e-3, warmup_updates=2, total_num_update=20, update_freq=3,
                          scan_microbatches=variant != "multisteps", bf16_adam_state=variant == "bf16_adam"),
        task_cfg=TaskConfig(dataset_name="synthetic", seed=seed),
    )
    img = (3, 32, 32)
    ds = synthetic_dataset(num_graphs=40, seed=seed, seq_len=16, vocab_size=128, image_shape=img, max_nodes=8,
                           contrastive=contrastive)
    out = {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(cfg, image_shape=img, device=dev)
        state = trainer.init_state()
        group = next(iter(stack_microbatches(trainer.train_batches(ds, 1), 3)))
        _zero_counts()
        if variant == "multisteps":
            batches = [{k: v[i] for k, v in group.items()} for i in range(3)]
            logs = [trainer.train_microstep(state, b) for b in batches][-1]
            # after the third microbatch each .grad holds the mean AdamW took
            grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters() if p.requires_grad}
            if state.num_updates != 1 or state.mini_step != 0:
                raise AssertionError(f"MultiSteps: {state.num_updates} updates after 3 microbatches")
        else:
            logs = trainer.train_step(state, group, return_grads=True)
            grads = logs["grads"]
        out[dev] = {
            "grads": {k: v.cpu() for k, v in grads.items()},
            "params": {k: v.detach().cpu() for k, v in state.model.named_parameters()},
            "launches": _counts(),
            "loss": float(logs["loss"]),
        }
        if variant == "bf16_adam":
            dtypes = {st[key].dtype for st in state.optimizer.state.values() for key in ("exp_avg", "exp_avg_sq")}
            if dtypes != {torch.bfloat16}:
                raise AssertionError(f"bf16 Adam state on {dev} holds {dtypes}")
        lr0 = trainer.lr_schedule()(0)
    want = expected_launches(m, fused, 3, group["images"].shape[1] > 0, group["input_ids"].shape[2], contrastive)
    if out["cuda"]["launches"] != want or any(out["cpu"]["launches"]):
        raise AssertionError(f"card update launched {out['cuda']['launches']}, expected {want}; cpu {out['cpu']['launches']}")
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
    name = "train_cpu_agreement" + ("_fused" if fused else "") + ("" if variant == "node" else f"_{variant}")
    emit({"phase": name, "card": card,
          "config": f"tiny{', both towers fused' if fused else ''}, every dropout 0, float32, {AGREE_VARIANTS[variant]}",
          "tensors": len(out["cpu"]["grads"]), "max_abs_err_grad": grad_err, "max_abs_err_param": param_err,
          "max_abs_err_param_small_grad": small_err, "loss_cuda": out["cuda"]["loss"], "loss_cpu": out["cpu"]["loss"],
          "card_launches": dict(zip(KERNEL_NAMES, out["cuda"]["launches"])),
          "tolerance": {"grad_rtol": AGREE_GRAD_RTOL, "grad_atol": AGREE_GRAD_ATOL, "param_rtol": AGREE_PARAM_RTOL,
                        "param_atol": AGREE_PARAM_ATOL, "param_small_grad_atol": 2.05 * lr0}})
    if bad:
        raise AssertionError(f"{name}: card and CPU updates disagree: {bad[:5]}")
    return dict(zip(KERNEL_NAMES, out["cuda"]["launches"]))


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


# checkpoint: the resumed run against the uninterrupted one. Losses of
# updates 3-4 within 1e-2 relative, parameters within 1e-2 of the largest
# change any parameter made in the 4 updates: the card's dLUT and
# index-backward atomics sum in another order in each run, so the two
# differ by rounding, not bit for bit (the CPU test holds bit-equality)
RESUME_LOSS_RTOL = 1e-2
RESUME_PARAM_FRACTION = 1e-2
CKPT_SHARED_TREES = 6  # graphs 0..5 in the stub + shared-<tree>.npz layout


def _bytes_equal(a, b) -> bool:
    """Equal dtype, shape and bytes (NaNs included)."""
    import torch

    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        return a == b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.detach().cpu().reshape(-1).view(torch.uint8), b.detach().cpu().reshape(-1).view(torch.uint8))


def _bytes_differences(a, b, path="") -> list:
    """The paths where two stored states differ (tensors by bytes)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))[:5]}"]
        return [d for k in a for d in _bytes_differences(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: lengths {len(a)} vs {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _bytes_differences(x, y, f"{path}/{i}")]
    return [] if _bytes_equal(a, b) else [path]


def write_hateful_discussions(root: str, seed: int, contrastive: bool = False, graphs: int = TRAIN_GRAPHS,
                              min_nodes: int = 8, max_nodes: int = 32, image_prob: float = 0.25,
                              seq_len: int = TEXT_LEN) -> dict:
    """A ``hateful_discussions`` directory written by the port's ingest
    writers: the train phase's discussions (by default; else ``graphs`` of
    ``min_nodes`` .. ``max_nodes`` nodes) as ``graph-<k>.npz`` (the first
    few as stubs naming a ``shared-<tree>.npz``), ``train-idx-many.txt`` and
    ``test-idx-many.txt`` (the first 4/5 train); with ``contrastive`` each
    carries a community and a hard community (``hard_y``) instead of node
    labels. Compression runs on a thread pool (zlib releases the
    interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_batch_items
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import ingest

    t0 = time.perf_counter()
    items = synthetic_batch_items(graphs, seed=seed, min_nodes=min_nodes, max_nodes=max_nodes, image_prob=image_prob,
                                  seq_len=seq_len, vocab_size=30522, image_shape=IMAGE_SHAPE, contrastive=contrastive)
    made_s = time.perf_counter() - t0
    os.makedirs(root, exist_ok=True)

    def write(k):
        path = os.path.join(root, f"graph-{k}.npz")
        if k < CKPT_SHARED_TREES:
            ingest.save_shared_npz(os.path.join(root, f"shared-{k}.npz"), items[k])
            ingest.save_copy_npz(path, items[k], f"shared-{k}.npz")
        else:
            ingest.save_graph_npz(path, items[k])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        list(pool.map(write, range(len(items))))  # reads every result: a writer's error raises here
    n_train = graphs * 4 // 5
    for name, idx in (("train-idx-many.txt", range(n_train)), ("test-idx-many.txt", range(n_train, len(items)))):
        with open(os.path.join(root, name), "w") as f:
            f.write("".join(f"{i}\n" for i in idx))
    return {"graphs": len(items), "train": n_train, "test": len(items) - n_train,
            "test_nodes": sum(it.num_nodes for it in items[n_train:]),
            "images": int(sum(it.x_images.shape[0] for it in items)), "make_seconds": made_s,
            "write_seconds": time.perf_counter() - t0,
            "bytes": sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))}



_SHARED = {}  # "root": the run's shared data directory; (seed, contrastive): (path, numbers) of one written in it


def shared_discussions(seed: int, contrastive: bool = False):
    """(directory, its numbers): ``write_hateful_discussions(..., seed,
    contrastive)`` with the default discussions, written once a run and
    read by each phase that asks for it (a run writes nothing into its data
    root); the numbers of a directory written earlier carry ``"reused":
    True``. ``drop_shared_discussions`` removes them."""
    key = (seed, contrastive)
    if key in _SHARED:
        path, numbers = _SHARED[key]
        return path, {**numbers, "reused": True}
    if "root" not in _SHARED:
        _SHARED["root"] = tempfile.mkdtemp(prefix="mdt_shared_")
    path = os.path.join(_SHARED["root"], f"data-{seed}-{int(contrastive)}")
    _SHARED[key] = (path, write_hateful_discussions(path, seed, contrastive=contrastive))
    return _SHARED[key]


def drop_shared_discussions() -> None:
    root = _SHARED.get("root")
    _SHARED.clear()
    if root is not None:
        shutil.rmtree(root, ignore_errors=True)

class _RecordedUpdates:
    """Patches ``Trainer.train_step`` and ``Trainer.train_microstep`` (every
    trainer in this process) to record each step's wall time (synchronised),
    peak memory (statistics reset before it), kernel launches, the launches
    the config expects (``contrastive``: the backward reaches every graph
    layer), and, on the first step, the trainable parameters before it, the
    bytes a checkpoint of the state takes (params and buffers at their
    dtypes, plus AdamW's two moments of ``moment_bytes`` per trainable
    element) and, with ``snapshot``, the whole state_dict on the card."""

    def __init__(self, mc, contrastive: bool = False, moment_bytes: int = 4, snapshot: bool = False):
        self.mc, self.contrastive, self.moment_bytes, self.snapshot = mc, contrastive, moment_bytes, snapshot
        self.records, self.before, self.expected_bytes, self.first_state = [], None, None, None

    def _first(self, state):
        names = {id(p): n for n, p in state.model.named_parameters()}
        self.before = {names[id(p)]: p.detach().float().cpu().clone() for p in state.trainable}
        self.expected_bytes = sum(v.numel() * v.element_size() for v in state.model.state_dict().values()) \
            + 2 * self.moment_bytes * sum(p.numel() for p in state.trainable)
        if self.snapshot:
            self.first_state = {k: v.detach().clone() for k, v in state.model.state_dict().items()}

    def _wrap(self, orig, micro: bool):
        import torch

        rec = self

        def step(trainer, state, group, **kw):
            if rec.before is None:
                rec._first(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            c0, t = _counts(), time.perf_counter()
            logs = orig(trainer, state, group, **kw)
            torch.cuda.synchronize()
            k, lead = (1, 0) if micro else (group["idx"].shape[0], 1)
            rec.records.append({
                "ms": (time.perf_counter() - t) * 1e3, "launches": [a - b for a, b in zip(_counts(), c0)],
                "want": expected_launches(rec.mc, False, k, group["images"].shape[lead] > 0,
                                          group["input_ids"].shape[lead + 1], rec.contrastive),
                "update": state.num_updates, "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
                "graphs": int((group["idx"] >= 0).sum()),
                "loss": float(logs["loss"]) / max(float(logs["sample_size"]), 1.0),
            })
            return logs

        return step

    def __enter__(self):
        from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

        self._orig = (Trainer.train_step, Trainer.train_microstep)
        Trainer.train_step = self._wrap(self._orig[0], micro=False)
        Trainer.train_microstep = self._wrap(self._orig[1], micro=True)
        return self

    def __exit__(self, *exc):
        from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

        Trainer.train_step, Trainer.train_microstep = self._orig
        return False

    def check_launches(self, what: str, launches: dict) -> None:
        """Every step launched what the config expects, and the graph
        layers only the tensor-core tree kernels."""
        bad = [(r["launches"], r["want"]) for r in self.records if r["launches"] != r["want"]]
        other = [launches[n] for n in TREE_NOT_BF16]
        tensor_core = [launches[n] for n in TREE_TENSOR_CORE]
        if not self.records or bad or any(other) or not all(tensor_core):
            raise AssertionError(f"{what}: tree launches per step (got, expected) {bad[:3]}; run {launches}")


def optimizer_step_ms(cfg, params) -> dict:
    """The AdamW step of a ``Trainer`` built from ``cfg`` on the card,
    holding ``params``, with N(0, 1e-6) gradients: device ms of its kernels
    (``torch.profiler``) and the span on the card's clock (CUDA events,
    host dispatch gaps included; median of 5), after 2 warm-up steps."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

    state = Trainer(cfg, image_shape=IMAGE_SHAPE, device="cuda").init_state(params=params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for p in state.trainable:
        p.grad = torch.randn(p.shape, generator=gen, device="cuda").mul_(1e-3).to(p.dtype)
    opt = state.optimizer
    for _ in range(2):
        opt.step()
    spans = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        opt.step()
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opt.step()
        torch.cuda.synchronize()
    moments = {st["exp_avg"].dtype for st in opt.state.values()}
    out = {"optimizer": type(opt).__name__, "moments": str(moments.pop()).replace("torch.", ""),
           "params": str(state.trainable[0].dtype).replace("torch.", ""),
           "device_ms": sum(e.self_device_time_total for e in prof.key_averages()) / 1e3,
           "span_ms_median": float(np.median(spans))}
    del state, opt
    torch.cuda.empty_cache()
    return out


def _main_quiet(argv):
    """``train.launch.main(argv)`` in this process; (rc, its stdout)."""
    import contextlib
    import io

    from multimodaldiscussiontransformer_tpu_torch.train import launch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch.main(argv)
    return rc, buf.getvalue()


def _train_losses(save_dir: str) -> dict:
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if r["split"] == "train"}


def phase_checkpoint(seed: int, card: str = ""):
    """Save, preempt, resume, evaluate, predict and serve from checkpoints at
    full width, through the launcher, on a ``hateful_discussions``
    directory."""
    import shutil
    import signal
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.serve.incremental import DiscussionScorer
    from multimodaldiscussiontransformer_tpu_torch.tasks.node_prediction import NodePredictionTask
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args
    from multimodaldiscussiontransformer_tpu_torch.utils import checkpoints as ckpt

    from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import scanned_state_dict

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="mdt_checkpoint_")
    procs = []
    try:
        data, dataset = shared_discussions(seed + 1)
        dirs = {name: os.path.join(root, name)
                for name in ("whole", "in_flight", "stop_save", "copy", "sync", "scan", "pred")}
        # the canonical run_train.sh 8 4 5 2 2 0 flags, bf16, 4 updates
        flags = ["--num-fusion-layers", "8", "--num-bottleneck-tokens", "4", "--spatial-pos-max", "5",
                 "--num-graph-stack", "2", "--num-fusion-stack", "2", "--freeze-initial-encoders",
                 "--batch-size", "12", "--update-freq", "3", "--positive-weight", "1.5", "--seed", str(seed + 1),
                 "--data-root", data, "--max-updates", "4", "--log-interval", "1"]
        saves = ["--save-interval-updates", "2", "--validate-interval-updates", "2"]
        cfg = config_from_args(build_parser().parse_args(flags))
        mc = cfg.model
        torch.cuda.empty_cache()
        seconds, last = {}, [t_phase]

        def mark(step):
            """Time since the previous mark, as the phase's ``step``."""
            now = time.perf_counter()
            seconds[step], last[0] = now - last[0], now

        mark("data")

        # two preempted runs, each a process of its own, each sent SIGTERM
        # once its log shows update 1:
        # - "in_flight" saves after every update, so the signal lands while
        #   the asynchronous save of step 1 is still being written (~2-4 s):
        #   its file is newer than the signal; the stop comes at update 1
        #   (the signal came during that save's snapshot) or 2;
        # - "stop_save" makes no interval or validation save, so only the
        #   stop branch can save: the stop comes at update 2 (an update
        #   takes ~0.6 s) and its asynchronous save, waited for before the
        #   process exits, is the run's only step on disk.
        # Both start together and run beside the uninterrupted run (three
        # trainings on the card at a time)
        env = {**os.environ, "PYTHONUNBUFFERED": "1", "PYTHONFAULTHANDLER": "1"}
        preempted = {"in_flight": ["--save-interval-updates", "1"], "stop_save": []}

        def start_preempted(name):
            log_path = os.path.join(root, f"{name}.log")
            cmd = [sys.executable, "-m", "multimodaldiscussiontransformer_tpu_torch.train.launch", *flags,
                   "--validate-interval-updates", "0", *preempted[name], "--save-dir", dirs[name]]
            with open(log_path, "w") as log:
                proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT)
            procs.append(proc)
            sent = {}

            def watch():
                t0 = time.perf_counter()
                while proc.poll() is None:
                    with open(log_path) as f:
                        if re.search(r"update 1: ", f.read()):
                            proc.send_signal(signal.SIGTERM)
                            sent["after_s"], sent["wall"] = time.perf_counter() - t0, time.time()
                            return
                    time.sleep(0.01)

            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            return {"proc": proc, "log": log_path, "sent": sent, "watcher": watcher}

        runs = {name: start_preempted(name) for name in preempted}

        _zero_counts()
        with _RecordedUpdates(mc) as whole:
            rc, out_whole = _main_quiet(flags + saves + ["--save-dir", dirs["whole"]])
        whole_launches = dict(zip(KERNEL_NAMES, _counts()))
        if rc != 0:
            raise AssertionError(f"checkpoint: the uninterrupted run returned {rc}:\n{out_whole[-2000:]}")
        if [r["update"] for r in whole.records] != [1, 2, 3, 4]:
            raise AssertionError(f"checkpoint: uninterrupted updates {[r['update'] for r in whole.records]}")
        whole.check_launches("checkpoint: the uninterrupted run", whole_launches)
        mark("uninterrupted")
        a = ckpt.Checkpointer(dirs["whole"]).restore(step=4)
        la = _train_losses(dirs["whole"])
        moved = max(float((a["params"][k].float() - v).abs().max()) for k, v in whole.before.items())
        preempt_rows = {}
        for name in preempted:
            run = runs[name]
            rc = run["proc"].wait(timeout=600)
            run["watcher"].join(timeout=10)
            sent = run["sent"]
            with open(run["log"]) as f:
                log_text = f.read()
            stopped = re.search(r"stop requested at update (\d+)", log_text)
            stop_at = int(stopped.group(1)) if stopped else None
            steps = ckpt.Checkpointer(dirs[name]).all_steps()
            step1 = os.path.join(dirs[name], "1", ckpt.STATE_FILE)
            in_flight = os.path.exists(step1) and "wall" in sent and os.path.getmtime(step1) > sent["wall"]
            if name == "in_flight":
                ok = stop_at in (1, 2) and in_flight and steps == sorted({1, stop_at})
            else:  # the stop branch's own save is the one step on disk
                ok = stop_at == 2 and steps == [2]
            if rc != 0 or "after_s" not in sent or not ok \
                    or f"preempted: checkpoint saved at step {stop_at}" not in log_text:
                raise AssertionError(f"checkpoint: the {name} preempted run (rc {rc}, stop at {stop_at}, steps "
                                     f"{steps}, step 1 in flight at the signal {in_flight}) did not save at its "
                                     f"stop:\n{log_text[-3000:]}")

            # the relaunch: auto-resume from the stop, run to 4
            _zero_counts()
            with _RecordedUpdates(mc) as resumed:
                rc, out_resumed = _main_quiet(flags + saves + ["--save-dir", dirs[name]])
            resumed_launches = dict(zip(KERNEL_NAMES, _counts()))
            if rc != 0 or f"auto-resumed from step {stop_at}" not in out_resumed:
                raise AssertionError(f"checkpoint: the {name} relaunch returned {rc} without resuming:\n"
                                     f"{out_resumed[-2000:]}")
            resumed_updates = list(range(stop_at + 1, 5))
            if [r["update"] for r in resumed.records] != resumed_updates:
                raise AssertionError(f"checkpoint: the {name} relaunch ran {[r['update'] for r in resumed.records]}")
            resumed.check_launches(f"checkpoint: the {name} resumed run", resumed_launches)

            # the preempted + resumed run against the uninterrupted one, at step 4
            b = ckpt.Checkpointer(dirs[name]).restore(step=4)
            rng_equal = {k: _bytes_equal(a[k], b[k]) for k in ("host_rng", "device_rng")}
            lb = _train_losses(dirs[name])
            loss_rel = {n: abs(lb[n] - la[n]) / abs(la[n]) for n in resumed_updates}
            diffs = sorted(((float((b["params"][k].float() - a["params"][k].float()).abs().max()), k)
                            for k in whole.before), reverse=True)
            differing = sum(int((b["params"][k] != a["params"][k]).sum()) for k in whole.before)
            if not all(rng_equal.values()) or max(loss_rel.values()) > RESUME_LOSS_RTOL \
                    or diffs[0][0] > RESUME_PARAM_FRACTION * moved:
                raise AssertionError(f"checkpoint: {name} resumed vs uninterrupted: generators equal {rng_equal}, "
                                     f"loss rel {loss_rel}, largest param diffs {diffs[:5]} against the 4 updates' "
                                     f"{moved}")
            resumed_ms = [r["ms"] for r in resumed.records]
            preempt_rows[name] = {
                "signal_after_s": sent["after_s"], "stop_at_update": stop_at, "steps_on_disk": steps,
                "step1_written_after_the_signal": in_flight, "resumed_updates": resumed_updates,
                "resumed_update_ms": resumed_ms, "resumed_update_ms_median": float(np.median(resumed_ms)),
                "loss_resumed": lb, "loss_rel_diff": loss_rel, "generators_byte_equal": rng_equal,
                "param_largest_diffs": diffs[:5], "param_elements_differing": differing,
                "launches_resumed": resumed_launches}
            del b
            mark(f"{name}_relaunch_and_compare")

        # the round trip: the uninterrupted run's step 4 in memory, saved, loaded
        task = NodePredictionTask(cfg)
        trainer = task.build_trainer(image_shape=IMAGE_SHAPE, device="cuda")
        state = ckpt.restore_params_into_state(trainer, trainer.init_state(params=a["params"]), a, reset_optimizer=False)
        del a
        before = ckpt.state_dict_of(state)
        # an async save: the training thread stalls for the snapshot only;
        # the step is durable once wait returns. A synchronous save of the
        # same state beside it
        saver = ckpt.Checkpointer(dirs["copy"], keep=2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        saver.save(state, state.num_updates)
        save_ms = (time.perf_counter() - t) * 1e3
        saver.wait()
        durable_ms = (time.perf_counter() - t) * 1e3
        path = os.path.join(dirs["copy"], str(state.num_updates), ckpt.STATE_FILE)
        ckpt_bytes = os.path.getsize(path)
        t = time.perf_counter()
        ckpt.Checkpointer(dirs["sync"], async_save=False).save(state, state.num_updates)
        sync_save_ms = (time.perf_counter() - t) * 1e3
        sync_bytes = os.path.getsize(os.path.join(dirs["sync"], str(state.num_updates), ckpt.STATE_FILE))
        shutil.rmtree(dirs["sync"])
        # serve the copy from another process while this one checks it
        with open(os.path.join(root, "server.log"), "w") as log:
            server = subprocess.Popen(
                [sys.executable, "-m", "multimodaldiscussiontransformer_tpu_torch.serve.server", "--checkpoint",
                 dirs["copy"], "--host", "127.0.0.1", "--port", "0"],
                cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT)
        procs.append(server)
        t = time.perf_counter()
        restored = saver.restore(state)
        ckpt.restore_params_into_state(trainer, state, restored, reset_optimizer=False)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t) * 1e3
        mismatched = _bytes_differences(restored, before) + _bytes_differences(ckpt.state_dict_of(state), before)
        if mismatched:
            raise AssertionError(f"checkpoint: the save/load round trip changed {mismatched[:8]}")
        if not whole.expected_bytes <= ckpt_bytes <= whole.expected_bytes * 1.01 + 2**20:
            raise AssertionError(f"checkpoint: {ckpt_bytes} bytes on disk, {whole.expected_bytes} expected")
        del before, restored
        mark("round_trip")

        # scoring from the checkpoint against the model that wrote it
        rng = np.random.default_rng(seed + 7)
        discussions = [make_discussion(rng, int(rng.integers(8, 33)), 0.25) for _ in range(4)]
        items = [d.to_item(i) for i, d in enumerate(discussions)]
        want = DiscussionScorer(state.model, device="cuda", image_shape=IMAGE_SHAPE).score_items(items)
        torch.cuda.synchronize()
        t = time.perf_counter()
        scorer = DiscussionScorer.from_checkpoint(dirs["copy"])
        torch.cuda.synchronize()
        from_ckpt_ms = (time.perf_counter() - t) * 1e3
        got = scorer.score_items(items)
        if scorer.device.type != "cuda" or not all(np.array_equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"checkpoint: from_checkpoint on {scorer.device} scores "
                                 f"{max(float(np.abs(x - y).max()) for x, y in zip(got, want))} off the model")
        # the same params in the scan layout (what --scan-layers saves), served
        stacked = scanned_state_dict(state.model.state_dict(), mc)
        ckpt.save_params(dirs["scan"], stacked)
        scan_scorer = DiscussionScorer.from_checkpoint(dirs["scan"])
        got_scan = scan_scorer.score_items(items)
        scan_equal = all(np.array_equal(x, y) for x, y in zip(got_scan, got))
        scan_tensors = sum(".scan_pairs." in k or ".scan_layers." in k for k in stacked)
        del scan_scorer, stacked
        if not scan_equal or not scan_tensors:
            raise AssertionError(f"checkpoint: the scan-layout checkpoint ({scan_tensors} stacked tensors) scores "
                                 f"{max(float(np.abs(x - y).max()) for x, y in zip(got_scan, got))} off the unrolled one")
        del scorer, trainer, state, task
        torch.cuda.empty_cache()
        mark("from_checkpoint")

        # the other entry points: --eval-only with the best step, and with the
        # average of the last 2 plus per-node predictions
        _zero_counts()
        eval_flags = flags + ["--save-dir", dirs["whole"], "--eval-only", "--valid-subset", "test"]
        t = time.perf_counter()
        rc_best, out_best = _main_quiet(eval_flags + ["--load-best"])
        rc_avg, out_avg = _main_quiet(eval_flags + ["--average-last", "2", "--predict-output", dirs["pred"]])
        eval_s = time.perf_counter() - t
        m = re.search(r"wrote (\d+) per-node rows -> (\S+)", out_avg)
        if rc_best != 0 or rc_avg != 0 or "evaluating best checkpoint" not in out_best or not m:
            raise AssertionError(f"checkpoint: --eval-only returned {rc_best} / {rc_avg}:\n{out_best[-1500:]}\n"
                                 f"{out_avg[-1500:]}")
        pred_path = m.group(2)
        if pred_path.endswith(".csv"):
            with open(pred_path) as f:
                file_rows = sum(1 for _ in f) - 1
        else:
            import pandas as pd

            file_rows = len(pd.read_parquet(pred_path))
        if int(m.group(1)) != dataset["test_nodes"] or file_rows != dataset["test_nodes"]:
            raise AssertionError(f"checkpoint: {m.group(1)} prediction rows ({file_rows} in {pred_path}), "
                                 f"{dataset['test_nodes']} real test nodes")
        eval_launches = dict(zip(KERNEL_NAMES, _counts()))
        if eval_launches["tree_attention_fwd"] or not eval_launches["tree_attention_fwd_fused"]:
            raise AssertionError(f"checkpoint: --eval-only tree launches {eval_launches}")

        mark("eval_only")

        # the server CLI: one POST with the same discussions
        deadline = time.time() + 300
        while True:
            with open(os.path.join(root, "server.log")) as f:
                text = f.read()
            port = re.search(r"on http://127\.0\.0\.1:(\d+)", text)
            if port or server.poll() is not None or time.time() > deadline:
                break
            time.sleep(0.1)
        if not port:
            raise AssertionError(f"checkpoint: the server did not start (rc {server.poll()}):\n{text[-2000:]}")
        body = json.dumps({"discussions": [
            {"parents": d.parents, "input_ids": np.stack(d.input_ids).tolist(),
             "images": {str(k): v.tolist() for k, v in d.images.items()}} for d in discussions]}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port.group(1)}/v1/score", data=body,
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            served = [np.asarray(p, np.float32) for p in json.loads(resp.read())["probs"]]
        post_ms = (time.perf_counter() - t) * 1e3
        server.send_signal(signal.SIGINT)
        server_rc = server.wait(timeout=60)
        if server_rc != 0 or not all(np.array_equal(x, y) for x, y in zip(served, want)):
            with open(os.path.join(root, "server.log")) as f:
                text = f.read()
            raise AssertionError(f"checkpoint: the server (rc {server_rc}) answered "
                                 f"{max(float(np.abs(x - y).max()) for x, y in zip(served, want))} off the model:\n"
                                 f"{text[-4000:]}")
        mark("server")

        row = {
            "phase": "checkpoint", "card": card,
            "config": "ModelConfig() (launch flags: run_train.sh 8 4 5 2 2 0, --freeze-initial-encoders, batch 12 x "
                      "update_freq 3), bfloat16 compute, float32 params, 4 updates",
            "dataset": dataset, "preempted": preempt_rows,
            "checkpoint_bytes": ckpt_bytes, "expected_bytes": whole.expected_bytes, "sync_checkpoint_bytes": sync_bytes,
            "save_stall_ms": save_ms, "save_durable_ms": durable_ms, "sync_save_ms": sync_save_ms,
            "restore_ms": restore_ms, "from_checkpoint_ms": from_ckpt_ms,
            "update_ms_after_a_save": [r["ms"] for r in whole.records if r["update"] == 3],
            "scan_layout_bit_equal": scan_equal, "scan_layout_stacked_tensors": scan_tensors,
            "uninterrupted_update_ms_beside_the_preempted_runs": [r["ms"] for r in whole.records],
            "loss_uninterrupted": la, "param_max_change_4_updates": moved,
            "param_elements": sum(v.numel() for v in whole.before.values()),
            "round_trip_byte_exact": True, "from_checkpoint_bit_equal": True, "server_bit_equal": True,
            "server_post_ms": post_ms, "eval_only_seconds": eval_s, "prediction_rows": int(m.group(1)),
            "prediction_file": os.path.basename(pred_path),
            "launches_uninterrupted": whole_launches, "launches_eval_only": eval_launches,
            "seconds_by_step": seconds, "seconds": time.perf_counter() - t_phase,
        }
        emit(row)
        return row
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        shutil.rmtree(root, ignore_errors=True)


CONTRASTIVE_UPDATES = 4
# the canonical run_train.sh 8 4 5 2 2 0 flags (bf16, frozen towers, dropout
# 0.4 / 0.3 / 0.3 from the launcher's defaults)
CANONICAL_FLAGS = ["--num-fusion-layers", "8", "--num-bottleneck-tokens", "4", "--spatial-pos-max", "5",
                   "--num-graph-stack", "2", "--num-fusion-stack", "2", "--freeze-initial-encoders",
                   "--batch-size", "12", "--update-freq", "3", "--positive-weight", "1.5", "--log-interval", "1",
                   "--validate-interval-updates", "0"]


def _test_metrics(out: str) -> dict:
    """The launcher's final ``test: {...}`` evaluation."""
    m = re.search(r"^test: (\{.*\})$", out, re.M)
    if not m:
        raise AssertionError(f"no test evaluation in the launcher's output:\n{out[-1500:]}")
    return json.loads(m.group(1))


def phase_contrastive(seed: int):
    """The reference's two stages and the optimizer settings, at full width
    through the launcher: contrastive pre-training on a
    ``hateful_discussions`` directory of contrastive discussions (4
    updates, a save at 4, the test evaluation), the node task restored from
    that checkpoint with ``--reset-optimizer`` (2 updates, evaluation),
    then MultiSteps (``--no-scan-microbatches``), ``--bf16-adam-state``
    (with a save) and ``param_dtype="bfloat16"`` (the Python API) for 2
    updates each."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.tasks.node_prediction import NodePredictionTask
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args
    from multimodaldiscussiontransformer_tpu_torch.utils import checkpoints as ckpt

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mdt_contrastive_")
    seconds, last = {}, [t_phase]

    def mark(step):
        now = time.perf_counter()
        seconds[step], last[0] = now - last[0], now

    def run(argv, **recorder):
        """``launch.main(argv)`` with its steps recorded; (output,
        recorder, launches)."""
        cfg = config_from_args(build_parser().parse_args(argv))
        torch.cuda.empty_cache()
        _zero_counts()
        with _RecordedUpdates(cfg.model, **recorder) as rec:
            rc, out = _main_quiet(argv)
        launches = dict(zip(KERNEL_NAMES, _counts()))
        if rc != 0:
            raise AssertionError(f"contrastive: launch.main({argv[-6:]}) returned {rc}:\n{out[-3000:]}")
        return out, rec, launches

    def updates(rec):
        ms = [r["ms"] for r in rec.records]
        return {"update_ms": ms, "update_ms_median": float(np.median(ms)), "update_ms_last": ms[-1],
                "discussions_per_sec": sum(r["graphs"] for r in rec.records) / (sum(ms) / 1e3),
                "max_memory_allocated_gb": max(r["peak_gb"] for r in rec.records),
                "loss": [r["loss"] for r in rec.records]}

    def moving(what, losses):
        if not all(np.isfinite(losses)) or len(set(losses)) < 2:
            raise AssertionError(f"{what}: loss series not finite or constant: {losses}")

    row = {"phase": "contrastive",
           "config": "ModelConfig() (launch flags: run_train.sh 8 4 5 2 2 0, --freeze-initial-encoders, batch 12 x "
                     "update_freq 3, dropout 0.4/0.3/0.3), bfloat16 compute"}
    try:
        # 1. contrastive pre-training: the backward now reaches every graph layer
        data, row["dataset"] = shared_discussions(seed + 2, contrastive=True)
        pre = os.path.join(root, "pre")
        mark("data")
        out, rec, launches = run(CANONICAL_FLAGS + [
            "--task", "contrastive_learning", "--data-root", data, "--max-updates", str(CONTRASTIVE_UPDATES),
            "--seed", str(seed + 2), "--save-dir", pre], contrastive=True)
        rec.check_launches("contrastive pre-training", launches)
        per_update = [dict(zip(KERNEL_NAMES, r["launches"])) for r in rec.records]
        tree = [[u[n] for n in ("tree_attention_fwd_fused", "tree_attention_bwd_dq_fused",
                                 "tree_attention_bwd_dkv_fused")] for u in per_update]
        if [r["update"] for r in rec.records] != list(range(1, CONTRASTIVE_UPDATES + 1)) \
                or any(t != [30, 30, 30] for t in tree):
            raise AssertionError(f"contrastive: updates {[r['update'] for r in rec.records]}, tree launches {tree}, "
                                 "expected 30 / 30 / 30 per update")
        test = _test_metrics(out)
        if not np.isfinite(test["loss"]) or not {"accuracy", "precision", "recall"} <= set(test):
            raise AssertionError(f"contrastive: test metrics {test}")
        moving("contrastive", [r["loss"] for r in rec.records])
        steps = ckpt.Checkpointer(pre).all_steps()
        if steps != [CONTRASTIVE_UPDATES]:
            raise AssertionError(f"contrastive: saved steps {steps}")
        row["pretrain"] = {**updates(rec), "tree_launches_per_update": tree, "test": test,
                           "launches": launches,
                           "eval_tree_fwd_launches": launches["tree_attention_fwd_fused"] - sum(t[0] for t in tree)}
        mark("pretrain")

        # 2. the transfer: the node task from the contrastive checkpoint, a new head
        node = CANONICAL_FLAGS + ["--synthetic", "--max-updates", "2", "--seed", str(seed + 3)]
        out, rec, launches = run(node + ["--restore-file", pre, "--reset-optimizer",
                                            "--save-dir", os.path.join(root, "node")], snapshot=True)
        rec.check_launches("transfer", launches)
        saved = ckpt.Checkpointer(pre).restore()["params"]
        differ = sorted(k for k, v in saved.items() if not torch.equal(rec.first_state[k], v.to(rec.first_state[k].device)))
        if f"restored from {pre}" not in out or differ != ["node_classifier.weight"] \
                or rec.first_state["node_classifier.bias"].any():
            raise AssertionError(f"transfer: tensors that differ from the checkpoint before update 1: {differ[:8]}")
        moving("transfer", [r["loss"] for r in rec.records])
        row["transfer"] = {**updates(rec), "differ_from_checkpoint": differ, "test": _test_metrics(out),
                           "launches": launches}
        del saved, rec
        mark("transfer")

        # 3. MultiSteps: one microbatch per step, the mean applied every 3rd
        out, rec, launches = run(node + ["--no-scan-microbatches", "--no-save", "--save-dir",
                                            os.path.join(root, "multisteps")])
        rec.check_launches("multisteps", launches)
        if len(rec.records) != 6 or [r["update"] for r in rec.records] != [0, 0, 1, 1, 1, 2]:
            raise AssertionError(f"multisteps: microbatches ended at updates {[r['update'] for r in rec.records]}")
        moving("multisteps", [r["loss"] for r in rec.records])
        row["multisteps"] = {**updates(rec), "launches": launches}
        mark("multisteps")

        # 4. bf16 Adam moments, with a save
        bf16_dir = os.path.join(root, "bf16_adam")
        out, rec, launches = run(node + ["--bf16-adam-state", "--save-dir", bf16_dir], moment_bytes=2)
        rec.check_launches("bf16_adam", launches)
        moving("bf16_adam", [r["loss"] for r in rec.records])
        path = os.path.join(bf16_dir, "2", ckpt.STATE_FILE)
        ckpt_bytes = os.path.getsize(path)
        saved = ckpt.Checkpointer(bf16_dir).restore()
        moments = {v.dtype for st in saved["optimizer"]["state"].values() for key, v in st.items() if key != "step"}
        if moments != {torch.bfloat16} or not rec.expected_bytes <= ckpt_bytes <= rec.expected_bytes * 1.01 + 2**20:
            raise AssertionError(f"bf16_adam: moments {moments}, {ckpt_bytes} bytes, {rec.expected_bytes} expected")
        row["bf16_adam"] = {**updates(rec), "checkpoint_bytes": ckpt_bytes, "expected_bytes": rec.expected_bytes,
                            "launches": launches}
        mark("bf16_adam")
        # the AdamW step alone on the same params: float32 moments, bf16
        # moments, bf16 params
        cfg = config_from_args(build_parser().parse_args(node + ["--no-save"]))
        bf16 = cfg.model.replace(param_dtype="bfloat16")
        row["adamw_step"] = [
            optimizer_step_ms(cfg, saved["params"]),
            optimizer_step_ms(cfg.replace(optim=dataclasses.replace(cfg.optim, bf16_adam_state=True)), saved["params"]),
            optimizer_step_ms(cfg.replace(model=bf16), {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                                                         for k, v in saved["params"].items()}),
        ]
        del saved
        mark("adamw_step")

        # 5. bf16 params (no launcher flag, as in the JAX package)
        cfg = config_from_args(build_parser().parse_args(node + ["--no-save", "--save-dir", os.path.join(root, "p")]))
        cfg = cfg.replace(model=cfg.model.replace(param_dtype="bfloat16"))
        task = NodePredictionTask(cfg)
        ds = task.load_dataset(num_graphs=48, seed=seed + 3, seq_len=100, vocab_size=cfg.model.text_tower.vocab_size,
                               image_shape=IMAGE_SHAPE, max_nodes=24)
        torch.cuda.empty_cache()
        _zero_counts()
        with _RecordedUpdates(cfg.model, moment_bytes=2) as rec:
            trainer = task.build_trainer(image_shape=IMAGE_SHAPE, device="cuda")
            state = trainer.init_state()
            dtypes = {p.dtype for p in state.model.parameters()}
            trainer.fit(ds, state=state, max_updates=2, log_fn=lambda msg: None)
        launches = dict(zip(KERNEL_NAMES, _counts()))
        rec.check_launches("bf16_params", launches)
        moving("bf16_params", [r["loss"] for r in rec.records])
        if dtypes != {torch.bfloat16}:
            raise AssertionError(f"bf16_params: parameters in {dtypes}")
        row["bf16_params"] = {**updates(rec), "launches": launches,
                              "param_bytes": sum(p.numel() * p.element_size() for p in state.model.parameters())}
        del state, trainer, task, ds
        mark("bf16_params")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    row["seconds_by_step"] = seconds
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return row


# ingest and weights_in: data and weights from outside the port, at full width
INGEST_UPDATES = 4
INGEST_TREES, INGEST_BIG_TREES = 60, 2  # the raw corpus (240 and 4 before the workflows phase)
# the update after a restore, from the converted JAX layout against the
# port's own checkpoint (both on the card, the same dropout bits): as
# train_cpu_agreement's parameters
RESTORE_RTOL, RESTORE_ATOL = 2e-4, 1e-6


def _median_ms(fn, reps: int = 5) -> float:
    import numpy as np

    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


def _npz_files_equal(a: str, b: str) -> int:
    """Both directories hold the same ``.npz`` files with equal arrays
    (dtype, shape and bytes); returns how many files."""
    import numpy as np

    files = sorted(os.listdir(a))
    if files != sorted(os.listdir(b)):
        raise AssertionError(f"ingest: the two runs wrote other files ({len(files)} vs {len(os.listdir(b))})")
    for f in files:
        with np.load(os.path.join(a, f)) as x, np.load(os.path.join(b, f)) as y:
            if sorted(x.files) != sorted(y.files) or any(
                    x[k].dtype != y[k].dtype or x[k].shape != y[k].shape or x[k].tobytes() != y[k].tobytes()
                    for k in x.files):
                raise AssertionError(f"ingest: {f} differs between the native and the numpy run")
    return len(files)


def phase_ingest(seed: int, card: str, root: str) -> dict:
    """Raw discussion JSON -> the card: a seeded ``pruned-with-images.json``
    corpus in the reference's schema and a WordPiece vocab built from it,
    ``data_prep.run splits`` and the ingest CLI (``--workers 4``, the C++
    helper; again with ``MDT_TPU_NO_NATIVE=1``), then 4 canonical updates
    from that ``--data-root`` through ``train.launch.main`` and
    ``--eval-only --predict-output`` on the result."""
    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.data import preprocess, trees
    from multimodaldiscussiontransformer_tpu_torch.data_prep.synthetic import build_vocab, synthetic_raw_corpus
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import ingest
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset import create_hatespeech_dataset
    from multimodaldiscussiontransformer_tpu_torch.native import loader
    from multimodaldiscussiontransformer_tpu_torch.serve.incremental import DiscussionScorer, Discussion
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    raw, vocab = os.path.join(root, "pruned-with-images.json"), os.path.join(root, "vocab.txt")
    made = synthetic_raw_corpus(raw, root, num_trees=INGEST_TREES, big_trees=INGEST_BIG_TREES, seed=seed + 5)
    row = {"phase": "ingest", "card": card, "corpus": made, "vocab_size": build_vocab(raw, vocab),
           "corpus_seconds": time.perf_counter() - t_phase}
    env = {**os.environ, "MDT_BERT_VOCAB": vocab}
    env.pop("MDT_TPU_NO_NATIVE", None)

    def cli(module, args, extra_env=None):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{PKG}.{module}", *args], cwd=here, env={**env, **(extra_env or {})},
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"ingest: {module} {args[:2]} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        return proc.stdout, time.perf_counter() - t

    splits = os.path.join(root, "splits")
    out, row["splits_seconds"] = cli("data_prep.run", ["splits", raw, splits, "--test-frac", "0.05"])
    row["splits"] = out.strip().splitlines()[-1]
    runs = {}
    for name, extra in (("native", None), ("numpy", {"MDT_TPU_NO_NATIVE": "1"})):
        data = os.path.join(root, "data" if name == "native" else "data_numpy")
        out, seconds = cli("experiments.hateful_discussions.ingest",
                           [raw, data, "--train-idx", os.path.join(splits, "train-idx.txt"), "--test-idx",
                            os.path.join(splits, "test-idx.txt"), "--image-root", root, "--workers", "4"], extra)
        path = re.search(r"^tree distances: (.*)$", out, re.M)
        copies = re.search(r"^FINAL K (\d+)$", out, re.M)
        runs[name] = {"seconds": seconds, "seconds_per_100_trees": seconds * 100 / made["trees"],
                      "graph_copies": int(copies.group(1)) if copies else None,
                      "tree_distances": path.group(1) if path else None,
                      "summary": [ln for ln in out.splitlines() if ln.startswith(("trees=", "images:", "phase"))]}
    if runs["native"]["tree_distances"] != "the C++ host helper" or runs["numpy"]["tree_distances"] != "numpy":
        raise AssertionError(f"ingest: distance paths {runs['native']['tree_distances']!r} / {runs['numpy']['tree_distances']!r}")
    data = os.path.join(root, "data")
    row["npz_files_equal"] = _npz_files_equal(os.path.join(data, "processed"), os.path.join(root, "data_numpy", "processed"))
    for name in ("train-idx-many.txt", "test-idx-many.txt", "tree-map.txt"):
        with open(os.path.join(data, name), "rb") as a, open(os.path.join(root, "data_numpy", name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"ingest: {name} differs between the native and the numpy run")
    row["ingest"] = runs

    # the host helper against numpy on one 600-node tree, and on the
    # scorer's host path (Discussion.to_item: distances and buckets; collate)
    if loader.try_load() is None:
        raise AssertionError("ingest: the C++ host helper did not build on this machine")
    with open(raw) as f:
        lines = f.readlines()
    parents = max((ingest.collapse_tree(json.loads(ln))[2] for ln in lines[-8:]), key=len)
    rng = np.random.default_rng(seed)
    batch4 = [make_discussion(rng, int(rng.integers(16, 25)), 0.2) for _ in range(4)]
    big = Discussion()
    for p in parents:
        big.add_node(int(p), np.ones(TEXT_LEN, np.int32))
    scorer = DiscussionScorer(torch.nn.Identity(), device="cuda", image_shape=IMAGE_SHAPE)
    timings = {}
    for name, disable in (("native", None), ("numpy", "1")):
        if disable:
            os.environ["MDT_TPU_NO_NATIVE"] = disable
        try:
            calls = loader.CALLS["tree_distance_pairs"]
            timings[name] = {
                "tree_distance_pairs_plus_spatial_buckets_ms": _median_ms(
                    lambda: preprocess.spatial_buckets(trees.tree_distance_pairs(parents))),
                "collate_batch4_ms": _median_ms(lambda: scorer.collate([d.to_item(i) for i, d in enumerate(batch4)])),
                "collate_600_nodes_ms": _median_ms(lambda: scorer.collate([big.to_item()])),
            }
            if (loader.CALLS["tree_distance_pairs"] > calls) != (name == "native"):
                raise AssertionError(f"ingest: the {name} timing did not take the {name} path")
        finally:
            os.environ.pop("MDT_TPU_NO_NATIVE", None)
    row["host_path"] = {"nodes": len(parents), **timings}

    # 4 canonical updates from the ingested --data-root, then the evaluation
    ds = create_hatespeech_dataset(root=data)
    save_dir = os.path.join(root, "run")
    flags = CANONICAL_FLAGS + ["--data-root", data, "--max-updates", str(INGEST_UPDATES), "--seed", str(seed + 5),
                               "--save-dir", save_dir]
    cfg = config_from_args(build_parser().parse_args(flags))
    torch.cuda.empty_cache()
    _zero_counts()
    with _RecordedUpdates(cfg.model) as rec:
        rc, out = _main_quiet(flags)
    launches = dict(zip(KERNEL_NAMES, _counts()))
    if rc != 0:
        raise AssertionError(f"ingest: training from the ingested data returned {rc}:\n{out[-3000:]}")
    rec.check_launches("ingest training", launches)
    per_update = [dict(zip(KERNEL_NAMES, r["launches"])) for r in rec.records]
    tree = [[u[n] for n in ("tree_attention_fwd_fused", "tree_attention_bwd_dq_fused", "tree_attention_bwd_dkv_fused")]
            for u in per_update]
    losses = [r["loss"] for r in rec.records]
    if len(rec.records) != INGEST_UPDATES or any(t != [30, 24, 24] for t in tree):
        raise AssertionError(f"ingest: tree launches per update {tree}, expected 30 / 24 / 24 each")
    if not all(np.isfinite(losses)) or len(set(losses)) < 2:
        raise AssertionError(f"ingest: loss series not finite or constant: {losses}")
    ms = [r["ms"] for r in rec.records]
    row["train"] = {"graphs": len(ds), "train": len(ds.train_idx), "test": len(ds.test_idx), "loss": losses,
                    "update_ms": ms, "update_ms_median": float(np.median(ms)),
                    "max_memory_allocated_gb": max(r["peak_gb"] for r in rec.records),
                    "tree_launches_per_update": tree, "test": _test_metrics(out)}
    pred = os.path.join(root, "pred")
    t = time.perf_counter()
    rc, out = _main_quiet(flags + ["--eval-only", "--valid-subset", "test", "--predict-output", pred])
    written = re.search(r"wrote (\d+) per-node rows", out)
    test_nodes = sum(ds.get(int(i)).num_nodes for i in ds.test_idx)
    if rc != 0 or not written or int(written.group(1)) != test_nodes:
        raise AssertionError(f"ingest: --eval-only --predict-output returned {rc}, wrote "
                             f"{written and written.group(1)} rows for {test_nodes} test nodes:\n{out[-2000:]}")
    row["eval"] = {"seconds": time.perf_counter() - t, "rows": test_nodes, "test": _test_metrics(out)}
    row["launches"] = launches
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return {"launches": launches, "data": data, "flags": flags, "save_dir": save_dir}


def hf_published_state_dicts(cfg, seed: int):
    """HF-named ``bert-base-uncased`` (``BertForSequenceClassification``)
    and ``google/vit-base-patch16-224`` (``ViTModel``, keys under ``vit.``)
    state dicts at their published shapes, random from ``seed``; and each
    mapped HF tensor's port name under the reference's layer split (the top
    ``num_fusion_layers + 1`` layers feed the fusion stacks)."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.utils import hf_import as hfi
    from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import _stack_sizes

    t, v = cfg.text_tower, cfg.image_tower
    d, gen = t.hidden_size, torch.Generator().manual_seed(seed)
    layer_shapes = {"attention.query": (d, d), "attention.key": (d, d), "attention.value": (d, d),
                    "attention_output_dense": (d, d), "intermediate_dense": (t.intermediate_size, d),
                    "output_dense": (d, t.intermediate_size), "dense": (d, d)}  # else a layer norm's (d,)
    sds, names = ({}, {}), {}

    def put(which, hf_key, port_key, shape):
        sds[which][hf_key] = torch.randn(shape, generator=gen) * 0.02
        if port_key is not None:
            names[(which, hf_key)] = port_key

    def modules(which, hf_prefix, port_prefix, pairs):
        for src, dst in pairs:
            shape = layer_shapes.get(dst)
            put(which, f"{hf_prefix}.{src}.weight", port_prefix and f"{port_prefix}.{dst}.weight", shape or (d,))
            put(which, f"{hf_prefix}.{src}.bias", port_prefix and f"{port_prefix}.{dst}.bias", (shape or (d,))[:1])

    split = cfg.num_fusion_layers + 1
    fusion = [(i, j) for i, size in enumerate(_stack_sizes(split, cfg.num_fusion_stack)) for j in range(size)]
    e = "graph_encoder.text_model.embeddings"
    put(0, "bert.embeddings.word_embeddings.weight", f"{e}.word_embeddings.weight", (t.vocab_size, d))
    put(0, "bert.embeddings.position_embeddings.weight", f"{e}.position_embeddings.weight", (t.max_position_embeddings, d))
    put(0, "bert.embeddings.token_type_embeddings.weight", f"{e}.token_type_embeddings.weight", (t.type_vocab_size, d))
    modules(0, "bert.embeddings", e, (("LayerNorm", "layernorm"),))
    for i in range(t.num_hidden_layers):
        k = i - (t.num_hidden_layers - split)
        port = (f"graph_encoder.text_model.layer_{i}" if k < 0 else
                f"graph_encoder.fusion_stack_{fusion[k][0]}.fusion_{fusion[k][1]}.bert_encoder")
        modules(0, f"bert.encoder.layer.{i}", port, hfi.BERT_LAYER)
    modules(0, "bert", "text_pooler", (("pooler.dense", "dense"),))
    put(0, "classifier.weight", "node_classifier.weight", (cfg.num_classes, d))
    put(0, "classifier.bias", "node_classifier.bias", (cfg.num_classes,))
    e = "graph_encoder.vit_model.embeddings"
    patches = (v.image_size // v.patch_size) ** 2
    put(1, "vit.embeddings.cls_token", f"{e}.cls_token", (1, 1, d))
    put(1, "vit.embeddings.position_embeddings", f"{e}.position_embeddings", (1, patches + 1, d))
    put(1, "vit.embeddings.patch_embeddings.projection.weight", f"{e}.patch_embeddings.weight",
        (d, v.num_channels, v.patch_size, v.patch_size))
    put(1, "vit.embeddings.patch_embeddings.projection.bias", f"{e}.patch_embeddings.bias", (d,))
    for i in range(v.num_hidden_layers):
        k = i - (v.num_hidden_layers - split)
        port = (f"graph_encoder.vit_model.layer_{i}" if k < 0 else
                f"graph_encoder.fusion_stack_{fusion[k][0]}.fusion_{fusion[k][1]}.vit_encoder")
        modules(1, f"vit.encoder.layer.{i}", port, hfi.VIT_LAYER)
    modules(1, "vit", "graph_encoder.vit_model", (("layernorm", "layernorm"),))
    modules(1, "vit", None, (("pooler.dense", "dense"),))  # ViTModel's pooler: the port has none
    return sds[0], sds[1], names


HF_SNAPSHOT = "0123456789abcdef0123456789abcdef01234567"  # the cache's revision (any 40 hex digits)
HF_TEXT, HF_IMAGE = "bert-base-uncased", "google/vit-base-patch16-224"


def write_safetensors(path: str, tensors: dict) -> int:
    """``tensors`` (name -> CPU tensor) as a safetensors file, written by
    hand (8 bytes of little-endian header length, the JSON header, the raw
    bytes; the header padded to 8 bytes); its size in bytes."""
    import torch

    codes = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.int64: "I64"}
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().data if t.numel() else b"")
    return os.path.getsize(path)


def write_hf_cache(cache: str, cfg, seed: int):
    """An HF hub cache at ``cache`` holding ``hf_published_state_dicts`` as
    the published checkpoints are stored: ``models--bert-base-uncased``, a
    ``BertForPreTraining`` ``model.safetensors`` with the TF-era
    ``LayerNorm.gamma`` / ``.beta`` names and the ``cls.*`` pretraining
    heads (no classifier, no tied decoder weight), and
    ``models--google--vit-base-patch16-224``, a ``ViTForImageClassification``
    ``pytorch_model.bin`` with a 1000-label classifier (no pooler), each
    with its ``config.json`` and ``refs/main``. Returns (bert_sd, vit_sd,
    names, bytes written)."""
    import torch

    bert_sd, vit_sd, names = hf_published_state_dicts(cfg, seed)
    t, v = cfg.text_tower, cfg.image_tower
    d, gen = t.hidden_size, torch.Generator().manual_seed(seed + 1)

    def snapshot(name):
        repo = os.path.join(cache, "models--" + name.replace("/", "--"))
        os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
        with open(os.path.join(repo, "refs", "main"), "w") as f:
            f.write(HF_SNAPSHOT)
        path = os.path.join(repo, "snapshots", HF_SNAPSHOT)
        os.makedirs(path, exist_ok=True)
        return path

    text = {k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias", "LayerNorm.beta"): x
            for k, x in bert_sd.items() if not k.startswith("classifier.")}
    heads = {"cls.predictions.bias": (t.vocab_size,), "cls.predictions.transform.dense.weight": (d, d),
             "cls.predictions.transform.dense.bias": (d,), "cls.predictions.transform.LayerNorm.gamma": (d,),
             "cls.predictions.transform.LayerNorm.beta": (d,), "cls.seq_relationship.weight": (2, d),
             "cls.seq_relationship.bias": (2,)}
    text.update({k: torch.randn(shape, generator=gen) * 0.02 for k, shape in heads.items()})
    path = snapshot(HF_TEXT)
    nbytes = write_safetensors(os.path.join(path, "model.safetensors"), text)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["BertForPreTraining"], "model_type": "bert", "vocab_size": t.vocab_size,
                   "hidden_size": d, "num_hidden_layers": t.num_hidden_layers,
                   "num_attention_heads": t.num_attention_heads, "intermediate_size": t.intermediate_size,
                   "max_position_embeddings": t.max_position_embeddings, "type_vocab_size": t.type_vocab_size,
                   "hidden_act": "gelu", "initializer_range": 0.02, "layer_norm_eps": 1e-12,
                   "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1, "pad_token_id": 0}, f)
    image = {k: x for k, x in vit_sd.items() if not k.startswith("vit.pooler.")}
    image["classifier.weight"] = torch.randn(1000, d, generator=gen) * 0.02
    image["classifier.bias"] = torch.zeros(1000)
    path = snapshot(HF_IMAGE)
    torch.save(image, os.path.join(path, "pytorch_model.bin"))
    nbytes += os.path.getsize(os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["ViTForImageClassification"], "model_type": "vit", "hidden_size": d,
                   "num_hidden_layers": v.num_hidden_layers, "num_attention_heads": v.num_attention_heads,
                   "intermediate_size": v.intermediate_size, "image_size": v.image_size, "patch_size": v.patch_size,
                   "num_channels": v.num_channels, "qkv_bias": True, "hidden_act": "gelu", "layer_norm_eps": 1e-12,
                   "initializer_range": 0.02, "id2label": {str(i): f"LABEL_{i}" for i in range(1000)}}, f)
    return bert_sd, vit_sd, names, nbytes


def phase_weights_in(seed: int, card: str, root: str, ingest_run: dict) -> dict:
    """Weights from outside the port into the canonical model on the card:
    the reference's (FairSeq) state dict with one legacy fused qkv, HF
    BERT-base and ViT-base state dicts, and a JAX Orbax step in the layout
    ``tools/orbax_to_npz.py`` writes, restored with ``--restore-file``."""
    import contextlib
    import io

    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset import create_hatespeech_dataset
    from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
    from multimodaldiscussiontransformer_tpu_torch.serve.incremental import DiscussionScorer
    from multimodaldiscussiontransformer_tpu_torch.tasks.node_prediction import NodePredictionTask
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args
    from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer
    from multimodaldiscussiontransformer_tpu_torch.utils import checkpoints as ckpt
    from multimodaldiscussiontransformer_tpu_torch.utils import hf_import as hfi
    from multimodaldiscussiontransformer_tpu_torch.utils import reference_import as ri
    from multimodaldiscussiontransformer_tpu_torch.utils.debugging import find_nonfinite

    t_phase = time.perf_counter()
    seconds, last = {}, [t_phase]

    def mark(step):
        now = time.perf_counter()
        seconds[step], last[0] = now - last[0], now

    cfg = ModelConfig()
    src = MDTModel(cfg, generator=torch.Generator().manual_seed(seed)).state_dict()
    rng = np.random.default_rng(seed)
    batch = [make_discussion(rng, int(rng.integers(16, 25)), 0.2) for _ in range(3)]  # the scoring phase's first batch

    def score(state_dict):
        """(probabilities of each discussion of the batch, tree launches)."""
        with torch.device("meta"):
            model = MDTModel(cfg)
        model.load_state_dict(state_dict, strict=True, assign=True)
        scorer = DiscussionScorer(model, device="cuda", image_shape=IMAGE_SHAPE)
        _zero_counts()
        probs = [scorer.score(d) for d in batch]
        launches = dict(zip(KERNEL_NAMES, _counts()))
        del scorer, model
        torch.cuda.empty_cache()
        if launches["tree_attention_fwd_fused"] != LAUNCHES_PER_FORWARD * len(batch) or any(
                n for k, n in launches.items() if k != "tree_attention_fwd_fused"):
            raise AssertionError(f"weights_in: scoring launched {launches}")
        if not all(np.isfinite(p).all() and np.abs(p.sum(-1) - 1).max() <= 1e-5 for p in probs):
            raise AssertionError("weights_in: bad probabilities")
        return probs

    want = score(src)
    mark("source")

    # the reference route: export, fuse one layer's q/k/v into the legacy
    # in_proj_weight / in_proj_bias, import into a model of no weights
    ref = ri.export_reference_state_dict(src, cfg)
    base = "encoder.graph_encoder.layers.3.layers.1.self_attn."
    for leaf in ("weight", "bias"):
        ref[f"{base}in_proj_{leaf}"] = np.concatenate([ref.pop(f"{base}{p}_proj.{leaf}") for p in "qkv"])
    with torch.device("meta"):
        empty = MDTModel(cfg).state_dict()
    imported = ri.import_reference_checkpoint(empty, cfg, {"model": ref})
    differ = sorted(k for k, v in src.items() if not torch.equal(imported[k], v))
    got = score(imported)
    if differ or not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"weights_in: the reference route changed {differ[:5]} or the scores")
    reference = {"tensors": len(ref), "legacy_qkv": base + "in_proj_weight", "scores_bit_equal": True}
    del ref, imported
    mark("reference")

    # the HF route: BERT-base and ViT-base at their published shapes, in
    # memory and as files in an HF cache read back by --hf-init's reader
    cache = os.path.join(root, "hf_cache")
    bert_sd, vit_sd, names, nbytes = write_hf_cache(cache, cfg, seed + 6)
    mark("hf_write")
    saved_env = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = cache
    try:
        t = time.perf_counter()
        file_bert, file_vit = hfi.state_dicts_from_pretrained(HF_TEXT, HF_IMAGE, seed=seed)
        read_s = time.perf_counter() - t
        # a name that is in no cache: the launcher exits non-zero, naming it
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            missing_rc, _ = _main_quiet(["--synthetic", "--hf-init", "--text-encoder", "no-such-org/no-bert",
                                         "--no-save", "--max-updates", "1"])
        missing_out = err.getvalue()
    finally:
        if saved_env is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved_env
    if missing_rc == 0 or "models--no-such-org--no-bert" not in missing_out:
        raise AssertionError(f"weights_in: --hf-init of a missing name returned {missing_rc}:\n{missing_out[-1500:]}")
    classifier = {k: torch.from_numpy(file_bert[k]) for k in ("classifier.weight", "classifier.bias")}
    if (classifier["classifier.weight"].shape != (2, cfg.text_tower.hidden_size)
            or classifier["classifier.bias"].any()):
        raise AssertionError("weights_in: the drawn classifier's shape or bias")
    unequal = [k for k, x in [*bert_sd.items(), *vit_sd.items()] if not k.startswith(("classifier.", "vit.pooler."))
               and not torch.equal(torch.from_numpy((file_bert if k in file_bert else file_vit)[k]), x)]
    extra = sorted(set(file_bert) - set(bert_sd)) + sorted(set(file_vit) - set(vit_sd))
    if unequal or extra or any(k.startswith("vit.pooler.") for k in file_vit):
        raise AssertionError(f"weights_in: the files read back differ at {unequal[:4]}, extra {extra[:4]}")
    bert_sd.update(classifier)  # the in-memory route takes the classifier the reader drew
    imported = hfi.import_towers(src, cfg, bert_sd, vit_sd)
    bad = [(w, k) for (w, k), port in names.items() if not torch.equal(imported[port], (bert_sd, vit_sd)[w][k])]
    mapped = set(names.values())
    kept = [k for k in src if k not in mapped and not torch.equal(imported[k], src[k])]
    if bad or kept:
        raise AssertionError(f"weights_in: HF tensors not carried {bad[:4]}, others changed {kept[:4]}")
    from_files = hfi.import_towers(src, cfg, file_bert, file_vit)
    state_differs = [k for k in imported if not torch.equal(imported[k], from_files[k])]
    hf_probs = score(imported)
    file_probs = score(from_files)
    if state_differs or not all(np.array_equal(a, b) for a, b in zip(hf_probs, file_probs)):
        raise AssertionError(f"weights_in: the files' import differs from the in-memory one at {state_differs[:4]} "
                             "or in its scores")
    hf = {"bert_tensors": len(bert_sd), "vit_tensors": len(vit_sd), "mapped": len(names), "transposed": 0,
          "probabilities_finite": True, "differ_from_source": not all(np.array_equal(a, b) for a, b in zip(hf_probs, want)),
          "files": {"bytes": nbytes, "read_seconds": read_s, "read_gb_per_s": nbytes / read_s / 1e9,
                    "state_bit_equal": True, "scores_bit_equal": True, "missing_name_rc": missing_rc}}
    print(json.dumps({"weights_in_hf_files": hf["files"], "card": card}), flush=True)
    del bert_sd, vit_sd, file_bert, file_vit, imported, from_files
    shutil.rmtree(cache, ignore_errors=True)
    mark("hf")

    # the Orbax route: the ingest run's own checkpoint (update 4) restored
    # and written again in the converter's layout, then restored with
    # --restore-file into a run to update 6; its first update against the
    # same update from the port's checkpoint, with the same dropout bits
    flags, own_dir, step = ingest_run["flags"][:-2], ingest_run["save_dir"], INGEST_UPDATES
    npz = os.path.join(root, f"jax-step-{step}.npz")
    pcfg = config_from_args(build_parser().parse_args(flags))
    ds = create_hatespeech_dataset(root=ingest_run["data"])
    trainer = NodePredictionTask(pcfg).build_trainer(image_shape=IMAGE_SHAPE, device="cuda")

    def own_state():
        restored = ckpt.Checkpointer(own_dir).restore(step=step)
        return ckpt.restore_params_into_state(trainer, trainer.init_state(params=restored["params"]), restored,
                                              reset_optimizer=False)

    state = own_state()
    counters = (state.step, state.num_updates, state.epoch)
    t = time.perf_counter()
    ckpt.save_flax_npz(npz, state)
    npz_s = time.perf_counter() - t
    # off the card during the restored run, whose big discussions take ~70 GB
    # at their peak (``ingest``); built again from the same checkpoint after
    del state
    torch.cuda.empty_cache()
    mark("own_and_npz")

    first = {}  # of the restored run's first update: generators, counters and moments before it, params after

    def capture(orig):
        def step_(trainer, state, group, **kw):
            if not first:
                first["rngs"] = (state.host_rng.get_state(), state.device_rng.get_state())
                first["counters"] = (state.step, state.num_updates, state.epoch)
                opt = state.optimizer.state
                first["adam"] = [(int(opt[p]["step"]), opt[p]["exp_avg"].clone(), opt[p]["exp_avg_sq"].clone())
                                 for p in state.trainable]
            logs = orig(trainer, state, group, **kw)
            if "params" not in first:
                by_id = {id(p): n for n, p in state.model.named_parameters()}
                first["params"] = {by_id[id(p)]: p.detach().clone() for p in state.trainable}
            return logs
        return step_

    orig = Trainer.train_step
    Trainer.train_step = capture(orig)
    _zero_counts()
    try:
        rc, out = _main_quiet(flags + ["--restore-file", npz, "--max-updates", str(step + 2), "--no-save",
                                       "--save-dir", os.path.join(root, "from_npz")])
    finally:
        Trainer.train_step = orig
    launches = dict(zip(KERNEL_NAMES, _counts()))
    if rc != 0 or f"restored from {npz}" not in out or first.get("counters") != counters:
        raise AssertionError(f"weights_in: --restore-file {npz} returned {rc}, counters {first.get('counters')} "
                             f"(the checkpoint's {counters}):\n{out[-2000:]}")
    mark("restore_run")

    # the same update from the port's own checkpoint, with the restored run's generators
    state = own_state()
    opt = state.optimizer.state
    if any(count != step or not torch.equal(opt[p]["exp_avg"], m) or not torch.equal(opt[p]["exp_avg_sq"], v)
           for p, (count, m, v) in zip(state.trainable, first.pop("adam"))):
        raise AssertionError("weights_in: the moments restored from the npz differ from the port checkpoint's")
    order = {id(p): n for n, p in state.model.named_parameters()}
    trainable = [order[id(p)] for p in state.trainable]
    state.host_rng.set_state(first["rngs"][0])
    state.device_rng.set_state(first["rngs"][1])
    state = trainer.fit(ds, state=state, max_updates=step + 1, log_fn=lambda m: None)
    worst = 0.0
    for name, p in zip(trainable, state.trainable):
        a, b = p.detach().float(), first["params"][name].float()
        err = float(((a - b).abs() - RESTORE_RTOL * b.abs()).max())
        worst = max(worst, float((a - b).abs().max()))
        if err > RESTORE_ATOL:
            raise AssertionError(f"weights_in: {name} after the restored update differs by {worst}")
    nonfinite = find_nonfinite({"params": state.model.state_dict(), "optimizer": state.optimizer.state_dict()})
    if nonfinite:
        raise AssertionError(f"weights_in: non-finite tensors in the trained state: {nonfinite[:5]}")
    orbax = {"npz_bytes": os.path.getsize(npz), "npz_write_seconds": npz_s, "moments_bit_equal": True,
             "restored_counters": first["counters"], "first_update_max_abs_diff": worst,
             "rtol": RESTORE_RTOL, "atol": RESTORE_ATOL, "nonfinite": nonfinite}
    del state, trainer, first
    torch.cuda.empty_cache()
    mark("compare")
    row = {"phase": "weights_in", "card": card, "config": "ModelConfig(), bfloat16 compute over float32 params",
           "reference": reference, "hf": hf, "orbax": orbax, "launches": launches,
           "seconds_by_step": seconds, "seconds": time.perf_counter() - t_phase}
    emit(row)
    return launches


# parallel: training across ranks through the launcher (one process per
# rank, FairSeq's flags). The canonical bf16 runs (3 updates at lr 1e-4 from
# the first update: every step far above a float32 ulp) are held to the
# one-process run: losses and gradient norms of every update within
# RESUME_LOSS_RTOL, and the direction of the params' change: AdamW's step is
# about +-lr per element, its sign noise where the gradient is, and bf16
# rounds the two layouts' gradients differently, so the sign of each element
# that moved by at least half the largest change agrees in
# PARALLEL_SIGN_AGREEMENT of them (a rank that stepped on its own slice's
# gradient agrees in far fewer). Beside them, and not held, a second
# one-process run over the same discussions in one rank's microbatches
# (batch 12 / ranks, update-freq 3 x ranks): how far bf16 rounding alone
# moves this trajectory. The tiny float32 runs (2 updates, a save after
# each) as train_cpu_agreement: the loss and gradient norm of both updates
# within rtol 2e-4, the params after the first update in its two-tier check.
# The gradient norm is what sees the scale of a reduction (a mean where a sum
# belongs): AdamW's first step is about lr * sign(g) whatever that scale.
PARALLEL_UPDATES = 3
PARALLEL_SIGN_AGREEMENT = 0.95
PARALLEL_LR = ["--lr", "1e-4", "--warmup-updates", "1"]
TINY_UPDATES = 2
PARALLEL_GRAPHS = 240  # 192 train graphs: 16 global batches of 12
# with one card the ranks' collectives go through the host over gloo (a tp=2
# update of 3 microbatches took ~17 s), so there the canonical runs take one
# microbatch an update (--update-freq 1) over fewer discussions: 48 train
# graphs, 4 global batches of 12 an epoch (the stop run's 12 updates in 3)
PARALLEL_GRAPHS_ONE_CARD = 60
PARALLEL_RANK_TIMEOUT = 420  # seconds for one rank's whole plan
NO_DROPOUT = ["--dropout", "0", "--attention-dropout", "0", "--act-dropout", "0"]
TINY_FLAGS = ["--synthetic", "--tiny", "--lr", "1e-3", "--warmup-updates", "2", "--total-num-update", "20", "--update-freq", "3",
              "--node-capacity-buckets", "128", "--image-capacity-buckets", "32", "--label-capacity-buckets", "64",
              "--log-interval", "1", "--validate-interval-updates", "0", "--synthetic-graphs", "40", *NO_DROPOUT]
H6 = 6  # the heads of one rank under tp=2 at ModelConfig() width


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _digest(t) -> list:
    """Sum, sum of |x| and a position-weighted sum of a tensor, in float64."""
    import torch

    d = t.detach().double().flatten()
    if d.numel() == 0:
        return [0.0, 0.0, 0.0]
    w = torch.arange(d.numel(), device=d.device, dtype=torch.float64).remainder_(7).add_(1)
    return [float(d.sum()), float(d.abs().sum()), float((d * w).sum())]


class _RankRecorder:
    """Patches ``Trainer.train_step`` in a rank process (one launch) to
    record what the rank starts from: the first group it trains on (its
    ``idx`` and a digest of each field) and the logging outputs of update
    1."""

    def __init__(self):
        self.rec = {"group": {}, "update1": {}}

    def __enter__(self):
        import torch

        from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

        rec = self.rec
        self._orig = train_step = Trainer.train_step

        def patched_step(trainer, state, group, **k):
            if not rec["update1"]:
                rec["group"] = {key: _digest(torch.as_tensor(v)) for key, v in group.items()}
                rec["group"]["idx_values"] = torch.as_tensor(group["idx"]).cpu().flatten().tolist()
            sums = train_step(trainer, state, group, **k)
            if not rec["update1"]:
                rec["update1"] = {key: float(v) for key, v in sums.items()
                                  if isinstance(v, torch.Tensor) and v.numel() == 1}
            return sums

        Trainer.train_step = patched_step
        return self

    def __exit__(self, *exc):
        from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

        Trainer.train_step = self._orig
        return False


def _rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b)) if a else 0.0


def rank_divergence(got: dict, want: dict, rtol: float = 1e-6) -> dict:
    """Where one rank's ``_RankRecorder`` record parts from another run's
    same rank: the first-group fields whose digests differ (relative
    difference above ``rtol``), whether the group's idx agree, and update
    1's logging outputs."""
    return {"update1": got["update1"], "update1_reference": want["update1"],
            "same_group": got["group"].get("idx_values") == want["group"].get("idx_values"),
            "group_differs": [k for k in want["group"] if k != "idx_values"
                              and _rel(got["group"].get(k, [0, 0, 0]), want["group"][k]) > rtol]}


def parallel_rank_worker(plan_path: str, rank: int, out_path: str) -> int:
    """One rank of a parallel plan: ``train.launch.main`` of each entry's
    argv (``{rank}`` filled in), or the function ``SP_RANK_CALLS[call]``
    of an entry with a ``call`` (its ``result`` kept), in turn, in this
    process, with the kernel counts zeroed before and read after each run,
    its seconds, its stdout and this rank's peak memory; the results go to
    ``out_path`` after each run."""
    import contextlib
    import faulthandler
    import io
    import signal

    import torch

    from multimodaldiscussiontransformer_tpu_torch.train import launch

    faulthandler.register(signal.SIGUSR1, all_threads=True)  # run_ranks asks for the stacks of a rank that hangs
    torch.backends.cuda.matmul.allow_tf32 = False  # as main sets them: the float32 runs are compared
    torch.backends.cudnn.allow_tf32 = False
    with open(plan_path) as f:
        plan = json.load(f)
    results = []
    for item in plan:
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        buf = io.StringIO()
        t = time.perf_counter()
        result = None
        record = None
        with contextlib.redirect_stdout(buf):
            if "call" in item:  # a function of this script over a group of its own
                rc, result = 0, SP_RANK_CALLS[item["call"]](rank, **item["kwargs"])
            else:
                with _RankRecorder() as recorder:
                    rc = launch.main([a.replace("{rank}", str(rank)) for a in item["argv"]])
                record = recorder.rec
        seconds = time.perf_counter() - t
        counts = dict(zip(KERNEL_NAMES, _counts()))
        results.append({"name": item["name"], "rc": rc, "seconds": seconds, "counts": counts,
                        "peak_gb": torch.cuda.max_memory_allocated() / 2**30, "stdout": buf.getvalue()[-4000:],
                        "result": result, "record": record})
        with open(out_path + ".tmp", "w") as f:
            json.dump(results, f)
        os.replace(out_path + ".tmp", out_path)
        if rc != 0:
            return rc
    return 0


def run_ranks(plan, n: int, root: str, stop=None):
    """Run ``plan`` on ``n`` rank processes (``chip_smoke.py
    --parallel-rank``); ``stop`` = (entry name, save dir, update): SIGTERM
    to rank 1 alone once rank 0's metrics show that update of that entry.
    Returns each rank's results; raises if a rank fails or outlives
    ``PARALLEL_RANK_TIMEOUT``."""
    import signal

    plan_path = os.path.join(root, f"plan-{len(os.listdir(root))}.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2) // n))}
    outs = [f"{plan_path}.rank{r}.json" for r in range(n)]
    logs = [open(f"{plan_path}.rank{r}.log", "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"), "--parallel-rank", str(r),
                               "--parallel-plan", plan_path, "--parallel-out", outs[r]],
                              cwd=here, env=env, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(n)]
    sent = {}
    t0 = time.perf_counter()

    def tails():
        out = []
        for r in range(n):
            with open(f"{plan_path}.rank{r}.log") as f:
                out.append(f"--- rank {r} (rc {procs[r].poll()}):\n{f.read()[-3000:]}")
        return "\n".join(out)

    try:
        while any(p.poll() is None for p in procs):
            # a rank that failed leaves the others waiting in a collective
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed:
                raise AssertionError(f"parallel rank(s) {failed} failed:\n{tails()}")
            if time.perf_counter() - t0 > PARALLEL_RANK_TIMEOUT:
                for p in procs:  # each rank's stacks into its log (faulthandler)
                    p.send_signal(signal.SIGUSR1)
                time.sleep(3)
                raise AssertionError(f"parallel ranks still running after {PARALLEL_RANK_TIMEOUT} s:\n{tails()}")
            if stop is not None and not sent and os.path.exists(os.path.join(stop[1], "metrics.jsonl")):
                with open(os.path.join(stop[1], "metrics.jsonl")) as f:  # whole lines only: rank 0 is writing
                    steps = [json.loads(ln)["step"] for ln in f if '"train"' in ln and ln.endswith("\n")]
                if steps and max(steps) >= stop[2]:
                    procs[1].send_signal(signal.SIGTERM)
                    sent["at_update"] = max(steps)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    results = []
    for r, p in enumerate(procs):
        if p.returncode != 0 or not os.path.exists(outs[r]):
            raise AssertionError(f"parallel rank {r} exited {p.returncode}:\n{tails()}")
        with open(outs[r]) as f:
            results.append(json.load(f))
    if stop is not None and not sent:
        raise AssertionError("the stop request was never sent")
    return results, sent


def _launch_in_process(argv):
    """``train.launch.main`` here, kernel counts zeroed before and read
    after: (rc, stdout, seconds, counts, peak GB)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t = time.perf_counter()
    rc, out = _main_quiet(argv)
    return rc, out, time.perf_counter() - t, dict(zip(KERNEL_NAMES, _counts())), \
        torch.cuda.max_memory_allocated() / 2**30


def _ms_per_update(save_dir: str) -> float:
    """Median ms per update after the first, from rank 0's metrics (log
    interval 1: ``ups`` is one update's rate)."""
    import numpy as np

    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        ups = [r["ups"] for r in map(json.loads, f) if r["split"] == "train" and r["step"] > 1]
    return float(np.median([1e3 / u for u in ups]))


def _trainable_state(save_dir: str, step: int):
    import torch

    from multimodaldiscussiontransformer_tpu_torch.train.optimizer import FROZEN_PREFIXES

    st = torch.load(os.path.join(save_dir, str(step), "state.pt"), map_location="cpu", weights_only=True)
    return {k: v for k, v in st["params"].items() if not any(p in k for p in FROZEN_PREFIXES)}, st


def _train_records(save_dir: str) -> dict:
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f) if r["split"] == "train"}


def _agreement(got_dir, want_dir, init, step: int, float32: bool, lr0: float = 0.0, param_step=None) -> dict:
    """Two runs' logged loss and gradient norm at every update and their
    trainable params: bf16 (``float32`` False) losses and norms within
    RESUME_LOSS_RTOL and the sign of the change since ``init`` to ``step``
    of the elements that moved most agreeing in PARALLEL_SIGN_AGREEMENT of
    them; float32 losses and norms within AGREE_GRAD_RTOL and the params at
    ``param_step`` (default ``step``) within the AGREE tolerances (a param
    whose update was noise-sized within 2.05 lr0). The numbers, with
    ``failed``: what disagreed, or None."""
    import torch

    rg, rw = _train_records(got_dir), _train_records(want_dir)
    if sorted(rg) != sorted(rw):
        return {"failed": f"updates logged {sorted(rg)} against {sorted(rw)}"}

    def rel(key):
        return max(abs(rg[s][key] - rw[s][key]) / max(abs(rw[s][key]), 1e-12) for s in rw)

    loss_rel, gnorm_rel = rel("loss"), rel("gnorm")
    out = {"updates": len(rw), "loss_rel": loss_rel, "gnorm_rel": gnorm_rel,
           "losses": [rg[s]["loss"] for s in sorted(rg)], "losses_one_process": [rw[s]["loss"] for s in sorted(rw)],
           "gnorms": [rg[s]["gnorm"] for s in sorted(rg)], "gnorms_one_process": [rw[s]["gnorm"] for s in sorted(rw)],
           "failed": None}
    if float32:
        at = step if param_step is None else param_step
        got, _ = _trainable_state(got_dir, at)
        want, _ = _trainable_state(want_dir, at)
        bad, err = [], 0.0
        for k, w in want.items():
            g, s = got[k].float(), init[k].float()
            moved = (w - s).abs() > 0.5 * lr0
            e = (g - w).abs()
            err = max(err, e.max().item())
            if not ((e[moved] <= AGREE_PARAM_ATOL + AGREE_PARAM_RTOL * w[moved].abs()).all()
                    and (e <= 2.05 * lr0 + 1e-7).all()):
                bad.append(k)
        out.update(params_at_update=at, max_abs_err_param=err,
                   tolerance={"loss_rtol": AGREE_GRAD_RTOL, "gnorm_rtol": AGREE_GRAD_RTOL,
                              "param_rtol": AGREE_PARAM_RTOL, "param_atol": AGREE_PARAM_ATOL, "noise_atol": 2.05 * lr0})
        if loss_rel > AGREE_GRAD_RTOL or gnorm_rel > AGREE_GRAD_RTOL or bad:
            out["failed"] = f"float32: loss rel {loss_rel}, gnorm rel {gnorm_rel}, params {bad[:5]}"
        return out
    got, _ = _trainable_state(got_dir, step)
    want, _ = _trainable_state(want_dir, step)
    dg = {k: got[k].float() - init[k].float() for k in want}
    dw = {k: want[k].float() - init[k].float() for k in want}
    change = max(d.abs().max().item() for d in dw.values())
    same = moved = 0
    diff_sq = ref_sq = 0.0
    for k in want:
        big = dw[k].abs() >= 0.5 * change
        moved += int(big.sum())
        same += int((torch.sign(dg[k][big]) == torch.sign(dw[k][big])).sum())
        diff_sq += float((dg[k] - dw[k]).double().square().sum())
        ref_sq += float(dw[k].double().square().sum())
    agreement = same / max(moved, 1)
    out.update(max_change=change, elements_moved=moved, sign_agreement=agreement,
               rel_l2_change_diff=math.sqrt(diff_sq / max(ref_sq, 1e-30)),
               tolerance={"loss_rtol": RESUME_LOSS_RTOL, "gnorm_rtol": RESUME_LOSS_RTOL,
                          "sign_agreement": PARALLEL_SIGN_AGREEMENT})
    if loss_rel > RESUME_LOSS_RTOL or gnorm_rel > RESUME_LOSS_RTOL or agreement < PARALLEL_SIGN_AGREEMENT or moved == 0:
        out["failed"] = f"bf16: loss rel {loss_rel}, gnorm rel {gnorm_rel}, sign agreement {agreement} over {moved}"
    return out


def _hold(checks: dict) -> dict:
    """``checks``, or AssertionError naming every one whose ``failed`` is set."""
    bad = {name: c["failed"] for name, c in checks.items() if c.get("failed")}
    if bad:
        raise AssertionError(f"runs disagree with one process: {bad}")
    return checks


def _init_trainable(argv):
    """The trainable params a launcher run starts from (its seeded init)."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args
    from multimodaldiscussiontransformer_tpu_torch.train.optimizer import FROZEN_PREFIXES

    cfg = config_from_args(build_parser().parse_args(argv))
    model = MDTModel(cfg.model, generator=torch.Generator().manual_seed(cfg.seed))
    return {k: v for k, v in model.state_dict().items() if not any(p in k for p in FROZEN_PREFIXES)}


def parallel_h6_kernels(seed: int) -> dict:
    """The tree kernels (bf16 forward and backward pair) at the canonical
    graph shape and the tower kernels (bf16 forward and one-pass backward)
    at the text-fusion shape, with the H = 6 heads a rank runs under tp=2,
    rate 0.3: against their plain versions on the same inputs (within 1e-2
    of max |ref|, as kernel_vs_plain_train), timed beside the plain version,
    SDPA and the bound."""
    import torch
    import torch.nn.functional as F

    from multimodaldiscussiontransformer_tpu_torch.ops import masked_attention as ma
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # tree: S = 33, B = 12
    s, b, dh = 33, 12, 64
    template, ids, lut = (t.cuda() for t in compact_inputs(s, b, H6, seed))
    q, k, v, g = (torch.randn(b, H6, s, dh, generator=gen, device="cuda").bfloat16() for _ in range(4))
    kw = dict(rate=TRAIN_RATE, seed=seed + 6, scale=dh ** -0.5, double_add=True)
    if ta.kernel_route(q.dtype, dh) != "tensor_core":
        raise AssertionError("the H=6 tree check must take the tensor-core route")
    _zero_counts()
    got = _fwd_and_grads(ta.tree_attention, q, k, v, template, ids, lut, g, **kw)
    launched = dict(zip(KERNEL_NAMES, _counts()))
    want = _fwd_and_grads(lambda *a, **x: ta.tree_attention_dropout_reference(*a, **x), q, k, v, template, ids, lut, g,
                          **kw)
    tree_err = _check_errors(got, want, ("out", "dq", "dk", "dv", "dlut"), TRAIN_BF16_REL, "tree H=6")
    bias = ta.assemble_bias(template, ids, lut, True)
    shared = template.numel() * 4 + ids.numel() * 4 + lut.numel() * 4
    tree_bounds = work_bounds(b, H6, s, dh, "bfloat16", shared)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

    def fwd_bwd():
        o = ta.tree_attention(*leaves, template, ids, lut, **kw)
        o.backward(g)

    def plain_fwd_bwd():
        o = ta.tree_attention_dropout_reference(*leaves, template, ids, lut, **kw)
        o.backward(g)

    bias_bf = bias.bfloat16().contiguous()

    def library_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, attn_mask=bias_bf, dropout_p=TRAIN_RATE, scale=dh ** -0.5)
        o.backward(g)

    out["tree"] = {
        "B": b, "H": H6, "S": s, "dh": dh, "rate": TRAIN_RATE, "launches_check": launched, "errors": tree_err,
        "ms": {"fwd": time_cuda(lambda: ta.tree_attention(q, k, v, template, ids, lut, **kw), 20),
               "fwd_bwd": time_cuda(fwd_bwd, 20),
               "plain_fwd": time_cuda(lambda: ta.tree_attention_dropout_reference(q, k, v, template, ids, lut, **kw), 20),
               "plain_fwd_bwd": time_cuda(plain_fwd_bwd, 10),
               "library_fwd": time_cuda(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias_bf,
                                                                              dropout_p=TRAIN_RATE, scale=dh ** -0.5), 20),
               "library_fwd_bwd": time_cuda(library_fwd_bwd, 20)},
        "bound": tree_bounds,
    }
    # towers: text fusion, B = 256, S = 104, the 4 bottleneck columns open
    b, s = 256, 104
    key_bias = tower_key_bias(b, s, 4, torch.Generator(device="cuda").manual_seed(seed))
    q, k, v, g = (torch.randn(b, H6, s, dh, generator=gen, device="cuda").bfloat16() for _ in range(4))
    if ma.kernel_route(q.dtype, dh, s) != "tensor_core":
        raise AssertionError("the H=6 tower check must take the tensor-core route")

    def tower(fn, q_, k_, v_):
        leaves_ = [x.detach().clone().requires_grad_(True) for x in (q_, k_, v_)]
        o = fn(*leaves_, key_bias, seed=seed + 7, rate=MASKED_RATE, scale=dh ** -0.5)
        o.backward(g)
        return [o.detach()] + [x.grad for x in leaves_]

    _zero_counts()
    got = tower(ma.masked_attention, q, k, v)
    tlaunched = dict(zip(KERNEL_NAMES, _counts()))
    want = tower(ma.masked_attention_dropout_reference, q, k, v)
    tower_err = _check_errors(got, want, ("out", "dq", "dk", "dv"), TRAIN_BF16_REL, "tower H=6")
    mask4 = key_bias[:, None, None, :].bfloat16()
    out["tower"] = {
        "B": b, "H": H6, "S": s, "dh": dh, "rate": MASKED_RATE, "launches_check": tlaunched, "errors": tower_err,
        "ms": {"fwd": time_cuda(lambda: ma.masked_attention(q, k, v, key_bias, seed=1, rate=MASKED_RATE), 20),
               "fwd_bwd": time_cuda(lambda: tower(ma.masked_attention, q, k, v), 10),
               "plain_fwd": time_cuda(lambda: ma.masked_attention_dropout_reference(q, k, v, key_bias, 1, MASKED_RATE),
                                      10),
               "plain_fwd_bwd": time_cuda(lambda: tower(ma.masked_attention_dropout_reference, q, k, v), 5),
               "library_fwd": time_cuda(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4,
                                                                              dropout_p=MASKED_RATE), 20),
               "library_fwd_bwd": time_cuda(lambda: tower(lambda q_, k_, v_, m_, seed, rate, scale: (
                   F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask4, dropout_p=rate, scale=scale)),
                   q, k, v), 20)},
        "bound": work_bounds(b, H6, s, dh, "bfloat16", b * s * 4, stat_planes=2),
    }
    return out


def phase_parallel(seed: int, card: str = ""):
    """Training across ranks through the launcher, at ``ModelConfig()``
    width on the canonical setting (frozen towers, global batch 12 x 3):
    - the kernels at H = 6 (a tp=2 rank's heads) against their plain versions;
    - the one-process runs every parallel run is held against, in this
      process: canonical bf16 with dropout 0 (3 updates, a save), the tiny
      float32 node and contrastive runs (2 updates, a save after each);
      and, with 2 or more cards, the bf16 noise witness: the canonical run
      in one rank's microbatches, reported beside the checks;
    - NCCL at world size 1 (this process): dp, fsdp and tp, each the tiny
      float32 run against the unwrapped one;
    - with one card, 2 ranks on card 0 over gloo: dp=2 and tp=2 canonical
      (one microbatch an update, PARALLEL_GRAPHS_ONE_CARD discussions; the
      one-process runs the same) against the one-process run,
      ``--eval-only --predict-output`` at
      dp=2 against one process, the tiny float32 node and contrastive runs
      at dp=2, and a SIGTERM to rank 1 alone during a dp=2 run with
      dropout as in the recipe (both ranks save at the same update and
      exit 0; its ms per update);
    - with N = 2 or 4 cards (4 of more), NCCL with one rank per card: dp=N,
      fsdp=N, tp=2 x dp=N/2 and --num-slices 2 --fsdp, each canonical
      against the one-process run (ms per update, discussions/s, the
      scaling against one card and each rank's peak memory) and as the
      tiny float32 run.
    Which branch runs follows the card count, decided before any run. Every
    check is made before any failure is raised: the failure names each run
    that disagreed."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    branch = "nccl_one_rank_per_card" if cards >= 2 else "gloo_two_ranks_on_card_0"
    n = 4 if cards >= 4 else 2  # ranks: both divide the global batches 12 and 8
    print(json.dumps({"phase": "parallel_branch", "cards": cards, "branch": branch, "ranks": n}), flush=True)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="mdt_parallel_")
    result = {"phase": "parallel", "card": card, "cards": cards, "branch": branch}
    steps = {}
    t_step = time.perf_counter()

    def lap(name):
        nonlocal t_step
        steps[name] = time.perf_counter() - t_step
        t_step = time.perf_counter()

    try:
        result["h6_kernels"] = parallel_h6_kernels(seed)
        lap("h6_kernels")
        # the image ladder tops out at 128 so that a rank's slice of a
        # global batch fits its share (128 / ranks): 3 of these discussions
        # hold up to 18 images, over the 64 / 4 that the default ladder gives
        update_freq = 3 if cards >= 2 else 1
        canon = ["--synthetic", "--synthetic-graphs", str(PARALLEL_GRAPHS if cards >= 2 else PARALLEL_GRAPHS_ONE_CARD),
                 "--seed", str(seed + 1), *CANONICAL_FLAGS, "--update-freq", str(update_freq),
                 "--image-capacity-buckets", "0,8,16,32,64,128",
                 "--max-updates", str(PARALLEL_UPDATES), "--max-epoch", "1"]
        agree = NO_DROPOUT + PARALLEL_LR
        d = {name: os.path.join(root, name) for name in
             ("one", "witness", "one_tiny", "one_contrastive", "dp", "tp", "tiny_dp", "contrastive_dp", "stop", "fsdp",
              "slices", "tiny_fsdp", "tiny_tp", "tiny_slices", "pred_one", "pred_dp", "ws1_dp", "ws1_fsdp", "ws1_tp")}
        # one process: the runs every parallel run is held against
        one_argv = canon + agree + ["--save-dir", d["one"]]
        rc, out, seconds, counts, peak = _launch_in_process(one_argv)
        if rc != 0:
            raise AssertionError(f"one-process canonical run exited {rc}:\n{out[-2000:]}")
        one = {"seconds": seconds, "ms_per_update": _ms_per_update(d["one"]), "peak_gb": peak, "launches": counts}
        init = _init_trainable(one_argv)
        if cards >= 2:  # the witness: beside the NCCL runs only, to keep the one-card run short
            witness_argv = one_argv + ["--batch-size", str(12 // n), "--update-freq", str(3 * n),
                                       "--save-dir", d["witness"]]
            rc, out, _, _, _ = _launch_in_process(witness_argv)
            if rc != 0:
                raise AssertionError(f"one-process witness run exited {rc}:\n{out[-2000:]}")
        tiny_node = TINY_FLAGS + ["--max-updates", str(TINY_UPDATES), "--max-epoch", "1",
                                  "--save-interval-updates", "1"]
        tiny_contrastive = tiny_node + ["--task", "contrastive_learning", "--criterion", "contrastive_loss"]
        for name, argv in (("one_tiny", tiny_node), ("one_contrastive", tiny_contrastive)):
            rc, out, _, _, _ = _launch_in_process(argv + ["--batch-size", "8", "--save-dir", d[name]])
            if rc != 0:
                raise AssertionError(f"{name} exited {rc}:\n{out[-2000:]}")
        tiny_init = _init_trainable(tiny_node)
        tiny_lr0 = 1e-3 / 2
        lap("one_process")
        # NCCL at world size 1, in this process: each mode against the unwrapped update
        ws1 = {}
        for mode, extra in (("dp", []), ("fsdp", ["--fsdp"]), ("tp", ["--tp-size", "1"])):
            name = f"ws1_{mode}"
            rc, out, _, counts, _ = _launch_in_process(
                tiny_node + extra + ["--batch-size", "8", "--save-dir", d[name], "--distributed-world-size", "1",
                                     "--distributed-init-method", f"tcp://127.0.0.1:{_free_port()}"])
            if rc != 0 or "(nccl)" not in out:
                raise AssertionError(f"{name} exited {rc}:\n{out[-2000:]}")
            ws1[mode] = _agreement(d[name], d["one_tiny"], tiny_init, TINY_UPDATES, True, tiny_lr0, 1)
        result["nccl_world_size_1"] = _hold(ws1)
        lap("nccl_world_size_1")
        rank_flags = ["--distributed-rank", "{rank}"]
        if cards < 2:
            gloo = ["--distributed-world-size", "2", "--distributed-backend", "gloo"] + rank_flags

            def entry(name, argv):
                return {"name": name, "argv": argv + gloo + ["--distributed-init-method",
                                                            f"tcp://127.0.0.1:{_free_port()}"]}

            half = ["--batch-size", "6"]
            plan = [
                entry("dp", canon + agree + half + ["--dp-size", "2", "--save-dir", d["dp"]]),
                entry("tp", canon + agree + ["--tp-size", "2", "--batch-size", "12", "--save-dir", d["tp"]]),
                entry("predict_dp", canon + half + ["--eval-only", "--restore-file", d["one"], "--save-dir", d["one"],
                                                    "--predict-output", d["pred_dp"]]),
                entry("tiny_dp", tiny_node + ["--batch-size", "4", "--save-dir", d["tiny_dp"]]),
                entry("contrastive_dp", tiny_contrastive + ["--batch-size", "4", "--save-dir", d["contrastive_dp"]]),
                entry("stop", canon[:-4] + half + ["--max-updates", "12", "--max-epoch", "3", "--save-dir", d["stop"]]),
            ]
            torch.cuda.empty_cache()
            t = time.perf_counter()
            ranks, sent = run_ranks(plan, n, root, stop=("stop", d["stop"], 2))
            result["ranks_seconds"] = time.perf_counter() - t
            lap("ranks")
            runs = {item["name"]: [r[i] for r in ranks] for i, item in enumerate(plan)}
            timing = {"dp": _ms_per_update(d["dp"]), "tp": _ms_per_update(d["tp"]),
                      "stop_dropout": _ms_per_update(d["stop"])}

            def run_checks():
                checks = {
                    "dp": _agreement(d["dp"], d["one"], init, PARALLEL_UPDATES, False),
                    "tp": _agreement(d["tp"], d["one"], init, PARALLEL_UPDATES, False),
                    "tiny_dp": _agreement(d["tiny_dp"], d["one_tiny"], tiny_init, TINY_UPDATES, True, tiny_lr0, 1),
                    "contrastive_dp": _agreement(d["contrastive_dp"], d["one_contrastive"],
                                                 _init_trainable(tiny_contrastive), TINY_UPDATES, True, tiny_lr0, 1),
                }
                # --eval-only --predict-output at dp=2 against one process on the same checkpoint
                rc, out, _, _, _ = _launch_in_process(canon + ["--eval-only", "--restore-file", d["one"], "--save-dir",
                                                               d["one"], "--predict-output", d["pred_one"]])
                if rc != 0:
                    raise AssertionError(f"one-process --eval-only exited {rc}:\n{out[-2000:]}")
                checks["predict"] = _compare_predictions(d["pred_dp"], d["pred_one"])
                stops = [re.search(r"preempted: checkpoint saved at step (\d+)", r["stdout"]) for r in runs["stop"]]
                if not all(stops) or len({int(m.group(1)) for m in stops}) != 1:
                    raise AssertionError(f"stop: ranks' messages {[r['stdout'][-500:] for r in runs['stop']]}")
                stop_step = int(stops[0].group(1))
                if _latest_step(d["stop"]) != stop_step:
                    raise AssertionError(f"stop: latest step {_latest_step(d['stop'])}, ranks saved {stop_step}")
                checks["stop"] = {"sigterm_to_rank_1_after_update": sent["at_update"], "both_saved_at": stop_step}
                return checks
        else:
            nccl = ["--distributed-world-size", str(n)] + rank_flags

            def entry(name, argv):
                return {"name": name, "argv": argv + nccl + ["--distributed-init-method",
                                                            f"tcp://127.0.0.1:{_free_port()}"]}

            layouts = {"dp": [], "fsdp": ["--fsdp"], "tp": ["--tp-size", "2"],
                       "slices": ["--num-slices", "2", "--fsdp"]}

            def per(name, global_batch):  # a tp group's ranks share one slice
                return ["--batch-size", str(global_batch // (n // 2 if name == "tp" else n))]

            # a tiny rank's single-entry ladders are the global ones over the
            # ranks: the tiny ladders widened so that 2 discussions fit a quarter
            tiny_wide = ["--node-capacity-buckets", "256", "--image-capacity-buckets", "128",
                         "--label-capacity-buckets", "128"]
            plan = [entry(name, canon + agree + per(name, 12) + flags + ["--save-dir", d[name]])
                    for name, flags in layouts.items()]
            plan += [entry(f"tiny_{name}", tiny_node + tiny_wide + per(name, 8) + flags
                           + ["--save-dir", d[f"tiny_{name}"]]) for name, flags in layouts.items()]
            torch.cuda.empty_cache()
            t = time.perf_counter()
            # one set of rank processes per run: one launch per process, as
            # torchrun starts them
            per_run = [run_ranks([item], n, root)[0] for item in plan]
            ranks = [[runs_[r][0] for runs_ in per_run] for r in range(n)]
            result["ranks_seconds"] = time.perf_counter() - t
            lap("ranks")
            runs = {item["name"]: [r[i] for r in ranks] for i, item in enumerate(plan)}
            timing = {name: _ms_per_update(d[name]) for name in layouts}

            def run_checks():
                checks = {name: _agreement(d[name], d["one"], init, PARALLEL_UPDATES, False) for name in layouts}
                checks.update({f"tiny_{name}": _agreement(d[f"tiny_{name}"], d["one_tiny"], tiny_init, TINY_UPDATES,
                                                          True, tiny_lr0, 1) for name in layouts})
                return checks
        for name, per_rank in runs.items():
            if any(r["rc"] != 0 for r in per_rank):
                raise AssertionError(f"parallel run {name}: rcs {[r['rc'] for r in per_rank]}")
        graphs = 12 * update_freq
        result.update(
            ranks=n, one_process=one,
            runs={name: {"ms_per_update": timing.get(name), "discussions_per_s":
                         graphs / timing[name] * 1e3 if name in timing else None,
                         "scaling_vs_one_card": one["ms_per_update"] / timing[name] if name in timing else None,
                         "peak_gb_per_rank": [r["peak_gb"] for r in per_rank],
                         "seconds": max(r["seconds"] for r in per_rank),
                         "launches_per_rank": [r["counts"] for r in per_rank]}
                  for name, per_rank in runs.items()},
        )
        if "stop_dropout" in timing:
            result["runs"]["stop"]["ms_per_update"] = timing["stop_dropout"]
        # rank by rank against dp (the same slices): the first group and update 1
        result["ranks_vs_dp"] = {name: [rank_divergence(r["record"], d_["record"])
                                        for r, d_ in zip(runs[name], runs["dp"])]
                                 for name in ("fsdp", "slices") if name in runs}
        # not held: the canonical run in one rank's microbatches against the
        # one-process run, the distance bf16 rounding alone puts between them
        if cards >= 2:
            result["noise_witness"] = _agreement(d["witness"], d["one"], init, PARALLEL_UPDATES, False)
        try:
            result["checks"] = run_checks()
            _hold(result["checks"])
        except AssertionError as e:  # what ran, with the check that failed, then the failure
            result["failed_check"] = str(e)
            emit(result)
            raise
        # the main path went through the kernels: every tree kernel of the
        # bf16 route on every rank of the training runs
        for name in ("dp", "tp") + (("fsdp", "slices") if cards >= 2 else ()):
            for r in runs[name]:
                if min(r["counts"][k] for k in ("tree_attention_fwd_fused", "tree_attention_bwd_dq_fused",
                                                "tree_attention_bwd_dkv_fused")) == 0:
                    raise AssertionError(f"parallel run {name}: a tree kernel never launched: {r['counts']}")
        result["launches"] = {k: sum(r["counts"][k] for per_rank in runs.values() for r in per_rank)
                              for k in KERNEL_NAMES}
        result["launches_tp_h6"] = {k: sum(r["counts"][k] for r in runs["tp"]) for k in KERNEL_NAMES}
        result["step_seconds"] = steps
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    emit(result)
    return result


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

SP_RING_S = 2048  # the node ladder's top S here (trees of up to 2047 nodes): a multiple of 2 and 4
SP_MIN_NODES, SP_MAX_NODES = 1500, 1800  # the discussions sp trains and scores
SP_GRAPHS = 16  # 12 train: 6 microbatches of 2, 2 updates of 3 (23 and 3 updates before the workflows phase)
# with one card (gloo through the host): one microbatch of 2 an update, 6 train graphs
SP_GRAPHS_ONE_CARD = 8
SP_TEXT_LEN = 32  # tokens per comment (the collator's smallest text bucket)
SP_IMAGE_PROB = 0.01
SP_UPDATES = 2
SP_DATA_FLAGS = ["--node-buckets", str(SP_RING_S - 1), "--node-capacity-buckets", "2048,4096",
                 "--image-capacity-buckets", "0,32,64,128", "--label-capacity-buckets", "2048,4096"]


def _sp_init(rank: int, world: int, init_method: str, backend: str):
    """This rank's process group and card for a ``call`` entry: NCCL one
    rank per card, gloo every rank on card 0."""
    import torch
    import torch.distributed as dist

    card = rank if backend == "nccl" else 0
    torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return torch.device("cuda", card)


def sp_ring_op(rank: int, world: int, init_method: str, backend: str, seed: int) -> dict:
    """The ring alone over ``world`` ranks on one tree of S = SP_RING_S (B=1,
    H=12, dh=64, bf16, the template and ids collated from a synthetic tree),
    rates 0 and 0.3, launched through the tensor-core tree kernels: this
    rank's strip of out, dq, dk, dv and the group's dLUT against the plain
    ring (the same per-tile masks) and, at rate 0, against the one-process
    kernels at the whole S (within 1e-2 of max |ref|); the launches of the
    kernel ring; its forward and forward + backward ms per rank (every rank
    of the group running), and the one-process kernels' at the whole S,
    timed on rank 0 while the others wait."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from multimodaldiscussiontransformer_tpu_torch.ops import ring_attention as ra
    from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta

    dev = _sp_init(rank, world, init_method, backend)
    try:
        b, h, s, dh = 1, 12, SP_RING_S, 64
        template, ids, lut = (t.to(dev) for t in compact_inputs(s, b, h, seed))
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, cot = (torch.randn(b, h, s, dh, generator=gen, device=dev).bfloat16() for _ in range(4))
        c = s // world
        rows = slice(rank * c, (rank + 1) * c)
        names = ("out", "dq", "dk", "dv", "dlut")
        out = {"B": b, "H": h, "S": s, "dh": dh, "ranks": world, "tile": c}

        def ring(rate, seed_):
            leaves = [x[:, :, rows].clone().requires_grad_(True) for x in (q, k, v)]
            lut_leaf = lut.clone().requires_grad_(True)
            o = ra.ring_tree_attention_local(*leaves, template[:, rows], ids[:, rows], lut_leaf, None, rate=rate,
                                             seed=seed_)
            o.backward(cot[:, :, rows])
            return o, leaves, lut_leaf

        for rate in (0.0, TRAIN_RATE):
            seed_ = seed + 5 if rate else None
            _zero_counts()
            o, leaves, lut_leaf = ring(rate, seed_)
            torch.cuda.synchronize()
            launched = dict(zip(KERNEL_NAMES, _counts()))
            dlut = lut_leaf.grad.clone()
            dist.all_reduce(dlut)  # every rank's tiles
            got = [o.detach()] + [x.grad for x in leaves] + [dlut]
            plain = [x.detach().clone().requires_grad_(True) for x in (q, k, v, lut)]
            ref = ra.ring_tree_attention_reference(plain[0], plain[1], plain[2], template, ids, plain[3], world,
                                                   seed=seed_ or 0, rate=rate)
            ref.backward(cot)
            want = [ref[:, :, rows].detach()] + [x.grad[:, :, rows] for x in plain[:3]] + [plain[3].grad]
            row = {"launches": launched, "errors_vs_plain_ring": _errors(got, want, names, TRAIN_BF16_REL)}
            del plain, ref, want
            if rate == 0.0:
                one = [x.detach().clone().requires_grad_(True) for x in (q, k, v, lut)]
                o1 = ta.tree_attention(one[0], one[1], one[2], template, ids, one[3])
                o1.backward(cot)
                want = [o1[:, :, rows].detach()] + [x.grad[:, :, rows] for x in one[:3]] + [one[3].grad]
                row["errors_vs_one_process"] = _errors(got, want, names, TRAIN_BF16_REL)
                del one, o1, want
            out[f"rate{rate}"] = row
            torch.cuda.empty_cache()
        qs, ks, vs = (x[:, :, rows].contiguous() for x in (q, k, v))

        def fwd():
            with torch.no_grad():
                ra.ring_tree_attention_local(qs, ks, vs, template[:, rows], ids[:, rows], lut, None)

        def fwd_bwd():
            ring(0.0, None)

        out["ms"] = {"ring_fwd": time_cuda(fwd, 10), "ring_fwd_bwd": time_cuda(fwd_bwd, 5)}
        dist.barrier()
        if rank == 0:
            one = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

            def one_fwd_bwd():
                ta.tree_attention(*one, template, ids, lut).backward(cot)

            out["ms"]["one_process_fwd"] = time_cuda(lambda: ta.tree_attention(q, k, v, template, ids, lut), 10)
            out["ms"]["one_process_fwd_bwd"] = time_cuda(one_fwd_bwd, 5)
            # SDPA on one card at the whole S, on the contiguous bias (the
            # library column of the ring's kernel-table row)
            dense = ta.assemble_bias(template, ids, lut, True).to(torch.bfloat16).contiguous()

            def library_fwd_bwd():
                F.scaled_dot_product_attention(*one, attn_mask=dense).backward(cot)

            out["ms"]["library_fwd"] = time_cuda(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=dense), 10)
            out["ms"]["library_fwd_bwd"] = time_cuda(library_fwd_bwd, 5)
            del dense
        dist.barrier()
        shared = template.numel() * 4 + ids.numel() * 4 + lut.numel() * 4
        tile = work_bounds(b, h, c, dh, "bfloat16", shared // (world * world))
        out["bound_ms"] = {"ring_fwd": world * tile["fwd"][0], "ring_fwd_bwd": world * sum(
            tile[k_][0] for k_ in ("fwd", "dq", "dkv")), "one_process": work_bounds(b, h, s, dh, "bfloat16", shared)}
        return out
    finally:
        dist.destroy_process_group()


def _sp_items(seed: int, count: int = 2):
    """``count`` discussions of SP_MIN_NODES .. SP_MAX_NODES nodes (the
    scoring check's)."""
    from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_batch_items

    return synthetic_batch_items(count, seed=seed, min_nodes=SP_MIN_NODES, max_nodes=SP_MAX_NODES,
                                 image_prob=SP_IMAGE_PROB, seq_len=SP_TEXT_LEN, vocab_size=30522,
                                 image_shape=IMAGE_SHAPE)


def _sp_scorer(seed: int, device, mesh=None):
    """``DiscussionScorer`` of the seeded ``ModelConfig()`` (with
    ``sequence_parallel``) on ``device``, over ``mesh``; its ladders take
    two SP discussions."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig, ModelConfig
    from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
    from multimodaldiscussiontransformer_tpu_torch.serve.incremental import DiscussionScorer

    model = MDTModel(ModelConfig(sequence_parallel=True), generator=torch.Generator().manual_seed(seed))
    data = DataConfig(batch_size=1, node_buckets=(SP_RING_S - 1,), node_capacity_buckets=(2048, 4096),
                      image_capacity_buckets=(0, 32, 64, 128), label_capacity_buckets=(4096,))
    return DiscussionScorer(model, device=device, data_cfg=data, image_shape=IMAGE_SHAPE, mesh=mesh)


def sp_score(rank: int, world: int, init_method: str, backend: str, seed: int, tp: int = 1) -> dict:
    """Scoring over an sp (x tp) mesh of ``world`` ranks: every rank scores
    the same two discussions; the probabilities it returns, its tree-kernel
    launches and the median ms of a request."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from multimodaldiscussiontransformer_tpu_torch.parallel.mesh import make_mesh

    dev = _sp_init(rank, world, init_method, backend)
    try:
        mesh = make_mesh(tp_size=tp, sp_size=world // tp, device_type="cuda")
        scorer = _sp_scorer(seed, dev, mesh)
        items = _sp_items(seed + 1)
        _zero_counts()
        probs = scorer.score_items(items)
        torch.cuda.synchronize()
        launched = dict(zip(KERNEL_NAMES, _counts()))
        ms = []
        for _ in range(3):
            t = time.perf_counter()
            scorer.score_items(items)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return {"probs": [p.tolist() for p in probs], "launches": launched, "ms_median": float(np.median(ms)),
                "nodes": [it.num_nodes for it in items]}
    finally:
        dist.destroy_process_group()


SP_RANK_CALLS = {"ring_op": sp_ring_op, "score": sp_score}


def _prediction_table(path: str) -> dict:
    """A prediction file's columns (parquet where pandas wrote it, else CSV)."""
    import numpy as np

    if path.endswith(".parquet"):
        import pandas as pd

        frame = pd.read_parquet(path)
        return {k: frame[k].to_numpy() for k in frame.columns}
    rows = np.genfromtxt(path, delimiter=",", names=True)
    return {k: rows[k] for k in rows.dtype.names}


def phase_sequence_parallel(seed: int, card: str = ""):
    """Sequence parallelism at ``ModelConfig()`` width (8 fusion layers,
    frozen towers, bf16 compute, H 12, dh 64) on discussions of
    SP_MIN_NODES .. SP_MAX_NODES nodes (S = SP_RING_S, the largest one
    process trains here: 2 per microbatch x 3, x 1 with one card), each rank holding a strip
    of the node axis and the graph attention a ring over the sp group
    through the tensor-core tree kernels:
    - in this process: the one-process runs every sp run is held against
      (the big discussions through the launcher, SP_UPDATES updates at lr 1e-4 with
      dropout 0; with 2 or more cards the bf16 noise witness, the same run
      one discussion per microbatch; the tiny float32 run, 2 updates, and its
      ``--eval-only --predict-output``; the one-process scorer);
    - with one card, 2 ranks on card 0 over gloo, sp=2: the ring alone
      (``sp_ring_op``), ``DiscussionScorer(mesh=...)`` (``sp_score``), the
      big run through the launcher with ``--sp-size 2`` (ms per update,
      each rank's peak memory, the tree-kernel launches per rank per
      update), the tiny float32 run and its predictions;
    - with N = 2 or 4 cards (4 of more), NCCL with one rank per card: the
      ring, the scorer and the big run at sp=N, with 4 cards also dp=2 x
      sp=2; the tiny float32 run at sp=N, and with 4 cards at dp=2 x sp=2
      and tp=2 x sp=2.
    Every check is made before any failure is raised: the failure names
    each run that disagreed."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    nccl = cards >= 2
    n = 4 if cards >= 4 else 2
    branch = "nccl_one_rank_per_card" if nccl else "gloo_two_ranks_on_card_0"
    print(json.dumps({"phase": "sequence_parallel_branch", "cards": cards, "branch": branch, "ranks": n}), flush=True)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="mdt_sp_")
    result = {"phase": "sequence_parallel", "card": card, "cards": cards, "branch": branch, "ranks": n}
    steps = {}
    t_step = time.perf_counter()

    def lap(name):
        nonlocal t_step
        steps[name] = time.perf_counter() - t_step
        t_step = time.perf_counter()

    try:
        d = {name: os.path.join(root, name) for name in
             ("data", "one", "witness", "one_tiny", "pred_one_tiny", "sp", "dp2_sp2", "tiny_sp", "tiny_dp2_sp2",
              "tiny_tp2_sp2", "pred_tiny_sp")}
        result["dataset"] = write_hateful_discussions(d["data"], seed + 3, graphs=SP_GRAPHS if nccl else SP_GRAPHS_ONE_CARD,
                                                      min_nodes=SP_MIN_NODES, max_nodes=SP_MAX_NODES,
                                                      image_prob=SP_IMAGE_PROB, seq_len=SP_TEXT_LEN)
        lap("data")
        update_freq = 3 if nccl else 1  # microbatches an update on each rank
        big = ["--data-root", d["data"], "--seed", str(seed + 1), *CANONICAL_FLAGS, "--update-freq", str(update_freq),
               *SP_DATA_FLAGS, "--batch-size", "2", "--max-updates", str(SP_UPDATES), "--max-epoch", "1", *NO_DROPOUT,
               *PARALLEL_LR]
        rc, out, seconds, counts, peak = _launch_in_process(big + ["--save-dir", d["one"]])
        if rc != 0:
            raise AssertionError(f"one-process big run exited {rc}:\n{out[-2000:]}")
        one = {"seconds": seconds, "ms_per_update": _ms_per_update(d["one"]), "peak_gb": peak, "launches": counts}
        init = _init_trainable(big + ["--save-dir", d["one"]])
        if nccl:  # the witness: beside the NCCL runs only, to keep the one-card run short
            rc, out, _, _, _ = _launch_in_process(big + ["--batch-size", "1", "--update-freq", "6",
                                                         "--save-dir", d["witness"]])
            if rc != 0:
                raise AssertionError(f"one-process witness run exited {rc}:\n{out[-2000:]}")
        tiny = TINY_FLAGS + ["--max-updates", str(TINY_UPDATES), "--max-epoch", "1", "--save-interval-updates", "1",
                             "--batch-size", "8"]
        rc, out, _, _, _ = _launch_in_process(tiny + ["--save-dir", d["one_tiny"]])
        if rc != 0:
            raise AssertionError(f"one-process tiny run exited {rc}:\n{out[-2000:]}")
        predict_tiny = tiny + ["--eval-only", "--restore-file", d["one_tiny"], "--save-dir", d["one_tiny"]]
        rc, out, _, _, _ = _launch_in_process(predict_tiny + ["--predict-output", d["pred_one_tiny"]])
        if rc != 0:
            raise AssertionError(f"one-process tiny --eval-only exited {rc}:\n{out[-2000:]}")
        tiny_init = _init_trainable(tiny)
        scorer = _sp_scorer(seed, torch.device("cuda"))
        want_probs = scorer.score_items(_sp_items(seed + 1))
        del scorer
        torch.cuda.empty_cache()
        lap("one_process")

        def call(name, fn, world, **kw):
            return {"name": name, "call": fn, "world": world, "kwargs": dict(
                world=world, init_method=f"tcp://127.0.0.1:{_free_port()}", backend="nccl" if nccl else "gloo",
                seed=seed, **kw)}

        def launch(name, argv, world):
            flags = ["--distributed-world-size", str(world), "--distributed-rank", "{rank}",
                     "--distributed-init-method", f"tcp://127.0.0.1:{_free_port()}"]
            return {"name": name, "world": world, "argv": argv + flags + ([] if nccl else ["--distributed-backend",
                                                                                          "gloo"])}

        plan = [call("ring_op", "ring_op", n), call("score", "score", n),
                launch("sp", big + ["--sp-size", str(n), "--save-dir", d["sp"]], n),
                launch("tiny_sp", tiny + ["--sp-size", str(n), "--save-dir", d["tiny_sp"]], n),
                launch("predict_tiny_sp", predict_tiny + ["--sp-size", str(n), "--predict-output", d["pred_tiny_sp"]],
                       n)]
        if n == 4:
            plan += [launch("dp2_sp2", big + ["--sp-size", "2", "--dp-size", "2", "--batch-size", "1",
                                              "--save-dir", d["dp2_sp2"]], 4),
                     launch("tiny_dp2_sp2", tiny + ["--sp-size", "2", "--dp-size", "2", "--batch-size", "4",
                                                    "--save-dir", d["tiny_dp2_sp2"]], 4),
                     launch("tiny_tp2_sp2", tiny + ["--sp-size", "2", "--tp-size", "2", "--save-dir",
                                                    d["tiny_tp2_sp2"]], 4)]
        torch.cuda.empty_cache()
        t = time.perf_counter()
        # NCCL: one set of rank processes per run (one launch per process,
        # as torchrun starts them); gloo on one card: one set for the plan
        sets = [[item] for item in plan] if nccl else [plan]
        runs = {}
        for items in sets:
            ranks, _ = run_ranks(items, n, root)
            for i, item in enumerate(items):
                runs[item["name"]] = [r[i] for r in ranks]
        result["ranks_seconds"] = time.perf_counter() - t
        lap("ranks")
        for name, per_rank in runs.items():
            if any(r["rc"] != 0 for r in per_rank):
                raise AssertionError(f"sequence-parallel run {name}: rcs {[r['rc'] for r in per_rank]}")
        checks = {}
        ring = [r["result"] for r in runs["ring_op"]]
        for rate in ("rate0.0", f"rate{TRAIN_RATE}"):
            for kind in ("errors_vs_plain_ring", "errors_vs_one_process"):
                failed = [f"rank {i}: {x[rate][kind]['failed']}" for i, x in enumerate(ring)
                          if kind in x[rate] and x[rate][kind]["failed"]]
                checks[f"ring_{rate}_{kind}"] = {"failed": "; ".join(failed) or None}
            want = {"tree_attention_fwd_fused": n, "tree_attention_bwd_dq_fused": n,
                    "tree_attention_bwd_dkv_fused": n}
            launched = [{k: x[rate]["launches"][k] for k in want} for x in ring]
            checks[f"ring_{rate}_launches"] = {"per_rank": launched, "failed": None if all(
                lr == want for lr in launched) else f"tile launches per rank {launched}, want {want}"}
        scores = [r["result"] for r in runs["score"]]
        err = max(float(np.abs(np.asarray(p) - w).max()) for sc in scores for p, w in zip(sc["probs"], want_probs))
        checks["score"] = {"max_abs_err_prob": err, "tolerance": TRAIN_BF16_REL,
                           "failed": None if err <= TRAIN_BF16_REL else f"probabilities differ by {err}"}
        per_forward = [sc["launches"]["tree_attention_fwd_fused"] for sc in scores]
        if per_forward != [LAUNCHES_PER_FORWARD * n] * n:
            checks["score"]["failed"] = f"tree forward launches per rank {per_forward}, want {LAUNCHES_PER_FORWARD * n}"
        big_runs = ["sp"] + (["dp2_sp2"] if n == 4 else [])
        for name in big_runs:
            checks[name] = _agreement(d[name], d["one"], init, SP_UPDATES, False)
            sp_size = n if name == "sp" else 2
            k = update_freq
            want = {"tree_attention_bwd_dq_fused": 8 * sp_size * k * SP_UPDATES,
                    "tree_attention_bwd_dkv_fused": 8 * sp_size * k * SP_UPDATES}
            got = [{key: r["counts"][key] for key in want} for r in runs[name]]
            if any(g != want for g in got) or min(r["counts"]["tree_attention_fwd_fused"] for r in runs[name]) < \
                    10 * sp_size * k * SP_UPDATES:
                checks[name]["failed"] = (checks[name]["failed"] or "") + f"; tree launches per rank {got}, want {want}"
        tiny_runs = ["tiny_sp"] + (["tiny_dp2_sp2", "tiny_tp2_sp2"] if n == 4 else [])
        for name in tiny_runs:
            checks[name] = _agreement(d[name], d["one_tiny"], tiny_init, TINY_UPDATES, True, 1e-3 / 2, 1)
        try:
            checks["predict_tiny_sp"] = {**_compare_predictions(d["pred_tiny_sp"], d["pred_one_tiny"], 1e-5),
                                         "failed": None}
        except AssertionError as e:
            checks["predict_tiny_sp"] = {"failed": str(e)}
        result.update(
            one_process=one,
            ring_op={"per_rank": ring},
            score={"ms_median_per_rank": [sc["ms_median"] for sc in scores], "nodes": scores[0]["nodes"]},
            runs={name: {"ms_per_update": _ms_per_update(d[name]), "peak_gb_per_rank": [r["peak_gb"] for r in per_rank],
                         "seconds": max(r["seconds"] for r in per_rank),
                         "launches_per_rank": [r["counts"] for r in per_rank],
                         "tree_launches_per_rank_per_update": [
                             {key: r["counts"][key] / SP_UPDATES for key in ("tree_attention_bwd_dq_fused",
                                                                             "tree_attention_bwd_dkv_fused")}
                             for r in per_rank]}
                  for name, per_rank in runs.items() if name in big_runs},
            peak_gb_one_process=one["peak_gb"],
            noise_witness=_agreement(d["witness"], d["one"], init, SP_UPDATES, False) if nccl else None,
            checks=checks, step_seconds=steps,
        )
        result["launches"] = {key: sum(r["counts"][key] for per_rank in runs.values() for r in per_rank)
                              for key in KERNEL_NAMES}
        result["launches_ring_tiles"] = {key: sum(x[rate]["launches"][key] for x in ring for rate in
                                                  ("rate0.0", f"rate{TRAIN_RATE}")) for key in KERNEL_NAMES}
        try:
            _hold(checks)
        except AssertionError as e:  # what ran, with the checks that failed, then the failure
            result["failed_check"] = str(e)
            emit(result)
            raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    emit(result)
    return result


def _latest_step(save_dir: str):
    from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import Checkpointer

    return Checkpointer(save_dir).latest_step()


def _compare_predictions(got_dir: str, want_dir: str, prob_atol=None) -> dict:
    """Two prediction directories: every split's rows in the same order
    with the same keys, labels and predictions' logits within the bf16
    tolerance of the scoring phase (with ``prob_atol``, a float32 run's:
    the same predictions and every probability within it); whether the
    bytes are equal."""
    import numpy as np

    table = _prediction_table
    out = {}
    for name in sorted(os.listdir(want_dir)):
        with open(os.path.join(got_dir, name), "rb") as a, open(os.path.join(want_dir, name), "rb") as b:
            ga, wb = a.read(), b.read()
        g, w = table(os.path.join(got_dir, name)), table(os.path.join(want_dir, name))
        for key in ("graph_idx", "node", "label"):
            if not np.array_equal(g[key], w[key]):
                raise AssertionError(f"{name}: column {key} differs")
        logits = [k for k in w if k.startswith("logit_")]
        logit = max(float(np.abs(g[k].astype(np.float64) - w[k]).max()) for k in logits)
        scale = max(float(np.abs(w[k]).max()) for k in logits)
        if logit > TRAIN_BF16_REL * max(scale, 1.0):
            raise AssertionError(f"{name}: logits differ by {logit} (max |logit| {scale})")
        out[name] = {"rows": int(len(w["node"])), "bytes_equal": ga == wb, "max_abs_err_logit": logit,
                     "pred_agreement": float((g["pred"] == w["pred"]).mean())}
        if prob_atol is not None:
            prob = max(float(np.abs(g[k] - w[k]).max()) for k in w if k.startswith("prob_"))
            out[name]["max_abs_err_prob"] = prob
            if prob > prob_atol or not np.array_equal(g["pred"], w["pred"]):
                raise AssertionError(f"{name}: probabilities differ by {prob} (atol {prob_atol}) or predictions differ")
    if not out:
        raise AssertionError("no predictions written")
    return out


def _kernel_entry(name, source, replaces, also, launches, row, dtype_err, ms_key, plain_ms, library_ms, bound_key):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "also_replaces": also,
        "launches": launches, "max_abs_err": dtype_err, "ms": row["ms"][ms_key], "plain_ms": plain_ms,
        "bound_ms": row["bound"][bound_key][0], "bound_by": row["bound"][bound_key][1], "library_ms": library_ms,
    }


def _float32_numbers(row, ms_key, library_key, bound_key):
    """A float32-route kernel's numbers on float32 inputs: its ms, SDPA's
    on the same inputs and the float32 bound."""
    f = row["float32"]
    return {"ms": f["ms"][ms_key], "library_ms": f["ms"][library_key], "bound_ms": f["bound"][bound_key][0],
            "bound_by": f["bound"][bound_key][1]}


def _worst(rows, outputs):
    """The largest bf16 max-abs error of ``outputs`` over every row, both
    rates."""
    return max(r[k]["bfloat16"][o]["max_abs_err"] for r in rows for k in ("errors", "errors_rate0") for o in outputs)


def _worst_pair(rows, outputs):
    """The CUDA-core pair's largest max-abs error of ``outputs``: its
    float32 checks called directly at every shape, its bf16 checks at the
    tower shapes and its bf16 route past S = 256, both rates."""
    return max([r[k][name][o]["max_abs_err"] for r in rows for k in ("errors", "errors_rate0")
                for name in ("float32_pair", "bfloat16_pair") if name in r[k] for o in outputs]
               + [r[k]["bfloat16"][o]["max_abs_err"] for r in rows if r["kernel_route"]["bfloat16"] == "cuda_core"
                  for k in ("errors", "errors_rate0") for o in outputs])


def _worst_tf32_pair(rows, outputs):
    """The 3xTF32 pair's largest max-abs error of ``outputs``: the float32
    route at every shape (S = 300 included), both rates."""
    return max(r[k]["float32"][o]["max_abs_err"] for r in rows for k in ("errors", "errors_rate0") for o in outputs)



# ---------------------------------------------------------------------------
# the workflows: the two-stage rehearsal, the context ablation, the
# readiness gate, the launch scripts and the comment-only baseline
# ---------------------------------------------------------------------------

WF_TWO_STAGE = dict(n_trees=60, stage1_updates=4, stage2_updates=12)
# per arm: the F1s are printed, not held (on the card the full arm reached
# F1 1.0 at 600 updates, 0.950 at 400, 0.897 at 300, and stayed at the
# all-positive 0.804 at 100: no count the run's time limit leaves room for
# lets an arm learn, so the phase drives both arms and keeps them short)
WF_ABLATION_UPDATES = 30
# the scripts' mini corpus: > 24 train trees for stage 1's 2 contrastive
# updates of 12 (``--update-freq 1``; stage 2 keeps batch 12 x 3)
WF_SCRIPT_TREES = 40
WF_BERT_STEPS = 20  # comment-only steps at BERT-base width, one evaluation at the last
WF_BERT_TRAIN, WF_BERT_VALID = 480, 96
# comment-only on the card against the CPU: BERT-base width at 2 layers,
# every dropout 0, float32, 4 steps of 8 comments (3 updates: the first
# step's lr is 0, optax's count), 12 valid comments (a padded last batch).
# Held: the change of the parameters (relative L2 of the card's minus the
# CPU's change; AdamW's first steps move a parameter by ~lr whatever its
# gradient's size, so a gradient at rounding level may flip its sign) and
# the valid logits (max abs error over max |logit|). The attention key
# biases are held apart, element by element, to 2.05 x the summed lr: their
# exact gradient is 0 (softmax is shift-invariant), so both devices walk
# them on rounding noise, as tests/test_torch_comment_only.py holds them
WF_BERT_CHECK = dict(layers=2, steps=4, batch=8, tokens=32, train=24, valid=12)
WF_BERT_UPDATE_RTOL, WF_BERT_LOGIT_RTOL = 1e-2, 1e-3


class _WorkflowUpdates(_RecordedUpdates):
    """``_RecordedUpdates`` whose expected launches follow each step's own
    trainer (its model config and task), for workflows that train several
    configurations in one call; each record carries its task."""

    def __init__(self):
        super().__init__(None)

    def _wrap(self, orig, micro: bool):
        step = super()._wrap(orig, micro)

        def outer(trainer, state, group, **kw):
            self.mc, self.contrastive = trainer.cfg.model, trainer.contrastive
            logs = step(trainer, state, group, **kw)
            self.records[-1]["task"] = "contrastive" if trainer.contrastive else "node"
            return logs

        return outer

    def take(self) -> list:
        out, self.records, self.before = self.records, [], None
        return out


def _stage_numbers(records: list, what: str) -> dict:
    """ms per update (median, after the first) and the tree-kernel launches
    of a stage's steps; raises if a step launched other than its config
    expects."""
    import numpy as np

    bad = [(r["launches"], r["want"]) for r in records if r["launches"] != r["want"]]
    if not records or bad:
        raise AssertionError(f"workflows {what}: {len(records)} steps; launches (got, expected) {bad[:3]}")
    ms = [r["ms"] for r in records]
    tree = {n: sum(dict(zip(KERNEL_NAMES, r["launches"]))[n] for r in records) for n in KERNEL_NAMES
            if n.startswith("tree_attention")}
    return {"updates": len(records), "ms_per_update_median": float(np.median(ms[1:] or ms)),
            "ms_first_update": ms[0], "peak_gb": max(r["peak_gb"] for r in records),
            "tree_launches": {n: c for n, c in tree.items() if c}}


def _contrastive_dir_from_ingest(data_root: str, communities: list, out: str, seed: int) -> dict:
    """A contrastive ``hateful_discussions`` directory of an ingested corpus:
    one graph per tree (``two_stage.contrastive_dataset_from_ingest``: y
    the community, hard_y the polar one) written by the ingest's writer,
    with the dataset's train and test indices."""
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import ingest
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.two_stage import (
        contrastive_dataset_from_ingest,
    )

    ds = contrastive_dataset_from_ingest(data_root, communities, seed=seed)
    os.makedirs(out, exist_ok=True)
    for k in range(len(ds)):
        ingest.save_graph_npz(os.path.join(out, f"graph-{k}.npz"), ds.get(k))
    for name, idx in (("train-idx-many.txt", ds.train_idx), ("test-idx-many.txt", ds.test_idx)):
        with open(os.path.join(out, name), "w") as f:
            f.write("".join(f"{int(i)}\n" for i in idx))
    return {"graphs": len(ds), "train": len(ds.train_idx), "test": len(ds.test_idx)}


def _bert_comments(n: int, seed: int, tokenizer, max_length: int) -> dict:
    """``n`` synthetic comments in the two-stage generator's words (hateful
    ones from its hate lexicon, 30%), tokenized by the port's WordPiece,
    with their labels."""
    import numpy as np

    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.two_stage import _sentence

    rng = np.random.RandomState(seed)
    labels = (rng.rand(n) < 0.3).astype(np.int32)
    texts = [_sentence(rng, int(rng.randint(0, 4)), bool(y), n_words=int(rng.randint(6, 30))) for y in labels]
    toks = tokenizer(texts, max_length=max_length)
    return {**toks, "label": labels}


def _comment_only_card_vs_cpu(tok, seed: int) -> dict:
    """``text_bert.train`` at WF_BERT_CHECK on the card and on the CPU from
    the same initial weights and batches: the relative L2 of the card's
    parameter change minus the CPU's (the key biases apart), and the valid
    logits' max abs error over max |logit|; raises past the tolerances of
    WF_BERT_CHECK's comment."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core.config import BertTowerConfig
    from multimodaldiscussiontransformer_tpu_torch.experiments.comment_only import text_bert

    c = WF_BERT_CHECK
    tower = BertTowerConfig(num_hidden_layers=c["layers"], hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg = text_bert.TextBertConfig(max_steps=c["steps"], eval_steps=c["steps"], warmup_steps=1, lr=1e-4,
                                   batch_size=c["batch"], max_length=c["tokens"], seed=seed, tower=tower)
    train_data = _bert_comments(c["train"], seed + 2, tok, c["tokens"])
    valid_data = _bert_comments(c["valid"], seed + 3, tok, c["tokens"])
    init = text_bert.BertTextClassifier(cfg).state_dict()  # train's own init: a generator seeded cfg.seed
    out = {dev: text_bert.train(cfg, train_data, valid_data, log_fn=lambda _: None, device=dev)
           for dev in ("cuda", "cpu")}
    (p_card, _, l_card), (p_cpu, _, l_cpu) = out["cuda"], out["cpu"]
    key_bias = [k for k in init if k.endswith("attention.key.bias")]
    rest = [k for k in init if k not in key_bias]
    diff = math.sqrt(sum(float((p_card[k].double() - p_cpu[k].double()).square().sum()) for k in rest))
    moved = math.sqrt(sum(float((p_cpu[k].double() - init[k].double()).square().sum()) for k in rest))
    update_rel = diff / moved
    key_bias_err = max(float((p_card[k] - p_cpu[k]).abs().max()) for k in key_bias)
    key_bias_tol = 2.05 * sum(text_bert.lr_at(cfg, n) for n in range(c["steps"]))
    logit_rel = float(abs(l_card - l_cpu).max() / abs(l_cpu).max())
    row = {"config": f"BERT-base width, {c['layers']} layers, every dropout 0, float32, {c['steps']} steps of "
                     f"{c['batch']} x {c['tokens']} tokens, {c['valid']} valid comments",
           "update_rel_l2": update_rel, "key_bias_max_abs_err": key_bias_err, "logit_max_abs_err_rel": logit_rel,
           "change_l2_cpu": moved,
           "tolerance": {"update_rel_l2": WF_BERT_UPDATE_RTOL, "key_bias_abs": key_bias_tol,
                         "logit_rel": WF_BERT_LOGIT_RTOL}}
    if not (moved > 0 and len(key_bias) == c["layers"] and update_rel <= WF_BERT_UPDATE_RTOL
            and key_bias_err <= key_bias_tol and logit_rel <= WF_BERT_LOGIT_RTOL):
        raise AssertionError(f"comment_only: card and CPU disagree: {row}")
    return row


def phase_workflows(seed: int, card: str = "") -> dict:
    """The last workflows of the port, on one card, in order:
    1. two_stage: ``two_stage.run`` on a generated corpus of
       WF_TWO_STAGE["n_trees"] trees (4 contrastive, 12 node updates, the
       module's hidden-64 geometry, float32: the 3xTF32 tree kernels): its TEST
       line, ms per update of each stage, the tree launches;
    2. context_ablation: ``context_ablation.run`` at 300 trees,
       WF_ABLATION_UPDATES updates per arm: the full and the blind F1 and
       the margin;
    3. readiness: ``readiness.main --full-model --smoke-updates 2`` on
       stand-in assets the port's generator writes (224 px images), with
       ``transformers`` unimportable, its HF checks given the published
       names in an HF cache that ``write_hf_cache`` fills (``$HF_HUB_CACHE``
       for the rest of the phase): rc 0 and both HF checks ok;
    4. the scripts: ``sample_run.sh`` through bash at ``ModelConfig()``
       width on a mini corpus of WF_SCRIPT_TREES trees ingested at the
       canonical geometry (100 tokens, 224 px): 2 contrastive updates
       (``HF_INIT=1``: ``--hf-init``, the towers from the cache;
       ``--task contrastive_learning --update-freq 1`` on the ingest's
       contrastive directory; the tree launches of rows 7 and 8 as the
       config says), then ``RESTORE_FILE=<stage 1>`` 2 node
       updates at batch 12 x 3 (``--restore-file --reset-optimizer``);
       each stage's launcher argv, as the script builds it (a ``python``
       first on ``PATH`` records it), runs in this process; ms per update
       and the test metrics;
    5. comment_only: ``text_bert.train`` at BERT-base width (12 layers,
       768, 100 tokens, batch 48) for WF_BERT_STEPS steps with one
       evaluation, on synthetic comments tokenized by the port's WordPiece:
       ms per step, peak memory, the metrics; then WF_BERT_CHECK's
       dropout-free steps on the card and on the CPU from the same weights,
       held to WF_BERT_UPDATE_RTOL and WF_BERT_LOGIT_RTOL.
    Images are PNG where PIL is installed, else ``.npy`` arrays (asked for
    by name). Every failure raises."""
    import importlib.util

    import numpy as np
    import torch

    from multimodaldiscussiontransformer_tpu_torch.data.tokenizer import BertWordPieceTokenizer
    from multimodaldiscussiontransformer_tpu_torch.data_prep.splits import make_splits
    from multimodaldiscussiontransformer_tpu_torch.experiments.comment_only import text_bert
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import (
        context_ablation,
        ingest,
        readiness,
        two_stage,
    )
    from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
    from multimodaldiscussiontransformer_tpu_torch.train.launch import build_parser, config_from_args

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mdt_workflows_")
    pil = importlib.util.find_spec("PIL") is not None
    image_format = "png" if pil else "npy"
    result = {"phase": "workflows", "card": card, "pil": pil, "image_format": image_format,
              "transformers": importlib.util.find_spec("transformers") is not None}
    steps, launches = {}, {}
    t_step = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        steps[name], t_step[0] = now - t_step[0], now

    def quiet(fn, *a, **k):
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*a, **k)
        return out, buf.getvalue()

    try:
        # 1. the two-stage rehearsal
        torch.cuda.empty_cache()
        _zero_counts()
        with _WorkflowUpdates() as rec:
            res, out = quiet(two_stage.run, os.path.join(root, "two_stage"), seed=seed, device="cuda",
                             image_format=image_format, **WF_TWO_STAGE)
        launches["two_stage"] = dict(zip(KERNEL_NAMES, _counts()))
        records = rec.take()
        test_line = [ln for ln in out.splitlines() if ln.startswith("[two_stage] TEST ")]
        if len(test_line) != 1 or json.loads(test_line[0].split("TEST ", 1)[1]) != res:
            raise AssertionError(f"two_stage: TEST line {test_line}")
        print(test_line[0], flush=True)
        if not (np.isfinite(res["loss"]) and 0.0 <= res["f1"] <= 1.0):
            raise AssertionError(f"two_stage: test metrics {res}")
        result["two_stage"] = {
            "test": res,
            "contrastive": _stage_numbers([r for r in records if r["task"] == "contrastive"], "two_stage stage 1"),
            "node": _stage_numbers([r for r in records if r["task"] == "node"], "two_stage stage 2"),
            "launches": launches["two_stage"]}
        lap("two_stage")

        # 2. the context ablation
        torch.cuda.empty_cache()
        _zero_counts()
        with _WorkflowUpdates() as rec:
            res, out = quiet(context_ablation.run, os.path.join(root, "ablation"), n_trees=300, seed=seed,
                             updates=WF_ABLATION_UPDATES, device="cuda")
        launches["context_ablation"] = dict(zip(KERNEL_NAMES, _counts()))
        records = rec.take()
        n = WF_ABLATION_UPDATES
        if len(records) != 2 * n or not all(np.isfinite([res["f1_full"], res["f1_context_blind"]])):
            raise AssertionError(f"context_ablation: {len(records)} steps, result {res}")
        result["context_ablation"] = {
            **res, "full": _stage_numbers(records[:n], "context_ablation full"),
            "blind": _stage_numbers(records[n:], "context_ablation blind"),
            "launches": launches["context_ablation"]}
        print(json.dumps({"context_ablation": {k: res[k] for k in ("f1_full", "f1_context_blind", "margin")},
                          "card": card}), flush=True)
        lap("context_ablation")

        # 3. the readiness gate on stand-in assets, transformers absent; its
        # HF checks on an HF cache holding the published checkpoints' files
        # at their shapes (random weights), the cache sample_run.sh's
        # contrastive stage starts its towers from
        t_cache = time.perf_counter()
        cache = os.path.join(root, "hf_cache")
        cache_bytes = write_hf_cache(cache, ModelConfig(), seed + 7)[3]
        result["hf_cache"] = {"bytes": cache_bytes, "write_seconds": time.perf_counter() - t_cache}
        os.environ["HF_HUB_CACHE"] = cache
        assets = os.path.join(root, "assets")
        paths = two_stage.generate_mini_corpus(assets, n_trees=10, seed=seed, image_px=224, image_prob=0.3,
                                               image_format=image_format)
        os.rename(paths["raw"], os.path.join(assets, "pruned-with-images.json"))
        torch.cuda.empty_cache()
        _zero_counts()
        saved = sys.modules.get("transformers", False)
        sys.modules["transformers"] = None  # unimportable, as on a machine without it
        try:
            with _WorkflowUpdates() as rec:
                rc, out = quiet(readiness.main, ["--assets", assets, "--out", os.path.join(root, "smoke"),
                                                 "--full-model", "--smoke-updates", "2", "--text-ckpt", HF_TEXT,
                                                 "--image-ckpt", HF_IMAGE])
        finally:
            if saved is False:
                sys.modules.pop("transformers", None)
            else:
                sys.modules["transformers"] = saved
        launches["readiness"] = dict(zip(KERNEL_NAMES, _counts()))
        verdict = json.loads(out.strip().splitlines()[-1])
        hf = [verdict["checks"][k]["detail"] for k in ("hf_text", "hf_image")]
        if rc != 0 or not verdict["ok"] or not all(verdict["checks"][k]["ok"] for k in ("hf_text", "hf_image")):
            raise AssertionError(f"readiness: rc {rc}, verdict {verdict}")
        result["readiness"] = {"rc": rc, "checks": {k: v["ok"] for k, v in verdict["checks"].items()},
                               "hf_text": hf[0], "smoke": verdict["checks"]["smoke"]["detail"],
                               "smoke_updates": _stage_numbers(rec.take(), "readiness smoke"),
                               "launches": launches["readiness"]}
        lap("readiness")

        # 4. sample_run.sh at canonical width: contrastive, then the transfer
        corpus = os.path.join(root, "scripts")
        paths = two_stage.generate_mini_corpus(corpus, n_trees=WF_SCRIPT_TREES, seed=seed + 1, image_px=224,
                                               image_format=image_format)
        make_splits(paths["raw"], os.path.join(corpus, "splits"), n_splits=1, seed=seed)
        os.environ["MDT_BERT_VOCAB"] = paths["vocab"]
        try:
            t = time.perf_counter()
            copies = ingest.process(paths["raw"], os.path.join(corpus, "data"),
                                    train_idx_file=os.path.join(corpus, "splits", "train-idx.txt"),
                                    test_idx_file=os.path.join(corpus, "splits", "test-idx.txt"),
                                    image_root=corpus, log_every=0)
            ingest_s = time.perf_counter() - t
        finally:
            os.environ.pop("MDT_BERT_VOCAB", None)
        with open(paths["communities"]) as f:
            contr = _contrastive_dir_from_ingest(os.path.join(corpus, "data"), json.load(f),
                                                 os.path.join(corpus, "contrastive"), seed)
        here = os.path.dirname(os.path.abspath(__file__))
        # the script's ``python`` records the launcher argv that
        # sample_run.sh builds, which then runs in this process (a launcher
        # process spends ~30 s outside its 2 updates)
        argv_path = os.path.join(root, "script_argv.json")
        os.makedirs(os.path.join(root, "bin"))
        with open(os.path.join(root, "bin", "python"), "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" -c \'import json, sys; json.dump(sys.argv[2:], '
                    f'open(sys.argv[1], "w"))\' "{argv_path}" "$@"\n')
        os.chmod(os.path.join(root, "bin", "python"), 0o755)
        script = os.path.join(here, "multimodaldiscussiontransformer_tpu_torch", "experiments",
                              "hateful_discussions", "sample_run.sh")
        runs = {}
        for name, extra_env, args in (
                ("contrastive", {"HF_INIT": "1"},
                 ["--task", "contrastive_learning", "--criterion", "contrastive_loss",
                  "--update-freq", "1", "--data-root", os.path.join(corpus, "contrastive")]),
                ("node", {"RESTORE_FILE": os.path.join(root, "stage_contrastive")},
                 ["--data-root", os.path.join(corpus, "data"), "--no-save"])):
            save = os.path.join(root, f"stage_{name}")
            env = {**os.environ, "PATH": os.path.join(root, "bin") + os.pathsep + os.environ.get("PATH", ""),
                   "PYTHONUNBUFFERED": "1", "SAVE_DIR": save, **extra_env}
            torch.cuda.empty_cache()
            t = time.perf_counter()
            proc = subprocess.run(["bash", script, *args, "--max-updates", "2", "--log-interval", "1",
                                   "--seed", str(seed + 2)],
                                  cwd=here, env=env, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"sample_run.sh ({name}) exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                                     f"{proc.stderr[-3000:]}")
            with open(argv_path) as f:
                argv = json.load(f)
            if argv[:2] != ["-m", "multimodaldiscussiontransformer_tpu_torch.train.launch"]:
                raise AssertionError(f"sample_run.sh ({name}) ran python {argv[:2]}")
            if ("--hf-init" in argv) != (name == "contrastive"):
                raise AssertionError(f"sample_run.sh ({name}): HF_INIT={extra_env.get('HF_INIT')} gave {argv}")
            rc, stdout, _, counts, _ = _launch_in_process(argv[2:])
            seconds = time.perf_counter() - t
            if rc != 0 or not all(counts[k] for k in (
                    "tree_attention_fwd_fused", "tree_attention_bwd_dq_fused", "tree_attention_bwd_dkv_fused")):
                raise AssertionError(f"sample_run.sh ({name}): rc {rc}, launches {counts}\n{stdout[-2000:]}")
            losses = [r["loss"] for _, r in sorted(_train_records(save).items())]
            if name == "contrastive":
                # the towers from the cache; rows 7 and 8 launched as the
                # config says for 2 updates of one microbatch (every graph
                # layer's backward under the contrastive loss), plus whole
                # scoring forwards in the test evaluation
                mc = config_from_args(build_parser().parse_args(argv[2:])).model
                per_update = dict(zip(KERNEL_NAMES, expected_launches(mc, fused=False, k=1, images=True,
                                                                      text_len=TEXT_LEN, contrastive=True)))
                eval_fwd = counts["tree_attention_fwd_fused"] - 2 * per_update["tree_attention_fwd_fused"]
                if ("initialized towers from HF checkpoints" not in stdout or not np.isfinite(losses).all()
                        or len(losses) != 2 or eval_fwd <= 0 or eval_fwd % LAUNCHES_PER_FORWARD
                        or any(counts[k] != 2 * per_update[k] for k in
                               ("tree_attention_bwd_dq_fused", "tree_attention_bwd_dkv_fused"))):
                    raise AssertionError(f"sample_run.sh --hf-init: losses {losses}, launches {counts} (per update "
                                         f"{per_update})\n{stdout[-2000:]}")
            launches[f"sample_run_{name}"] = counts
            runs[name] = {"seconds": seconds, "ms_per_update": _ms_per_update(save), "losses": losses,
                          "test": _test_metrics(stdout), "launches": counts, "hf_init": "--hf-init" in argv}
        if "restored from" not in stdout:
            raise AssertionError(f"sample_run.sh (node): no restore in\n{stdout[-2000:]}")
        result["sample_run"] = {"ingest": {"trees": WF_SCRIPT_TREES, "copies": copies, "seconds": ingest_s},
                                "contrastive_dir": contr, **runs}
        print(json.dumps({"sample_run_ms_per_update": {k: v["ms_per_update"] for k, v in runs.items()},
                          "test": runs["node"]["test"], "card": card}), flush=True)
        lap("sample_run")

        # 5. the comment-only BERT baseline at BERT-base width
        tok = BertWordPieceTokenizer(paths["vocab"])
        cfg = text_bert.TextBertConfig(max_steps=WF_BERT_STEPS, eval_steps=WF_BERT_STEPS, warmup_steps=4,
                                       lr=1e-4, seed=seed)
        train_data = _bert_comments(WF_BERT_TRAIN, seed, tok, cfg.max_length)
        valid_data = _bert_comments(WF_BERT_VALID, seed + 1, tok, cfg.max_length)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        timings, logs = {}, []
        _, best, logits = text_bert.train(cfg, train_data, valid_data, log_fn=logs.append, device="cuda",
                                          timings=timings)
        launches["comment_only"] = dict(zip(KERNEL_NAMES, _counts()))
        if logits.shape != (WF_BERT_VALID, 2) or not np.isfinite(logits).all() or len(timings["eval"]) != 1:
            raise AssertionError(f"comment_only: logits {logits.shape}, evaluations {len(timings.get('eval', []))}")
        result["comment_only"] = {
            "config": "BERT-base (12 layers, 768, 12 heads), 100 tokens, batch 48, float32 (TF32 off)",
            "steps": WF_BERT_STEPS, "ms_per_step_median": float(np.median(timings["step"][1:]) * 1e3),
            "ms_first_step": timings["step"][0] * 1e3, "eval_seconds": timings["eval"][0],
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30, "best": best, "log": logs,
            "launches": launches["comment_only"],
            "card_vs_cpu": _comment_only_card_vs_cpu(tok, seed)}
        lap("comment_only")
    finally:
        os.environ.pop("HF_HUB_CACHE", None)
        shutil.rmtree(root, ignore_errors=True)
    result["launches"] = {k: sum(c[k] for c in launches.values()) for k in KERNEL_NAMES}
    result["launches_by_run"] = {run: {k: v for k, v in c.items() if v} for run, c in launches.items()}
    result["step_seconds"] = steps
    result["seconds"] = time.perf_counter() - t_phase
    emit(result)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--only", choices=("kernels", "parallel", "sequence_parallel", "workflows"), default=None,
                   help="build, then only this phase (for iterating on it; the kernels' summary is not printed); "
                        "kernels: the phases that hold every kernel against its plain version (kernel_vs_plain, "
                        "kernel_vs_plain_train, masked_vs_plain, biased_vs_plain)")
    p.add_argument("--parallel-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--parallel-plan", default=None, help=argparse.SUPPRESS)
    p.add_argument("--parallel-out", default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else argv
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.parallel_rank is not None:  # one rank of phase_parallel's runs
        return parallel_rank_worker(args.parallel_plan, args.parallel_rank, args.parallel_out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    clock, t_run = {}, time.perf_counter()

    def clocked(name, fn, *a, **k):
        """``fn(*a, **k)``, its wall seconds kept in ``clock[name]``."""
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            clock[name] = time.perf_counter() - t

    card = clocked("build", phase_build)
    if args.only is not None:
        def kernels(seed, card):
            for name, fn in (("kernel", phase_kernel), ("kernel_train", phase_kernel_train), ("masked", phase_masked),
                             ("biased", phase_biased)):
                clocked(name, fn, seed)
            emit({"phase": "seconds_by_phase", "card": card, "seconds": clock,
                  "total_seconds": time.perf_counter() - t_run})

        {"kernels": kernels, "parallel": phase_parallel, "sequence_parallel": phase_sequence_parallel,
         "workflows": phase_workflows}[args.only](args.seed, card)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    try:
        rows = clocked("kernel", phase_kernel, args.seed)
        train_rows, dh16_row = clocked("kernel_train", phase_kernel_train, args.seed)
        masked_rows = clocked("masked", phase_masked, args.seed)
        biased_rows, biased_dh16 = clocked("biased", phase_biased, args.seed)
        scorer, scoring, rng, unfused = clocked("scoring", phase_scoring, args.seed)
        scoring_fused = clocked("scoring_fused", phase_scoring_fused, unfused)
        clocked("latency", phase_latency, scorer, rng)
        del scorer, unfused
        torch.cuda.empty_cache()
        train = clocked("train", run_train, args.seed, "train", batch_size=12, fused=False,
                        timed_updates=TIMED_UPDATES, trace=True, card=card,
                        dataset_kw=dict(num_graphs=TRAIN_GRAPHS, min_nodes=8, max_nodes=32, image_prob=0.25))
        train_fused = clocked("train_fused", run_train, args.seed, "train_fused", batch_size=12, fused=True,
                              timed_updates=TIMED_UPDATES, trace=False, card=card,
                              dataset_kw=dict(num_graphs=TRAIN_GRAPHS, min_nodes=8, max_nodes=32, image_prob=0.25))
        train_big = clocked("train_big", run_train, args.seed, "train_big", batch_size=1, fused=True,
                            timed_updates=BIG_TIMED_UPDATES, trace=True, card=card,
                            dataset_kw=dict(num_graphs=BIG_GRAPHS, min_nodes=520, max_nodes=1000, image_prob=0.05))
        clocked("input_ab", phase_input_ab, args.seed, card)
        workers = clocked("runtime_workers", phase_workers, args.seed, card)
        remat = clocked("runtime_remat", phase_remat, args.seed, card)
        agree_remat = {p: clocked(f"train_cpu_agreement_fused_remat_{p}", phase_train_cpu_agreement, args.seed,
                                  fused=True, variant=f"remat_{p}", card=card)
                       for p in REMAT_POLICIES}
        # float32: the 3xTF32 tree forward and pair, the fused towers' 3xTF32
        # forward and pair
        agree = clocked("train_cpu_agreement", phase_train_cpu_agreement, args.seed, fused=False)
        agree_fused = clocked("train_cpu_agreement_fused", phase_train_cpu_agreement, args.seed, fused=True)
        agree_variants = {v: clocked(f"train_cpu_agreement_{v}", phase_train_cpu_agreement, args.seed, fused=False,
                                     variant=v)
                          for v in ("contrastive", "multisteps", "bf16_adam")}
        dense = clocked("dense_graph", phase_dense_graph, args.seed)
        clocked("launch", phase_launch)
        profile = clocked("runtime_profile", phase_profile, args.seed, card)
        clocked("checkpoint", phase_checkpoint, args.seed, card)
        contrastive = clocked("contrastive", phase_contrastive, args.seed)
        outside = tempfile.mkdtemp(prefix="mdt_outside_")
        try:
            ingest = clocked("ingest", phase_ingest, args.seed, card, outside)
            weights_in = clocked("weights_in", phase_weights_in, args.seed, card, outside, ingest)
        finally:
            shutil.rmtree(outside, ignore_errors=True)
        parallel = clocked("parallel", phase_parallel, args.seed, card)
        sequence_parallel = clocked("sequence_parallel", phase_sequence_parallel, args.seed, card)
        workflows = clocked("workflows", phase_workflows, args.seed, card)
    finally:
        drop_shared_discussions()
        emit({"phase": "seconds_by_phase", "card": card, "seconds": clock,
              "total_seconds": time.perf_counter() - t_run})

    serve_row = rows[0]  # S=33, B=16: the canonical serving shape
    train_row = train_rows[0]  # S=33, B=12: the canonical training shape
    big_rows = [r for r in train_rows if r["S"] >= 513]
    bf16 = train_row["errors"]["bfloat16"]
    ms = train_row["ms"]
    long_row = next(r for r in masked_rows if r["shape"] == MASKED_LONG[0])  # bf16 there: the CUDA-core forward
    by_path = {"scoring": scoring, "train": train, "train_fused": train_fused, "train_big": train_big,
               "scoring_fused": scoring_fused, "train_cpu_agreement": agree, "train_cpu_agreement_fused": agree_fused,
               "dense_graph": dense["scoring"], "dense_graph_train": dense["training"],
               "dense_graph_float32_step": dense["float32_step"],
               **{f"train_cpu_agreement_{v}": counts for v, counts in agree_variants.items()},
               "runtime_workers": workers, "runtime_profile": profile,
               **{f"runtime_remat_{p}": counts for p, counts in remat.items()},
               **{f"train_cpu_agreement_fused_remat_{p}": counts for p, counts in agree_remat.items()},
               **{f"contrastive_{part}": contrastive[part]["launches"]
                  for part in ("pretrain", "transfer", "multisteps", "bf16_adam", "bf16_params")},
               "ingest": ingest["launches"], "weights_in_orbax_restore": weights_in,
               "parallel": parallel["launches"], "parallel_tp_h6": parallel["launches_tp_h6"],
               "sequence_parallel": sequence_parallel["launches"],
               "sequence_parallel_ring_tiles": sequence_parallel["launches_ring_tiles"],
               "workflows": workflows["launches"],
               "kernel_vs_plain_train_dh16_bfloat16": dh16_row["launches_bfloat16"],
               "masked_vs_plain_long_300_bfloat16": {
                   n: long_row["launches"][f"bfloat16_rate{MASKED_RATE}"].get(n, 0) for n in KERNEL_NAMES},
               "biased_vs_plain_dh16_bfloat16": biased_dh16["launches"]}

    def paths(name, extra=None):
        out = {path: counts[name] for path, counts in by_path.items()}
        return {**out, **(extra or {})}

    streaming = [{k: r[k] for k in ("S", "B", "ms", "bound")} for r in big_rows]
    k1_worst = max(r[k][name]["out"]["max_abs_err"] for r in train_rows for k in ("errors", "errors_rate0")
                   for name in ("float32_k1", "bfloat16_cuda_core"))
    fused_rows = [r for r in masked_rows if r["kernel_route"]["bfloat16"] == "tensor_core"]
    fusion_row = next(r for r in masked_rows if r["shape"] == "text_fusion")
    vit_row = next(r for r in masked_rows if r["shape"] == "vit_fusion")
    mms = fusion_row["ms"]
    serve_biased = biased_rows[0]  # S=33, B=16: the dense graph path's scoring shape
    bms = serve_biased["ms"]
    print(card, flush=True)
    tree_bwd_dq_replaces = [f"{TPU_KERNELS}:1007", f"{TPU_KERNELS}:468"]
    tree_bwd_dkv_replaces = [f"{TPU_KERNELS}:1007", f"{TPU_KERNELS}:558"]

    def k23_worst(outputs):
        """K2/K3's largest max-abs error of ``outputs``: their float32 and
        bf16 checks (called directly) at every training shape and their
        checks at DH 16, both rates."""
        return max([r[k][name][o]["max_abs_err"] for r in train_rows for k in ("errors", "errors_rate0")
                    for name in ("float32_cuda_core_pair", "bfloat16_cuda_core_pair") for o in outputs]
                   + [dh16_row[k][name][o]["max_abs_err"] for k in ("errors", "errors_rate0")
                      for name in ("float32_cuda_core_pair", "bfloat16") for o in outputs])

    def tf32_worst(outputs):
        """The 3xTF32 pair's largest max-abs error of ``outputs`` against the
        plain version: the float32 route at every training shape and at DH
        16, both rates."""
        return max(r[k]["float32"][o]["max_abs_err"] for r in train_rows + [dh16_row]
                   for k in ("errors", "errors_rate0") for o in outputs)

    def tf32_fwd_worst():
        """The 3xTF32 tree forward's largest max-abs error of out against the
        plain version: the float32 route at every training shape and at DH
        16 (both rates) and at the scoring shapes (rate 0)."""
        return max([r[k]["float32"]["out"]["max_abs_err"] for r in train_rows + [dh16_row]
                    for k in ("errors", "errors_rate0")] + [r["max_abs_err_float32"] for r in rows])

    f32_row = train_row["float32"]  # S=33, B=12 on float32 inputs
    tf32_fwd_shapes = [{"S": r["S"], "B": r["B"], "ms": r["float32"]["ms"]["fwd_tf32"],
                        "cuda_core_ms": r["float32"]["ms"]["fwd_cuda_core"],
                        "library_ms": r["float32"]["ms"]["library_contiguous_fwd"],
                        "bound_f32_ms": r["float32"]["bound"]["fwd"][0],
                        "bound_3xtf32_ms": r["float32"]["bound_3xtf32"]["fwd"][0],
                        "lse_vs_k1_max_abs_err": r["errors"]["float32_lse_vs_k1"]["max_abs_err"]}
                       for r in train_rows]
    tf32_fwd_scoring = [{"S": r["S"], "B": r["B"], "ms": r["float32"]["ms"], "cuda_core_ms": r["float32"]["cuda_core_ms"],
                         "library_ms": r["float32"]["library_contiguous_ms"], "bound_f32_ms": r["float32"]["bound_ms"],
                         "bound_3xtf32_ms": r["float32"]["bound_3xtf32_ms"]} for r in rows]
    tf32_fwd_dh16 = {**DH16_SHAPE, "ms": dh16_row["ms"]["fwd_tf32"], "cuda_core_ms": dh16_row["ms"]["fwd_cuda_core"],
                     "library_ms": dh16_row["ms"]["library_contiguous_fwd"],
                     "bound_f32_ms": dh16_row["bound"]["fwd"][0], "bound_3xtf32_ms": dh16_row["bound_3xtf32"]["fwd"][0]}
    tf32_shapes = [{"S": r["S"], "B": r["B"], "pair_ms": r["float32"]["ms"]["pair_tf32"],
                    "dq_ms": r["float32"]["ms"]["dq_tf32"], "dkv_ms": r["float32"]["ms"]["dkv_tf32"],
                    "cuda_core_pair_ms": r["float32"]["ms"]["pair_cuda_core"],
                    "library_ms": r["float32"]["ms"]["library_contiguous_fwd_bwd"],
                    "bound_f32_ms": r["float32"]["bound"]["dq"][0] + r["float32"]["bound"]["dkv"][0],
                    "bound_3xtf32_ms": r["float32"]["bound_3xtf32"]["dq"][0] + r["float32"]["bound_3xtf32"]["dkv"][0]}
                   for r in train_rows]
    tf32_dh16 = {**DH16_SHAPE, "pair_ms": dh16_row["ms"]["pair_tf32"], "cuda_core_pair_ms": dh16_row["ms"]["pair_cuda_core"],
                 "library_ms": dh16_row["ms"]["library_contiguous_fwd_bwd"], "plain_bwd_ms": dh16_row["ms"]["plain_bwd"],
                 "bound_f32_ms": dh16_row["bound"]["dq"][0] + dh16_row["bound"]["dkv"][0],
                 "bound_3xtf32_ms": dh16_row["bound_3xtf32"]["dq"][0] + dh16_row["bound_3xtf32"]["dkv"][0]}

    def h6(op, ms_key, bound_key, errs):
        """A kernel's numbers at H = 6 (a tp=2 rank's heads) from
        phase_parallel: ms, plain, SDPA, bound, its launches on the tp run."""
        row = parallel["h6_kernels"][op]
        return {"B": row["B"], "H": row["H"], "S": row["S"], "ms": row["ms"][ms_key],
                "plain_ms": row["ms"][f"plain_{ms_key}"], "library_ms": row["ms"].get(f"library_{ms_key}"),
                "bound_ms": row["bound"][bound_key][0], "bound_by": row["bound"][bound_key][1],
                "max_abs_err": max(row["errors"][e]["max_abs_err"] for e in errs)}

    tree_fwd_replaces = [f"{TPU_KERNELS}:973", f"{TPU_KERNELS}:103", f"{TPU_KERNELS}:66", f"{TPU_KERNELS}:228",
                         f"{TPU_KERNELS}:418 (the LSE the forward saves)"]
    kernels = [
        {**_kernel_entry(
            "tree_attention_fwd", KERNEL_SOURCE, f"{TPU_KERNELS}:1096", tree_fwd_replaces,
            dh16_row["launches_bfloat16"]["tree_attention_fwd"], train_row, k1_worst, "fwd_cuda_core", ms["plain_fwd"],
            ms["library_contiguous_fwd"], "fwd"),
         "launches_by_path": paths("tree_attention_fwd"),
         "serving_rate0": {"S": serve_row["S"], "B": serve_row["B"], "ms": serve_row["cuda_core_ms"],
                           "plain_ms": serve_row["plain_ms"], "library_ms": serve_row["library_contiguous_ms"],
                           "bound_ms": serve_row["bound_ms"],
                           "max_abs_err_bfloat16": serve_row["max_abs_err_bfloat16_cuda_core"]},
         "float32": _float32_numbers(train_row, "fwd_cuda_core", "library_contiguous_fwd", "fwd"),
         "note": "K1, the bf16 route at DH 16, 32, 128 (the float32 route's forward is the 3xTF32 one): launches "
                 "from the bf16 DH-16 call through tree_attention (kernel_vs_plain_train_dh16), 0 on every other "
                 "path; times on bf16 inputs at S=33, B=12, rate 0.3 with the LSE (float32: the same on float32 "
                 "inputs, called directly, beside SDPA in float32 and the float32 bound); library_ms is SDPA at "
                 "dropout 0.3 on a contiguous copy of the dense bias; max_abs_err over its float32 and bf16 checks "
                 "called directly at every training shape and both rates"},
        {**_kernel_entry(
            "tree_attention_fwd_fused", KERNEL_MMA_SOURCE, f"{TPU_KERNELS}:1096", tree_fwd_replaces,
            train["tree_attention_fwd_fused"], train_row, _worst(train_rows, ("out",)), "fwd", ms["plain_fwd"],
            ms["library_contiguous_fwd"], "fwd"),
         "launches_by_path": paths("tree_attention_fwd_fused"),
         "tp_h6": h6("tree", "fwd", "fwd", ("out",)),
         "cuda_core_ms": ms["fwd_cuda_core"],
         "serving_rate0": {"S": serve_row["S"], "B": serve_row["B"], "ms": serve_row["ms"],
                           "cuda_core_ms": serve_row["cuda_core_ms"], "plain_ms": serve_row["plain_ms"],
                           "library_ms": serve_row["library_contiguous_ms"], "bound_ms": serve_row["bound_ms"],
                           "max_abs_err_bfloat16": serve_row["max_abs_err_bfloat16"]},
         "streaming": streaming, "scoring_shapes": rows, "shapes": train_rows,
         "note": "the bf16 route (DH 64, any S): launches from the canonical train run; times at S=33, B=12, rate "
                 "0.3 with the LSE; cuda_core_ms is the CUDA-core forward on the same inputs; library_ms is SDPA at "
                 "dropout 0.3 on a contiguous copy of the dense bias; max_abs_err is the worst bf16 error of out "
                 "over every training shape and both rates"},
        {**_kernel_entry(
            "tree_attention_bwd_dq", BWD_SOURCE, f"{TPU_KERNELS}:1148", tree_bwd_dq_replaces,
            dh16_row["launches_bfloat16"]["tree_attention_bwd_dq"], train_row, k23_worst(("dq", "dlut")),
            "dq_cuda_core", ms["plain_bwd"], ms["library_contiguous_fwd_bwd"], "dq"),
         "launches_by_path": paths("tree_attention_bwd_dq"),
         "float32": _float32_numbers(train_row, "dq_cuda_core", "library_contiguous_fwd_bwd", "dq"),
         "note": "K2, the bf16 route at DH 16, 32, 128 (the float32 route's backward is the 3xTF32 pair): "
                 "launches from the bf16 DH-16 call through tree_attention (kernel_vs_plain_train_dh16), "
                 "0 on every other path; times on bf16 inputs at S=33, B=12, rate 0.3 (float32: on float32 "
                 "inputs); plain_ms is the plain version's whole autograd backward (dq, dk, dv, dlut); library_ms "
                 "is SDPA forward + backward at rate 0 on a contiguous copy of the dense bias; max_abs_err over "
                 "its checks called directly (float32, bf16) at every training shape and at DH 16, both rates"},
        {**_kernel_entry(
            "tree_attention_bwd_dkv", BWD_SOURCE, f"{TPU_KERNELS}:1148", tree_bwd_dkv_replaces,
            dh16_row["launches_bfloat16"]["tree_attention_bwd_dkv"], train_row, k23_worst(("dk", "dv")),
            "dkv_cuda_core", ms["plain_bwd"], ms["library_contiguous_fwd_bwd"], "dkv"),
         "launches_by_path": paths("tree_attention_bwd_dkv"),
         "float32": _float32_numbers(train_row, "dkv_cuda_core", "library_contiguous_fwd_bwd", "dkv"),
         "note": "K3; launches, times, plain_ms, library_ms and max_abs_err as for tree_attention_bwd_dq"},
        {**_kernel_entry(
            "tree_attention_bwd_dq_tf32", BWD_TF32_SOURCE, f"{TPU_KERNELS}:1148", tree_bwd_dq_replaces,
            agree["tree_attention_bwd_dq_tf32"], f32_row, tf32_worst(("dq", "dlut")), "dq_tf32",
            f32_row["ms"]["plain_bwd"], f32_row["ms"]["library_contiguous_fwd_bwd"], "dq"),
         "launches_by_path": paths("tree_attention_bwd_dq_tf32"),
         "bound_3xtf32_ms": f32_row["bound_3xtf32"]["dq"][0], "cuda_core_ms": f32_row["ms"]["dq_cuda_core"],
         "shapes": tf32_shapes, "dh16": tf32_dh16,
         "note": "the float32 route's backward (any DH), 3xTF32 on mma.sync: launches from train_cpu_agreement, "
                 "0 on the bf16 paths; times on float32 inputs at S=33, B=12, H=12, DH 64, rate 0.3; cuda_core_ms is "
                 "K2 on the same inputs; bound_ms is the float32 bound (67 TFLOP/s), bound_3xtf32_ms three TF32 "
                 "products per float32 one at 494.7 TFLOP/s; plain_ms is the plain version's whole autograd backward "
                 "in float32; library_ms is SDPA forward + backward in float32 at rate 0 on a contiguous bias; "
                 "max_abs_err is the worst float32 error of dq and dlut over every training shape, DH 16 and both "
                 "rates; shapes: the pair (dq + dk/dv) at every training shape"},
        {**_kernel_entry(
            "tree_attention_bwd_dkv_tf32", BWD_TF32_SOURCE, f"{TPU_KERNELS}:1148", tree_bwd_dkv_replaces,
            agree["tree_attention_bwd_dkv_tf32"], f32_row, tf32_worst(("dk", "dv")), "dkv_tf32",
            f32_row["ms"]["plain_bwd"], f32_row["ms"]["library_contiguous_fwd_bwd"], "dkv"),
         "launches_by_path": paths("tree_attention_bwd_dkv_tf32"),
         "bound_3xtf32_ms": f32_row["bound_3xtf32"]["dkv"][0], "cuda_core_ms": f32_row["ms"]["dkv_cuda_core"],
         "note": "the 3xTF32 dk/dv kernel; launches, times, bounds, plain_ms, library_ms as for "
                 "tree_attention_bwd_dq_tf32 (max_abs_err: dk and dv)"},
        {**_kernel_entry(
            "tree_attention_fwd_tf32", KERNEL_TF32_SOURCE, f"{TPU_KERNELS}:1096", tree_fwd_replaces,
            agree["tree_attention_fwd_tf32"], f32_row, tf32_fwd_worst(), "fwd_tf32", f32_row["ms"]["plain_fwd"],
            f32_row["ms"]["library_contiguous_fwd"], "fwd"),
         "launches_by_path": paths("tree_attention_fwd_tf32"),
         "bound_3xtf32_ms": f32_row["bound_3xtf32"]["fwd"][0], "cuda_core_ms": f32_row["ms"]["fwd_cuda_core"],
         "shapes": tf32_fwd_shapes, "scoring_rate0": tf32_fwd_scoring, "dh16": tf32_fwd_dh16,
         "note": "the float32 route's forward (any DH, any S), 3xTF32 on mma.sync: launches from "
                 "train_cpu_agreement, 0 on the bf16 paths; times on float32 inputs at S=33, B=12, H=12, DH 64, "
                 "rate 0.3 with the LSE; cuda_core_ms is K1 on the same inputs; bound_ms is the float32 bound "
                 "(67 TFLOP/s), bound_3xtf32_ms three TF32 products per float32 one at 494.7 TFLOP/s; plain_ms is "
                 "the plain version in float32; library_ms is SDPA in float32 at dropout 0.3 on a contiguous bias; "
                 "max_abs_err is the worst float32 error of out over every training shape, DH 16, both rates and "
                 "the scoring shapes; shapes: the same at every training shape, with the LSE against K1's"},
        {**_kernel_entry(
            "tree_attention_bwd_dq_fused", BWD_MMA_SOURCE, f"{TPU_KERNELS}:1148", tree_bwd_dq_replaces,
            train_big["tree_attention_bwd_dq_fused"], train_row, _worst(train_rows, ("dq", "dlut")), "dq",
            ms["plain_bwd"], ms["library_contiguous_fwd_bwd"], "dq"),
         "launches_by_path": paths("tree_attention_bwd_dq_fused"),
         "tp_h6": {**h6("tree", "fwd_bwd", "dq", ("dq", "dlut")),
                   "note": "ms, plain_ms and library_ms: forward + backward at H = 6; bound_ms: dq's"},
         "cuda_core_ms": ms["dq_cuda_core"],
         "streaming": [{"S": r["S"], "B": r["B"], "pair_ms": r["ms"]["pair"], "cuda_core_ms": r["ms"]["pair_cuda_core"],
                        "library_ms": r["ms"]["library_contiguous_fwd_bwd"],
                        "bound_ms": r["bound"]["dq"][0] + r["bound"]["dkv"][0]} for r in big_rows],
         "note": "the bf16 route (DH 64, any S): launches from train_big; times at S=33, B=12, rate 0.3; "
                 "cuda_core_ms is K2 on the same inputs; plain_ms is the plain version's whole autograd backward; "
                 "library_ms is SDPA forward + backward at rate 0 on a contiguous copy of the dense bias; "
                 "max_abs_err is the worst bf16 error of dq and dlut over every training shape and both rates"},
        {**_kernel_entry(
            "tree_attention_bwd_dkv_fused", BWD_MMA_SOURCE, f"{TPU_KERNELS}:1148", tree_bwd_dkv_replaces,
            train_big["tree_attention_bwd_dkv_fused"], train_row, _worst(train_rows, ("dk", "dv")), "dkv",
            ms["plain_bwd"], ms["library_contiguous_fwd_bwd"], "dkv"),
         "launches_by_path": paths("tree_attention_bwd_dkv_fused"),
         "tp_h6": {**h6("tree", "fwd_bwd", "dkv", ("dk", "dv")),
                   "note": "ms, plain_ms and library_ms: forward + backward at H = 6; bound_ms: dk/dv's"},
         "cuda_core_ms": ms["dkv_cuda_core"],
         "note": "the bf16 route: launches from train_big; cuda_core_ms is K3 on the same inputs; times, plain_ms, "
                 "library_ms and max_abs_err as for tree_attention_bwd_dq_fused (dk and dv)"},
        {**_kernel_entry(
            "masked_attention_fwd", MASKED_FWD_SOURCE, f"{TPU_MASKED}:86", [],
            long_row["launches"][f"bfloat16_rate{MASKED_RATE}"]["masked_attention_fwd"], fusion_row,
            max([r["float32_cuda_core_fwd"]["out"]["max_abs_err"] for r in masked_rows]
                + [r[k]["bfloat16_pair"]["out"]["max_abs_err"] for r in masked_rows for k in ("errors", "errors_rate0")
                   if "bfloat16_pair" in r[k]]
                + [long_row[k]["bfloat16"]["out"]["max_abs_err"] for k in ("errors", "errors_rate0")]),
            "fwd", mms["plain_fwd"], mms["library_fwd"], "fwd"),
         "launches_by_path": paths("masked_attention_fwd"),
         "float32": _float32_numbers(fusion_row, "fwd", "library_fwd", "fwd"),
         "note": "the bf16 route at other DH and S > 256 (the float32 route's forward is the 3xTF32 one): launches "
                 "from the bf16 check at S=300 (masked_vs_plain long_300, rate 0.3), 0 on every other path; times "
                 "on bf16 inputs at the text-fusion shape (B=256, S=104), rate 0.3 with the row statistics "
                 "(float32: the same on float32 inputs, called directly); library_ms is SDPA with the key-padding "
                 "bias and dropout 0.3; max_abs_err over its float32 checks called directly at every shape, its "
                 "bf16 checks at the tower shapes and at S=300"},
        {**_kernel_entry(
            "masked_attention_fwd_fused", MASKED_FWD_MMA_SOURCE, f"{TPU_MASKED}:86", [],
            train_big["masked_attention_fwd_fused"], fusion_row, _worst(fused_rows, ("out",)), "fwd_fused",
            mms["plain_fwd"], mms["library_fwd"], "fwd"),
         "launches_by_path": paths("masked_attention_fwd_fused"),
         "tp_h6": h6("tower", "fwd", "fwd", ("out",)),
         "cuda_core_ms": mms["fwd"],
         "tower_shapes": {r["shape"]: {"B": r["B"], "S": r["S"], "ms": r["ms"]["fwd_fused"],
                                       "ms_rate0": r["ms"]["fwd_fused_rate0"], "cuda_core_ms": r["ms"]["fwd"],
                                       "plain_ms": r["ms"]["plain_fwd"], "library_ms": r["ms"]["library_fwd"],
                                       "bound_ms": r["bound"]["fwd"][0]}
                          for r in masked_rows if r["shape"] in {m[0] for m in MASKED_SHAPES}},
         "note": "the bf16 route (DH 64, S <= 256): launches from train_big; times at the text-fusion shape "
                 "(B=256, S=104), rate 0.3 with the row statistics; cuda_core_ms is the CUDA-core forward on the "
                 "same inputs; library_ms is SDPA with the key-padding bias and dropout 0.3; max_abs_err is the "
                 "worst bf16 error of out over every shape it takes and both rates",
         "shapes": masked_rows},
        {**_kernel_entry(
            "masked_attention_fwd_tf32", MASKED_FWD_TF32_SOURCE, f"{TPU_MASKED}:86", [],
            agree_fused["masked_attention_fwd_tf32"], fusion_row["float32"],
            max(r[k]["float32"]["out"]["max_abs_err"] for r in masked_rows for k in ("errors", "errors_rate0")),
            "fwd_tf32", fusion_row["float32"]["ms"]["plain_fwd"], fusion_row["float32"]["ms"]["library_fwd"], "fwd"),
         "launches_by_path": paths("masked_attention_fwd_tf32"),
         "bound_3xtf32_ms": fusion_row["float32"]["bound_3xtf32"]["fwd"][0],
         "cuda_core_ms": fusion_row["float32"]["ms"]["fwd"],
         "tower_shapes": {r["shape"]: {"B": r["B"], "S": r["S"], "ms": r["float32"]["ms"]["fwd_tf32"],
                                       "cuda_core_ms": r["float32"]["ms"]["fwd"],
                                       "plain_ms": r["float32"]["ms"]["plain_fwd"],
                                       "library_ms": r["float32"]["ms"]["library_fwd"],
                                       "bound_f32_ms": r["float32"]["bound"]["fwd"][0],
                                       "bound_3xtf32_ms": r["float32"]["bound_3xtf32"]["fwd"][0],
                                       "stats": r["stats_float32"]}
                          for r in masked_rows if r["shape"] in {m[0] for m in MASKED_SHAPES}},
         "note": "the float32 route's forward (any DH, any S), 3xTF32 on mma.sync, before the 3xTF32 pair: "
                 "launches from train_cpu_agreement_fused, 0 on the bf16 paths; times on float32 inputs at the "
                 "text-fusion shape (B=256, S=104), rate 0.3 with the row statistics; cuda_core_ms is the CUDA-core "
                 "forward on the same inputs; bound_ms is the float32 bound (67 TFLOP/s), bound_3xtf32_ms three "
                 "TF32 products per float32 one at 494.7 TFLOP/s; plain_ms is the plain version in float32; "
                 "library_ms is SDPA in float32 with the key-padding bias and dropout 0.3; max_abs_err is the "
                 "worst float32 error of out over every shape (S=300 included) and both rates"},
        {**_kernel_entry(
            "masked_attention_bwd_dq", MASKED_BWD_SOURCE, f"{TPU_MASKED}:134", [],
            long_row["launches"][f"bfloat16_rate{MASKED_RATE}"]["masked_attention_bwd_dq"],
            fusion_row, _worst_pair(masked_rows, ("dq",)), "dq", mms["plain_bwd"], mms["library_fwd_bwd"], "dq"),
         "launches_by_path": paths("masked_attention_bwd_dq"),
         "float32": _float32_numbers(fusion_row, "dq", "library_fwd_bwd", "dq"),
         "note": "the bf16 route at other DH and S > 256 (the float32 route's backward is the 3xTF32 pair): "
                 "launches from the bf16 check at S=300 (masked_vs_plain long_300, rate 0.3), 0 on every other "
                 "path; times on bf16 inputs at the text-fusion shape (float32: on float32 inputs, called "
                 "directly); plain_ms is the plain version's whole autograd backward (dq, dk, dv); library_ms is "
                 "SDPA forward + backward at rate 0 with the key-padding bias; max_abs_err over its float32 checks "
                 "called directly at every shape, its bf16 checks at the tower shapes and at S=300"},
        {**_kernel_entry(
            "masked_attention_bwd_dkv", MASKED_BWD_SOURCE, f"{TPU_MASKED}:134", [],
            long_row["launches"][f"bfloat16_rate{MASKED_RATE}"]["masked_attention_bwd_dkv"],
            fusion_row, _worst_pair(masked_rows, ("dk", "dv")), "dkv", mms["plain_bwd"], mms["library_fwd_bwd"],
            "dkv"),
         "launches_by_path": paths("masked_attention_bwd_dkv"),
         "float32": _float32_numbers(fusion_row, "dkv", "library_fwd_bwd", "dkv"),
         "note": "as for masked_attention_bwd_dq"},
        {**_kernel_entry(
            "masked_attention_bwd_dq_tf32", MASKED_BWD_TF32_SOURCE, f"{TPU_MASKED}:134", [],
            agree_fused["masked_attention_bwd_dq_tf32"], fusion_row["float32"],
            _worst_tf32_pair(masked_rows, ("dq",)), "dq_tf32", fusion_row["float32"]["ms"]["plain_bwd"],
            fusion_row["float32"]["ms"]["library_fwd_bwd_rate"], "dq"),
         "launches_by_path": paths("masked_attention_bwd_dq_tf32"),
         "bound_3xtf32_ms": fusion_row["float32"]["bound_3xtf32"]["dq"][0],
         "cuda_core_ms": fusion_row["float32"]["ms"]["dq"],
         "tower_shapes": {r["shape"]: {"B": r["B"], "S": r["S"], "dq_ms": r["float32"]["ms"]["dq_tf32"],
                                       "dkv_ms": r["float32"]["ms"]["dkv_tf32"],
                                       "pair_ms": r["float32"]["ms"]["pair_tf32"],
                                       "cuda_core_dq_ms": r["float32"]["ms"]["dq"],
                                       "cuda_core_dkv_ms": r["float32"]["ms"]["dkv"],
                                       "cuda_core_pair_ms": r["float32"]["ms"]["pair"],
                                       "fwd_tf32_ms": r["float32"]["ms"]["fwd_tf32"],
                                       "plain_bwd_ms": r["float32"]["ms"]["plain_bwd"],
                                       "library_fwd_bwd_rate_ms": r["float32"]["ms"]["library_fwd_bwd_rate"],
                                       "library_fwd_bwd_ms": r["float32"]["ms"]["library_fwd_bwd"],
                                       "bound_f32_ms": [r["float32"]["bound"][n][0] for n in ("dq", "dkv")],
                                       "bound_3xtf32_ms": [r["float32"]["bound_3xtf32"][n][0] for n in ("dq", "dkv")],
                                       "bound_3xtf32_by": [r["float32"]["bound_3xtf32"][n][1] for n in ("dq", "dkv")]}
                          for r in masked_rows if r["shape"] in {m[0] for m in MASKED_SHAPES}},
         "note": "the float32 route's backward (any DH, any S), 3xTF32 on mma.sync: launches from "
                 "train_cpu_agreement_fused, 0 on the bf16 paths; times on float32 inputs at the text-fusion shape "
                 "(B=256, S=104), rate 0.3; cuda_core_ms is the CUDA-core dq kernel on the same inputs; bound_ms "
                 "is the float32 bound (67 TFLOP/s), bound_3xtf32_ms three TF32 products per float32 one at 494.7 "
                 "TFLOP/s; plain_ms is the plain version's whole autograd backward in float32; library_ms is SDPA "
                 "forward + backward in float32 at rate 0.3 with the key-padding bias; max_abs_err is the worst "
                 "float32 error of dq over every shape (S=300 included) and both rates; tower_shapes: the pair at "
                 "the three tower shapes"},
        {**_kernel_entry(
            "masked_attention_bwd_dkv_tf32", MASKED_BWD_TF32_SOURCE, f"{TPU_MASKED}:134", [],
            agree_fused["masked_attention_bwd_dkv_tf32"], fusion_row["float32"],
            _worst_tf32_pair(masked_rows, ("dk", "dv")), "dkv_tf32", fusion_row["float32"]["ms"]["plain_bwd"],
            fusion_row["float32"]["ms"]["library_fwd_bwd_rate"], "dkv"),
         "launches_by_path": paths("masked_attention_bwd_dkv_tf32"),
         "bound_3xtf32_ms": fusion_row["float32"]["bound_3xtf32"]["dkv"][0],
         "cuda_core_ms": fusion_row["float32"]["ms"]["dkv"],
         "note": "the 3xTF32 dk/dv kernel; launches, times, bounds, plain_ms and library_ms as for "
                 "masked_attention_bwd_dq_tf32 (max_abs_err: dk and dv)"},
        {**_kernel_entry(
            "masked_attention_bwd_fused", MASKED_BWD_MMA_SOURCE, f"{TPU_MASKED}:134", [],
            train_big["masked_attention_bwd_fused"], fusion_row, _worst(fused_rows, ("dq", "dk", "dv")), "bwd_fused",
            mms["plain_bwd"], mms["library_fwd_bwd_rate"], "bwd_fused"),
         "launches_by_path": paths("masked_attention_bwd_fused"),
         "tp_h6": {**h6("tower", "fwd_bwd", "bwd_fused", ("dq", "dk", "dv")),
                   "note": "ms and plain_ms: forward + backward at H = 6; bound_ms: the one-pass backward's"},
         "pair_ms": mms["pair"],
         "vit_fusion": {k: vit_row[k] for k in ("B", "S", "ms", "bound")},
         "note": "the bf16 route (DH 64, S <= 256): launches from train_big; times at the text-fusion shape "
                 "(B=256, S=104), rate 0.3; pair_ms is the CUDA-core pair (dq + dk/dv) on the same inputs; "
                 "library_ms is SDPA forward + backward at rate 0.3 with the key-padding bias; max_abs_err is the "
                 "worst bf16 error of dq, dk, dv over every shape and both rates"},
        {"name": "biased_attention_fwd", "route": "cuda", "source": BIASED_FWD_SOURCE, "replaces": f"{TPU_BIASED}:61",
         "also_replaces": [], "launches": biased_dh16["launches"]["biased_attention_fwd"],
         "max_abs_err": max([e["out"] for r in biased_rows for n in ("float32_cuda_core", "bfloat16_cuda_core")
                             for e in r["errors"][n].values()] + [e["out"] for e in biased_dh16["errors"].values()]),
         "ms": bms["fwd_cuda_core"], "plain_ms": bms["plain_fwd"], "bound_ms": serve_biased["bound_ms"],
         "bound_by": serve_biased["bound_by"], "library_ms": bms["library_fwd"],
         "launches_by_path": paths("biased_attention_fwd"),
         "float32": {**_float32_numbers(serve_biased, "fwd_cuda_core", "library_fwd", "fwd"),
                     "plain_ms": serve_biased["float32"]["ms"]["plain_fwd"]},
         "dh16_bfloat16": biased_dh16,
         "note": "the bf16 route at DH 16, 32, 128 (the float32 route's forward is the 3xTF32 one): launches from "
                 "the bf16 DH-16 calls through biased_attention (biased_vs_plain_dh16: S=33, B=12, one per bias "
                 "kind), 0 on every other path; times on bf16 inputs at S=33, B=16, per-head (B, H, S, S) bias "
                 "from GraphAttnBias with the key-padding mask, beside the tensor-core kernel on the same inputs "
                 "(float32: the same on float32 inputs and a float32 bias, called directly, beside SDPA in float32 "
                 "and the float32 bound); library_ms is SDPA with the combined bias as a float mask; max_abs_err is "
                 "the worst forward error of its float32 and bf16 checks called directly over every shape and bias "
                 "kind and of the DH-16 calls"},
        {"name": "biased_attention_fwd_fused", "route": "cuda", "source": BIASED_FWD_MMA_SOURCE,
         "replaces": f"{TPU_BIASED}:61", "also_replaces": [], "launches": dense["scoring"]["biased_attention_fwd_fused"],
         "max_abs_err": max(e["out"] for r in biased_rows for e in r["errors"]["bfloat16"].values()),
         "ms": bms["fwd"], "plain_ms": bms["plain_fwd"], "bound_ms": serve_biased["bound_ms"],
         "bound_by": serve_biased["bound_by"], "library_ms": bms["library_fwd"],
         "launches_by_path": paths("biased_attention_fwd_fused"),
         "cuda_core_ms": bms["fwd_cuda_core"],
         "by_shape": [{"S": r["S"], "B": r["B"], "ms": r["ms"]["fwd"], "cuda_core_ms": r["ms"]["fwd_cuda_core"],
                       "library_ms": r["ms"]["library_fwd"], "bound_ms": r["bound_ms"]} for r in biased_rows],
         "note": "the bf16 route (DH 64, any S, either bias dtype): launches from the dense_graph scoring run (2 "
                 "forwards of 10 graph layers); times at S=33, B=16, bf16, per-head (B, H, S, S) bias from "
                 "GraphAttnBias with the key-padding mask; cuda_core_ms is the CUDA-core kernel on the same inputs; "
                 "library_ms is SDPA with the combined bias as a float mask; max_abs_err is the worst bf16 forward "
                 "error over every shape and bias kind",
         "shapes": biased_rows},
        {"name": "biased_attention_fwd_tf32", "route": "cuda", "source": BIASED_FWD_TF32_SOURCE,
         "replaces": f"{TPU_BIASED}:61", "also_replaces": [],
         "launches": dense["float32_step"]["biased_attention_fwd_tf32"],
         "max_abs_err": max(e["out"] for r in biased_rows for e in r["errors"]["float32"].values()),
         **_float32_numbers(serve_biased, "fwd_tf32", "library_fwd", "fwd"),
         "plain_ms": serve_biased["float32"]["ms"]["plain_fwd"],
         "launches_by_path": paths("biased_attention_fwd_tf32"),
         "bound_3xtf32_ms": serve_biased["float32"]["bound_3xtf32"]["fwd"][0],
         "cuda_core_ms": serve_biased["float32"]["ms"]["fwd_cuda_core"],
         "by_shape": [{"S": r["S"], "B": r["B"], "ms": r["float32"]["ms"]["fwd_tf32"],
                       "cuda_core_ms": r["float32"]["ms"]["fwd_cuda_core"],
                       "plain_ms": r["float32"]["ms"]["plain_fwd"], "library_ms": r["float32"]["ms"]["library_fwd"],
                       "bound_f32_ms": r["float32"]["bound"]["fwd"][0],
                       "bound_3xtf32_ms": r["float32"]["bound_3xtf32"]["fwd"][0],
                       "bound_3xtf32_by": r["float32"]["bound_3xtf32"]["fwd"][1]} for r in biased_rows],
         "note": "the float32 route (any DH, any S, either bias dtype), 3xTF32 on mma.sync: launches from the "
                 "dense_graph float32 card step (its 2 graph layers), 0 on the bf16 paths; times on float32 inputs "
                 "at S=33, B=16 with a float32 per-head (B, H, S, S) bias from GraphAttnBias and the key-padding "
                 "mask; cuda_core_ms is the CUDA-core kernel on the same inputs; bound_ms is the float32 bound (67 "
                 "TFLOP/s), bound_3xtf32_ms three TF32 products per float32 one at 494.7 TFLOP/s; plain_ms is the "
                 "plain version in float32; library_ms is SDPA in float32 with the combined bias as a float mask; "
                 "max_abs_err is the worst float32 forward error over every shape and bias kind"},
    ]
    # the CUDA-core routes at the bf16 shapes they serve now, beside SDPA in
    # bf16 and the bf16 bound: the tree's at DH 16, the tower's at S = 300
    tree16, long16 = dh16_row["bfloat16_cuda_core"], long_row["bfloat16_cuda_core"]
    at_route = {
        "tree_attention_fwd": {**DH16_SHAPE, **tree16, "ms_key": "fwd"},
        "tree_attention_bwd_dq": {**DH16_SHAPE, **tree16, "ms_key": "dq"},
        "tree_attention_bwd_dkv": {**DH16_SHAPE, **tree16, "ms_key": "dkv"},
        "masked_attention_fwd": {"S": long_row["S"], "B": long_row["B"], **long16, "ms_key": "fwd"},
        "masked_attention_bwd_dq": {"S": long_row["S"], "B": long_row["B"], **long16, "ms_key": "pair"},
        "masked_attention_bwd_dkv": {"S": long_row["S"], "B": long_row["B"], **long16, "ms_key": "pair"},
    }
    for k in kernels:
        if k["name"] in at_route:
            k["bfloat16_at_its_route"] = at_route[k["name"]]
    # every kernel launched on a path of this run (the checks that call a
    # kernel directly aside)
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels launched on no path of this run: {idle}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
