"""Tracing and profiling utilities: the port's counterpart of the JAX
package's ``utils/profiling.py``.

- ``trace`` / ``start_trace`` / ``stop_trace``: a ``torch.profiler`` trace
  of the host and, when there is a card, its kernels, written into a
  directory as a Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``), which
  Perfetto, ``chrome://tracing`` and TensorBoard's profile plugin open;
- ``named_scope``: a named range, both a ``torch.profiler`` record and an
  NVTX range on the card;
- ``StepTimer``: wall-clock step times and items/s, warm-up discarded;
- ``memory_stats``: the caching allocator's counters of the card.

JAX's ``start_server`` (a live XProf server that captures on demand) has
no PyTorch counterpart.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


def start_trace(log_dir: str) -> profile:
    """Start a trace of the host and the card (when there is one); it is
    written into ``log_dir`` by ``stop_trace``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    session = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    session.start()
    return session


def stop_trace(session: profile) -> None:
    """Finish the work the trace covers, stop it and write it."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    session.stop()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Trace the enclosed block into ``log_dir``:

        with profiling.trace(log_dir):
            trainer.train_step(state, group)
    """
    session = start_trace(log_dir)
    try:
        yield session
    finally:
        stop_trace(session)


@contextlib.contextmanager
def named_scope(name: str) -> Iterator[None]:
    """Name a region in the trace (and, on the card, for NVTX tools)."""
    nvtx = torch.cuda.is_available()
    with record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock step timer with warm-up discard. The step must end with
    its device work (synchronize inside the block) for the time to count
    it:

        timer = StepTimer(warmup=3)
        for group in groups:
            with timer.step(items=int((group["idx"] >= 0).sum())):
                trainer.train_step(state, group)
                torch.cuda.synchronize()
        print(timer.summary())
    """

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: List[float] = []  # seconds of each step after the warm-up
        self._items = []
        self._n = 0

    @contextlib.contextmanager
    def step(self, items: int = 1) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)
            self._items.append(items)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        total_t = sum(self.times)
        return {
            "steps": len(self.times),
            "mean_step_s": total_t / len(self.times),
            "items_per_sec": sum(self._items) / total_t if total_t else 0.0,
        }


def memory_stats(device=None) -> Optional[Dict[str, int]]:
    """``torch.cuda.memory_stats`` of ``device`` (default: the current
    card); None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats(device)
