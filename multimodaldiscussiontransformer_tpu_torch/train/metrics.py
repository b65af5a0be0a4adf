"""Metric aggregation with the reference's summable-logging contract, and
the metrics sinks (JSONL, W&B, TensorBoard): the port's copy of the JAX
package's ``train/metrics.py``.

Per-step logging outputs are sums (counts, summed loss); the accumulator
adds them across steps and ``reduce_metrics`` derives accuracy, F1 and the
normalized loss. ``update`` only queues the step's device values (stacked
into one small tensor, no synchronisation); ``reduce`` brings the whole
window to the host with one copy.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

import torch


class MetricAccumulator:
    """Sums logging outputs across steps; reduces on demand."""

    MAX_PENDING = 4096  # past this many steps the window folds early

    def __init__(self, reduce_fn: Callable[[Dict[str, Any]], Dict[str, float]]):
        self._reduce_fn = reduce_fn
        self._pending: List[tuple] = []
        self._sums: Dict[str, float] = {}
        self._n_steps = 0

    def update(self, logging_output: Dict[str, Any]) -> None:
        values = [v if isinstance(v, torch.Tensor) else torch.tensor(float(v)) for v in logging_output.values()]
        dev = values[0].device
        vec = torch.stack([v.detach().to(dev, torch.float64).reshape(()) for v in values])
        self._pending.append((tuple(logging_output), vec))
        self._n_steps += 1
        if len(self._pending) >= self.MAX_PENDING:
            self._fold()

    def _fold(self) -> None:
        if not self._pending:
            return
        host = torch.stack([vec.to(self._pending[0][1].device) for _, vec in self._pending]).cpu().tolist()
        for (keys, _), row in zip(self._pending, host):
            for k, v in zip(keys, row):
                self._sums[k] = self._sums.get(k, 0.0) + v
        self._pending = []

    def sum_over(self, group, device) -> None:
        """Replace the sums by their sums over the ranks of ``group`` (one
        all-reduce of a float64 vector on ``device``; every rank holds the
        same keys)."""
        import torch.distributed as dist

        self._fold()
        keys = sorted(self._sums)
        vec = torch.tensor([self._sums[k] for k in keys], dtype=torch.float64, device=device)
        dist.all_reduce(vec, group=group)
        self._sums = dict(zip(keys, vec.cpu().tolist()))

    def reduce(self) -> Dict[str, float]:
        if not self._pending and not self._sums:
            return {}
        self._fold()
        out = self._reduce_fn(self._sums)
        if "gnorm" in self._sums:  # the window's mean gradient norm, as FairSeq's train log shows it
            out["gnorm"] = self._sums["gnorm"] / self._n_steps
        out["steps_in_window"] = self._n_steps
        return out

    def reset(self) -> None:
        self._pending = []
        self._sums = {}
        self._n_steps = 0


class MetricsWriter:
    """Appends ``{"split", "step", **metrics}`` records to
    ``save_dir/metrics.jsonl``, and logs each metric as ``<split>/<name>``
    to W&B (``wandb_project``, with ``config``) and TensorBoard
    (``tensorboard_logdir``, through ``torch.utils.tensorboard``) when asked
    for. A sink whose package is missing, or that fails to start, is
    dropped with one warning line, as the JAX package drops it; the JSONL
    file is always written."""

    def __init__(self, save_dir: str, wandb_project: Optional[str] = None, config: Optional[dict] = None,
                 tensorboard_logdir: Optional[str] = None):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "metrics.jsonl")
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, config=config or {})
            except Exception as e:  # noqa: BLE001 - any failure drops the sink
                _drop_sink("wandb", e)
        self._tb = None
        if tensorboard_logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tensorboard_logdir)
            except Exception as e:  # noqa: BLE001
                _drop_sink("tensorboard", e)

    def write(self, split: str, step: int, metrics: Dict[str, float]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"split": split, "step": step, **metrics}) + "\n")
        if self._wandb is not None:
            self._wandb.log({f"{split}/{k}": v for k, v in metrics.items()}, step=step)
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(f"{split}/{k}", float(v), step)
                except (TypeError, ValueError):
                    pass  # non-scalar extras stay JSONL-only

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()


def _drop_sink(name: str, error: Exception) -> None:
    print(f"warning: the {name} metrics sink is off ({error!r}); metrics.jsonl only", file=sys.stderr)
