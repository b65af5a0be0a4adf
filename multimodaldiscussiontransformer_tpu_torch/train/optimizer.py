"""The canonical run's optimizer: the port's copy of the JAX package's
``train/optimizer.py``.

- ``polynomial_decay_schedule``: FairSeq ``polynomial_decay`` (linear warmup
  to ``lr``, then polynomial decay to ``end_learning_rate`` at
  ``total_num_update``), indexed by the 0-based count of updates already
  applied and evaluated at that count + 1, as the JAX schedule is;
- AdamW with decoupled weight decay on EVERY trainable parameter (optax's
  ``adamw`` has no decay mask, so biases and layer norms decay too).
  ``torch.optim.AdamW`` computes optax's update,
  ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with the old ``p``;
  the trainer sets the lr of each update from the schedule before
  ``step()`` (a torch LR scheduler counts steps differently);
- ``--freeze-initial-encoders`` freezes the bottom towers
  (``FROZEN_PREFIXES``): their parameters get ``requires_grad_(False)``, so
  autograd neither computes their gradients nor runs below the lowest
  trainable layer, and they stay out of the optimizer.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

from multimodaldiscussiontransformer_tpu_torch.core.config import OptimConfig

# parameter-name prefixes frozen by --freeze-initial-encoders
FROZEN_PREFIXES = ("graph_encoder.text_model", "graph_encoder.vit_model")


def polynomial_decay_schedule(
    lr: float, end_lr: float, warmup_updates: int, total_num_update: int, power: float = 1.0
) -> Callable[[int], float]:
    """FairSeq ``polynomial_decay``: the lr of the update that follows
    ``step`` applied updates."""

    def schedule(step: int) -> float:
        step = float(step) + 1.0
        warmup = float(max(warmup_updates, 1))
        total = float(max(total_num_update, 1))
        if step < warmup_updates:
            return lr * step / warmup
        frac = min(max((total - step) / max(total - warmup, 1.0), 0.0), 1.0)
        return end_lr + (lr - end_lr) * frac**power

    return schedule


def trainable_mask(model: nn.Module, freeze_initial_encoders: bool) -> Dict[str, str]:
    """'train' or 'freeze' for each parameter name."""
    return {
        name: "freeze" if freeze_initial_encoders and any(fp in name for fp in FROZEN_PREFIXES) else "train"
        for name, _ in model.named_parameters()
    }


def apply_freeze(model: nn.Module, freeze_initial_encoders: bool) -> List[nn.Parameter]:
    """Set ``requires_grad`` from ``trainable_mask``; the trainable
    parameters, in ``named_parameters`` order."""
    labels = trainable_mask(model, freeze_initial_encoders)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
        if p.requires_grad:
            trainable.append(p)
    return trainable


def trainable_gnorm(params: List[nn.Parameter]) -> torch.Tensor:
    """Global L2 norm of the trainable parameters' gradients (f32)."""
    sq = [p.grad.float().square().sum() for p in params if p.grad is not None]
    return torch.stack(sq).sum().sqrt() if sq else torch.zeros(())


def clip_by_global_norm_(params: List[nn.Parameter], max_norm: float) -> None:
    """optax ``clip_by_global_norm``: scale every gradient by
    max_norm / norm where the global norm reaches max_norm."""
    norm = trainable_gnorm(params)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(scale.to(p.grad.dtype))


def make_optimizer(cfg: OptimConfig, params: List[nn.Parameter]) -> torch.optim.AdamW:
    """AdamW over ``params`` with the config's betas, eps and decay; the lr
    is set per update by the trainer."""
    if cfg.bf16_adam_state:
        raise NotImplementedError("bf16_adam_state: the port keeps float32 Adam moments for now")
    return torch.optim.AdamW(
        params, lr=cfg.lr, betas=tuple(cfg.adam_betas), eps=cfg.adam_eps, weight_decay=cfg.weight_decay
    )
