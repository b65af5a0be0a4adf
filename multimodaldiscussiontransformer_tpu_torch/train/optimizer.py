"""The canonical run's optimizer: the port's copy of the JAX package's
``train/optimizer.py``.

- ``polynomial_decay_schedule``: FairSeq ``polynomial_decay`` (linear warmup
  to ``lr``, then polynomial decay to ``end_learning_rate`` at
  ``total_num_update``), indexed by the 0-based count of updates already
  applied and evaluated at that count + 1, as the JAX schedule is;
- AdamW with decoupled weight decay on EVERY trainable parameter (optax's
  ``adamw`` has no decay mask, so biases and layer norms decay too).
  ``torch.optim.AdamW`` computes optax's update,
  ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with the old ``p``,
  for float32 params and moments; ``OptaxAdamW`` computes it in optax's
  order for the two other settings: bf16 moments over float32 math
  (``bf16_adam_state``, JAX ``scale_by_adam_bf16_state``) and bf16 params
  (``param_dtype="bfloat16"``: moments and arithmetic in bf16, as optax
  keeps them). The trainer sets the lr of each update from the schedule
  before ``step()`` (a torch LR scheduler counts steps differently);
- ``--freeze-initial-encoders`` freezes the bottom towers
  (``FROZEN_PREFIXES``): their parameters get ``requires_grad_(False)``, so
  autograd neither computes their gradients nor runs below the lowest
  trainable layer, and they stay out of the optimizer.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
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


def clip_by_global_norm_(params: List[nn.Parameter], max_norm: float, norm: Optional[torch.Tensor] = None) -> None:
    """optax ``clip_by_global_norm``: scale every gradient by
    max_norm / norm where the global norm (``norm``, else the norm of these
    gradients) reaches max_norm."""
    norm = trainable_gnorm(params) if norm is None else norm
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(scale.to(p.grad.dtype))


class OptaxAdamW(torch.optim.Optimizer):
    """optax's AdamW step, op for op:

        m = (1 - b1) g + b1 m;  v = (1 - b2) g^2 + b2 v
        u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
        p = p + (-lr) (u + wd p)

    With ``state_dtype`` (bf16) the moments are stored in it and the
    arithmetic runs in float32 (JAX ``scale_by_adam_bf16_state``: upcast,
    f32 recurrences, one downcast of the new moments); without it, moments
    and arithmetic take the params' dtype (optax's ``adamw`` on bf16
    leaves). Each constant is rounded to the arithmetic's dtype first, as a
    Python float meets a bf16 array in JAX; the bias corrections are
    computed in float32 and then rounded. The state (``step``,
    ``exp_avg``, ``exp_avg_sq``) keeps ``torch.optim.AdamW``'s names."""

    def __init__(self, params, lr: float, betas, eps: float, weight_decay: float,
                 state_dtype: Optional[torch.dtype] = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        self.state_dtype = state_dtype

    def load_state_dict(self, state_dict) -> None:
        # torch casts loaded moments to the params' dtype; give them back
        # their own (bf16 -> f32 -> bf16 is exact)
        super().load_state_dict(state_dict)
        for p, st in self.state.items():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st:
                    st[key] = st[key].to(self.state_dtype or p.dtype)

    @torch.no_grad()
    def step(self, closure=None) -> None:
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            mt = torch.float32 if self.state_dtype is not None else params[0].dtype

            def c(x: float) -> float:  # a constant as a Python float meets an mt array
                return float(torch.tensor(x, dtype=torch.float32).to(mt))

            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.state_dtype or p.dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.state_dtype or p.dtype)
                st["step"] += 1
            t = np.float32(states[0]["step"])
            bc1 = c(float(np.float32(1) - np.float32(b1) ** t))
            bc2 = c(float(np.float32(1) - np.float32(b2) ** t))

            # every tensor of the group as one flat vector: a few kernels
            # over all elements instead of several per tensor
            def flat(tensors):
                return torch.cat([x.reshape(-1) for x in tensors]).to(mt)

            def unflat(vector, like):
                return [x.view(y.shape) for x, y in zip(vector.split([y.numel() for y in like]), like)]

            g = flat([p.grad for p in params])
            m = flat([st["exp_avg"] for st in states]).mul_(c(b1)).add_(g * c(1 - b1))
            v = flat([st["exp_avg_sq"] for st in states]).mul_(c(b2)).add_((g * g).mul_(c(1 - b2)))
            del g
            u = (m / bc1).div_((v / bc2).sqrt_().add_(c(group["eps"])))
            u.add_(flat(params).mul_(c(group["weight_decay"]))).mul_(c(-group["lr"]))
            torch._foreach_add_(params, unflat(u.to(params[0].dtype), params))
            torch._foreach_copy_([st["exp_avg"] for st in states], unflat(m, params))
            torch._foreach_copy_([st["exp_avg_sq"] for st in states], unflat(v, params))


def make_optimizer(cfg: OptimConfig, params: List[nn.Parameter]) -> torch.optim.Optimizer:
    """AdamW over ``params`` with the config's betas, eps and decay; the lr
    is set per update by the trainer. float32 params with float32 moments
    take ``torch.optim.AdamW``; ``bf16_adam_state`` (bf16 moments, float32
    math) and bf16 params take ``OptaxAdamW``."""
    kw = dict(lr=cfg.lr, betas=tuple(cfg.adam_betas), eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
    if cfg.bf16_adam_state:
        return OptaxAdamW(params, state_dtype=torch.bfloat16, **kw)
    if any(p.dtype != torch.float32 for p in params):
        return OptaxAdamW(params, **kw)
    return torch.optim.AdamW(params, **kw)
