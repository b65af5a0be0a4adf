"""Class-weighted node cross-entropy: the port's copy of the JAX package's
``losses/node_cross_entropy.py``.

Labelled nodes were gathered by the collator into a fixed ``(L,)`` buffer
with ``y_node -> C`` for padded slots and ``y_slot_mask`` marking real ones;
the gather masks the pad index (``gather_fill``: plain indexing would assert
on CUDA), and masked slots add exactly zero to the loss and every count.
The loss is summed; ``sample_size`` (the number of labelled nodes) is the
trainer's gradient denominator.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from multimodaldiscussiontransformer_tpu_torch.core.registry import register_criterion
from multimodaldiscussiontransformer_tpu_torch.models.fusion import gather_fill


def node_cross_entropy_loss(
    logits_all: torch.Tensor,  # (C, K) per-node logits
    y: torch.Tensor,  # (L,) int labels
    y_node: torch.Tensor,  # (L,) node slots in C; pad -> C
    y_slot_mask: torch.Tensor,  # (L,) bool
    positive_weight: float = 1.0,
    negative_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(summed loss, sample_size, summable logging output)."""
    logits = gather_fill(logits_all, y_node).float()
    y = y.long()
    mask = y_slot_mask.float()
    nll = -F.log_softmax(logits, dim=-1).gather(-1, y[:, None])[:, 0]
    class_weights = torch.tensor([negative_weight, positive_weight], dtype=torch.float32, device=logits.device)
    loss = (nll * class_weights[y.clamp(0, 1)] * mask).sum()

    pred = logits.argmax(dim=-1)
    correct = (pred == y) & y_slot_mask
    sample_size = y_slot_mask.sum()
    logging_output = {
        "loss": loss.detach(),
        "sample_size": sample_size,
        "nsentences": sample_size,
        "ncorrect": correct.sum(),
        "num_positive_correct": (correct & (pred == 1)).sum(),
        "total_positive": ((y == 1) & y_slot_mask).sum(),
        "num_pred_positive": ((pred == 1) & y_slot_mask).sum(),
    }
    return loss, sample_size, logging_output


def reduce_node_metrics(agg: Dict[str, Any]) -> Dict[str, float]:
    """Accuracy, precision, recall and F1 from summed confusion counts, with
    the reference's divide-by-zero guards."""
    sample_size = float(agg["sample_size"])
    out = {"loss": float(agg["loss"]) / max(sample_size, 1.0)}
    tp = float(agg["num_positive_correct"])
    total_pos = float(agg["total_positive"])
    pred_pos = float(agg["num_pred_positive"])
    recall = 0.0 if total_pos == 0 else tp / total_pos
    precision = 0.0 if pred_pos == 0 else tp / pred_pos
    f1 = 0.0 if (precision == 0 and recall == 0) else 2 * precision * recall / (precision + recall)
    out["accuracy"] = float(agg["ncorrect"]) / max(sample_size, 1.0)
    out["recall"] = recall
    out["precision"] = precision
    out["f1"] = f1
    return out


@register_criterion("node_cross_entropy")
class NodeCrossEntropyCriterion:
    """The criterion under the reference's name."""

    def __init__(self, positive_weight: float = 1.0, negative_weight: float = 1.0):
        self.positive_weight = positive_weight
        self.negative_weight = negative_weight

    def __call__(self, output, batch):
        return node_cross_entropy_loss(
            output.logits, batch["y"], batch["y_node"], batch["y_slot_mask"],
            self.positive_weight, self.negative_weight,
        )

    reduce_metrics = staticmethod(reduce_node_metrics)
