"""Contrastive loss over the global discussion embeddings: the port's copy of
the JAX package's ``losses/contrastive_loss.py`` (the reference's
``GraphContrastiveLoss``).

BCE with logits on a scaled cosine-similarity matrix of the per-discussion
graph-token states:
- same-community pairs are positives;
- pairs whose ``hard_y[i] == y[j]`` (polar-opposite communities) are hard
  negatives;
- the remaining pairs are soft negatives, weighted per row by
  ``num_hard / max(soft, 1) * 2`` (adaptive) or by a fixed weight;
- the diagonal weighs 0, and ``valid`` masks pad graphs out of every pair
  term and every summed metric.
The loss is summed; ``sample_size`` is the number of valid pairs.

Across data-parallel ranks the matrix is the GLOBAL batch's, as in the JAX
package (where B is global under dp): each rank computes its own rows
against every rank's embeddings (``columns``, gathered with a
differentiable all-reduce), so that the rank's loss, sample size and counts
sum over the ranks to the global ones.

Under sequence parallelism every rank of an sp group holds the same
broadcast embeddings (``models/mdt.py``) and computes the same rows: the
trainer marks the ranks other than sp rank 0 as ``replica``, whose loss,
sample size and counts are multiplied by 0 (the loss stays in the graph, so
that every rank runs the same backward collectives), and the rows are
gathered over the data axes only (``data_group`` is the mesh's
``batch_group``). A pad graph is read off ``graph_mask`` where the batch
carries one (an sp share, whose ``grid_mask`` is a strip).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from multimodaldiscussiontransformer_tpu_torch.core.registry import register_criterion
from multimodaldiscussiontransformer_tpu_torch.parallel.comm import all_gather_dim, gather_dim


def contrastive_loss(
    embeddings: torch.Tensor,  # (B, D) global discussion embeddings
    y: torch.Tensor,  # (B,) community labels
    hard_y: torch.Tensor,  # (B,) polar-opposite community labels
    soft_negative_weight: float = 0.0,
    adaptive_soft_negative_weight: bool = True,
    multiplication_scale: float = 20.0,
    valid: Optional[torch.Tensor] = None,  # (B,) bool, False for pad graphs
    columns: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    row_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(summed loss, sample_size, summable logging output) of the rows
    ``embeddings`` (with ``y``, ``hard_y``, ``valid``) against the columns
    ``columns`` = (embeddings, y, valid) of the whole batch, the rows
    being columns ``row_offset ..``; without ``columns`` the rows are the
    whole batch."""
    emb = embeddings.float()
    normed = emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True).clamp_min(1e-12)

    y = y.float()
    hard_y = hard_y.float()
    b = emb.shape[0]
    if valid is None:
        valid = torch.ones(b, dtype=torch.bool, device=emb.device)
    if columns is None:
        normed_cols, y_cols, valid_cols = normed, y, valid
    else:
        cols = columns[0].float()
        normed_cols = cols / torch.linalg.vector_norm(cols, dim=1, keepdim=True).clamp_min(1e-12)
        y_cols, valid_cols = columns[1].float(), columns[2].bool()
    sim = normed @ normed_cols.T * multiplication_scale  # (B, B), or this rank's rows
    pair_valid = valid[:, None] & valid_cols[None, :]
    target = ((y[:, None] == y_cols[None, :]) & pair_valid).float()
    hard_target = ((hard_y[:, None] == y_cols[None, :]) & pair_valid).float()

    soft_labels = (target == 0) & (hard_target == 0) & pair_valid
    if adaptive_soft_negative_weight:
        num_hard = ((target == 1) | (hard_target == 1)).float().sum(dim=1)
        soft_count = soft_labels.float().sum(dim=1).clamp_min(1.0)
        extra_weight = (num_hard / soft_count * 2.0)[:, None]
    else:
        extra_weight = torch.tensor(soft_negative_weight, dtype=torch.float32, device=sim.device)

    one = torch.ones((), dtype=torch.float32, device=sim.device)
    zero = torch.zeros((), dtype=torch.float32, device=sim.device)
    weight = torch.where(soft_labels, extra_weight, one)
    weight = torch.where(pair_valid, weight, zero)
    diagonal = torch.arange(b, device=sim.device)[:, None] + row_offset == torch.arange(sim.shape[1], device=sim.device)[None, :]
    weight = torch.where(diagonal, zero, weight)

    per_pair = sim.clamp_min(0.0) - sim * target + torch.log1p(torch.exp(-sim.abs()))
    loss = (per_pair * weight).sum()

    sim_count = valid.long().sum() * valid_cols.long().sum()

    # the reference compares the (B, B) prediction matrix with the (B,) label
    # vector by broadcasting; kept verbatim, restricted to valid pairs
    pred = torch.round(torch.sigmoid(sim.detach()))
    hit = (pred == y_cols[None, :]) & pair_valid
    logging_output = {
        "loss": loss.detach(),
        "sample_size": sim_count,
        "nsentences": sim_count,
        "ncorrect": hit.sum(),
        "positive_correct": (hit & (pred == 1)).sum(),
        "total_positive": ((y == 1) & valid).sum(),
        "pred_positive": ((pred == 1) & pair_valid).sum(),
    }
    return loss, sim_count, logging_output


def reduce_contrastive_metrics(agg: Dict[str, Any]) -> Dict[str, float]:
    """Percent-scaled accuracy, precision and recall from summed counts."""
    sample_size = max(float(agg["sample_size"]), 1.0)
    out = {"loss": float(agg["loss"]) / sample_size}
    out["accuracy"] = 100.0 * float(agg["ncorrect"]) / sample_size
    pred_pos = float(agg["pred_positive"])
    total_pos = float(agg["total_positive"])
    tp = float(agg["positive_correct"])
    out["precision"] = 100.0 * tp / pred_pos if pred_pos else 0.0
    out["recall"] = 100.0 * tp / total_pos if total_pos else 0.0
    return out


@register_criterion("contrastive_loss")
class ContrastiveCriterion:
    """The criterion under the reference's name."""

    def __init__(
        self,
        soft_negative_weight: float = 0.0,
        adaptive_soft_negative_weight: bool = True,
        multiplication_scale: float = 20.0,
    ):
        if adaptive_soft_negative_weight and soft_negative_weight != 0:
            raise ValueError("adaptive_soft_negative_weight and soft_negative_weight are mutually exclusive")
        self.soft_negative_weight = soft_negative_weight
        self.adaptive_soft_negative_weight = adaptive_soft_negative_weight
        self.multiplication_scale = multiplication_scale
        # across data-parallel ranks (set by the trainer): the group whose
        # batches make up the global matrix
        self.data_group = None
        # an sp rank other than 0 (set by the trainer): its rows repeat rank 0's
        self.replica = False

    def __call__(self, output, batch):
        # pad graphs (the collator's pad_to_graphs) have no real node rows
        emb, y = output.global_embedding, batch["y"]
        if "graph_mask" in batch:
            valid = batch["graph_mask"].bool()
        elif "grid_mask" in batch:
            valid = batch["grid_mask"].any(-1)
        else:
            valid = torch.ones(emb.shape[0], dtype=torch.bool, device=emb.device)
        columns, offset = None, 0
        if self.data_group is not None:
            import torch.distributed as dist

            columns = (all_gather_dim(emb.float(), 0, self.data_group), gather_dim(y.float(), 0, self.data_group),
                       gather_dim(valid.float(), 0, self.data_group))
            offset = dist.get_rank(self.data_group) * emb.shape[0]
        loss, ssz, logs = contrastive_loss(
            emb, y, batch["hard_y"],
            self.soft_negative_weight, self.adaptive_soft_negative_weight, self.multiplication_scale,
            valid=valid, columns=columns, row_offset=offset,
        )
        if self.replica:
            loss, ssz, logs = loss * 0.0, ssz * 0, {k: v * 0 for k, v in logs.items()}
        return loss, ssz, logs

    reduce_metrics = staticmethod(reduce_contrastive_metrics)
