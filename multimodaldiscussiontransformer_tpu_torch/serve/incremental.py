"""Incremental inference: re-score every comment as a discussion grows.

Every forward yields a logit for every node, so re-scoring after new replies
is a full forward over the extended tree. Trees are padded into the same
node-count buckets as training and request batches into a batch-size ladder
(with inert zero-node pad graphs), so a serving process sees few distinct
shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig, ModelConfig, TaskConfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import Batch, collate, to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.preprocess import GraphItem, preprocess_item
from multimodaldiscussiontransformer_tpu_torch.data.trees import tree_distance_pairs


@dataclass
class Discussion:
    """Mutable host-side discussion tree being scored incrementally."""

    parents: List[int] = field(default_factory=list)  # -1 for root
    input_ids: List[np.ndarray] = field(default_factory=list)
    token_type_ids: List[np.ndarray] = field(default_factory=list)
    attention_mask: List[np.ndarray] = field(default_factory=list)
    images: Dict[int, np.ndarray] = field(default_factory=dict)  # node -> (3,H,W)

    def add_node(
        self,
        parent: int,
        input_ids: np.ndarray,
        attention_mask: Optional[np.ndarray] = None,
        token_type_ids: Optional[np.ndarray] = None,
        image: Optional[np.ndarray] = None,
    ) -> int:
        """Append a comment under ``parent`` (-1 for the root post).
        Returns the new node id."""
        nid = len(self.parents)
        if parent >= nid:
            raise ValueError(f"parent {parent} does not exist")
        self.parents.append(int(parent))
        ids = np.asarray(input_ids, np.int32)
        self.input_ids.append(ids)
        self.attention_mask.append(
            np.asarray(attention_mask if attention_mask is not None else (ids != 0), np.int32)
        )
        self.token_type_ids.append(
            np.asarray(token_type_ids if token_type_ids is not None else np.zeros_like(ids), np.int32)
        )
        if image is not None:
            self.images[nid] = np.asarray(image, np.float32)
        return nid

    @property
    def num_nodes(self) -> int:
        return len(self.parents)

    def to_item(self, idx: int = 0) -> GraphItem:
        n = self.num_nodes
        parents = np.asarray(self.parents, np.int64)
        edges = [(p, i) for i, p in enumerate(parents) if p >= 0]
        edge_index = (
            np.asarray(edges + [(b, a) for a, b in edges], np.int64).T
            if edges
            else np.zeros((2, 0), np.int64)
        )
        has_image = np.asarray([i in self.images for i in range(n)], bool)
        imgs = (
            np.stack([self.images[i] for i in range(n) if i in self.images])
            if self.images
            else np.zeros((0, 3, 224, 224), np.float32)
        )
        return preprocess_item(
            idx=idx,
            tokens={
                "input_ids": np.stack(self.input_ids),
                "token_type_ids": np.stack(self.token_type_ids),
                "attention_mask": np.stack(self.attention_mask),
            },
            edge_index=edge_index,
            distance_pairs=tree_distance_pairs(parents),
            x_images=imgs,
            x_image_index=has_image,
            y=np.zeros(0, np.int64),
            y_mask=np.zeros(n, bool),
        )


def _batch_bucket(n: int, buckets) -> int:
    """Round a request-batch size up to its ladder entry: ``"pow2"`` -> next
    power of two; a tuple -> smallest entry >= n; ``None`` -> n."""
    if buckets is None:
        return n
    if buckets == "pow2":
        b = 1
        while b < n:
            b *= 2
        return b
    for b in sorted(buckets):
        if b >= n:
            return int(b)
    raise ValueError(f"request batch {n} exceeds the largest batch bucket {max(buckets)}")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and asking
    for the card where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


class DiscussionScorer:
    """Scores (and re-scores) discussions with an mDT model on one device,
    or across the ranks of a ``mesh``.

    Request batches are padded up the ``batch_buckets`` ladder (``"pow2"``,
    an ascending tuple, or ``None``) with the collator's inert zero-node pad
    graphs; real items' probabilities do not change.

    ``mesh`` (``parallel/mesh.py::make_mesh``, JAX's ``mesh`` argument):
    every rank calls ``score_items`` with the same items. With an sp axis
    and a model built with ``sequence_parallel`` the node axis of each
    request and its O(S^2) bias are cut over the sp group (the graph
    attention a ring, ``ops/ring_attention.py``), so a discussion past one
    card's memory scores through the same call; with a tp axis each rank
    runs its heads. Every rank returns the whole probabilities."""

    def __init__(
        self,
        model: torch.nn.Module,
        device=None,
        data_cfg: Optional[DataConfig] = None,
        task_cfg: Optional[TaskConfig] = None,
        image_shape=(3, 224, 224),
        batch_buckets="pow2",
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            from multimodaldiscussiontransformer_tpu_torch.parallel.mesh import (
                apply_sequence_parallel,
                apply_tensor_parallel,
            )

            apply_tensor_parallel(self.model, mesh)
            apply_sequence_parallel(self.model, mesh)
        self.data_cfg = data_cfg or DataConfig(batch_size=1)
        self.task_cfg = task_cfg or TaskConfig()
        self.image_shape = image_shape
        self.batch_buckets = batch_buckets

    @classmethod
    def from_checkpoint(
        cls,
        save_dir: str,
        model_cfg: Optional[ModelConfig] = None,
        step: Optional[int] = None,
        best: bool = True,
        device=None,
        **kw,
    ) -> "DiscussionScorer":
        """A scorer for the params of a training checkpoint directory
        (``utils/checkpoints.py``): the best step by default (the latest
        without one, or with ``best=False``); an explicit ``step`` of the
        rolling store wins. ``save_dir`` may also name a JAX step converted
        by ``tools/orbax_to_npz.py`` (an ``.npz``). Params in the scan
        layout are unstacked. The
        model is rebuilt from ``model_cfg`` (``ModelConfig()`` by default)
        on ``device`` (the card unless ``"cpu"`` is asked for); ``kw`` as the
        constructor's (``mesh`` included)."""
        from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
        from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import Checkpointer, is_flax_npz, load_flax_npz
        from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import unrolled_state_dict

        device = resolve_device(device)
        if is_flax_npz(save_dir):
            restored = load_flax_npz(save_dir)
        else:
            restored = Checkpointer(save_dir).restore(step=step, best=best and step is None)
        if restored is None:
            raise FileNotFoundError(f"no checkpoints under {save_dir}")
        model_cfg = model_cfg or ModelConfig()
        params = unrolled_state_dict(restored["params"], model_cfg)  # a scan-layout checkpoint is unstacked
        with torch.device("meta"):  # no random init: every tensor comes from the checkpoint
            model = MDTModel(model_cfg)
        want, got = set(model.state_dict()), set(params)
        if want != got:
            raise ValueError(f"the checkpoint under {save_dir} does not fit the model: missing "
                             f"{sorted(want - got)[:5]}, unexpected {sorted(got - want)[:5]}")
        model.load_state_dict(params, strict=True, assign=True)
        return cls(model, device=device, **kw)

    def collate(self, items: Sequence[GraphItem]) -> Batch:
        """The host batch for ``items``, padded up the batch-size ladder."""
        return collate(
            list(items),
            pad_to_graphs=_batch_bucket(len(items), self.batch_buckets),
            spatial_pos_max=self.task_cfg.spatial_pos_max,
            node_buckets=self.data_cfg.node_buckets,
            node_capacity_buckets=self.data_cfg.node_capacity_buckets,
            image_capacity_buckets=self.data_cfg.image_capacity_buckets,
            label_capacity_buckets=self.data_cfg.label_capacity_buckets,
            image_shape=self.image_shape,
            shard_multiple=self._sp_size(),
        )

    def _sp_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.sp_size

    def score_items(self, items: Sequence[GraphItem]) -> List[np.ndarray]:
        """Per-node class probabilities for each discussion item."""
        items = list(items)
        host = self.collate(items).asdict()
        sp = self._sp_size()
        if sp > 1:  # this rank's share; its logits are its block of the node slots
            from multimodaldiscussiontransformer_tpu_torch.parallel.input import sp_share

            host = sp_share(host, self.mesh.sp_rank, sp)
        with torch.no_grad():
            logits = self.model(to_tensors(host, self.device)).logits
            if sp > 1:
                from multimodaldiscussiontransformer_tpu_torch.parallel.comm import gather_dim

                logits = gather_dim(logits.float().contiguous(), 0, self.mesh.sp_group)
        logits = logits.float().cpu().numpy()
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        out = []
        off = 0
        for it in items:  # pad graphs hold no flat node rows
            out.append(probs[off : off + it.num_nodes])
            off += it.num_nodes
        return out

    def score(self, discussion: Discussion) -> np.ndarray:
        """(N, num_classes) probabilities for every comment in the tree."""
        return self.score_items([discussion.to_item()])[0]
