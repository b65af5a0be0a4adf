"""Static-shape bucketed collator (numpy), the port's copy of the JAX
package's ``data/collator.py``: ``collate`` for node-task and (with
``contrastive``) contrastive items, and the ``pad_batch_to_shapes`` /
``all_pad_like`` pair that the scan-accumulated train step uses to give a
group of microbatches one shape. Shard multiples of the capacities come
with the parallel slice.

Every per-graph tensor is padded to a node-count bucket ``Nmax``; all real
nodes of the batch are gathered into a flat text-tower buffer of capacity
``C``; image-bearing nodes into a ViT buffer of capacity ``I`` with an
``image_node -> C`` index; labelled nodes into a loss buffer of capacity
``L`` (node task), or one community ``y`` and one polar-opposite community
``hard_y`` per graph (contrastive task, with empty ``y_node`` and
``y_slot_mask``). Padded index slots point one past the end of their target (``C``, or
graph id ``B``) and the model drops or zero-fills them.

Attention-bias padding follows the reference collator: spatial_pos and
degrees are +1-shifted so 0 means padding; the base bias is 0 inside the
real block except ``-inf`` where ``distance >= spatial_pos_max``;
real-row -> pad-col is ``-inf``; pad-row -> real-col is 0.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodaldiscussiontransformer_tpu_torch.data.preprocess import GraphItem

NEG_INF = float("-inf")


def _bucket(value: int, ladder: Sequence[int], multiple: int = 1) -> int:
    """Smallest ladder entry >= value that is a multiple of ``multiple``;
    beyond the ladder, value rounded up to ``multiple``."""
    m = max(multiple, 1)
    for b in ladder:
        if b >= value and b % m == 0:
            return b
    return -(-value // m) * m


@dataclass
class Batch:
    """One batch of numpy arrays with static shapes.

    Shape legend: B graphs, Nmax nodes/graph, C flat node capacity, T text
    tokens, I image capacity, L label capacity."""

    input_ids: np.ndarray  # (C, T) int32
    token_type_ids: np.ndarray  # (C, T) int32
    attention_mask: np.ndarray  # (C, T) int32
    node_mask: np.ndarray  # (C,) bool, real node slots
    node_graph: np.ndarray  # (C,) int32 graph id; padded slots -> B
    node_pos: np.ndarray  # (C,) int32 node index within graph

    images: np.ndarray  # (I, 3, H, W) float32
    image_mask: np.ndarray  # (I,) bool
    image_node: np.ndarray  # (I,) int32 node slot in C; padded -> C

    spatial_pos: np.ndarray  # (B, Nmax, Nmax) int32, +1-shifted, 0 = pad
    attn_bias: np.ndarray  # (B, Nmax+1, Nmax+1) float32 base bias
    in_degree: np.ndarray  # (B, Nmax) int32, +1-shifted, 0 = pad
    out_degree: np.ndarray  # (B, Nmax) int32 (== in_degree, undirected)
    grid_mask: np.ndarray  # (B, Nmax) bool, real grid slots

    y: np.ndarray  # node task: (L,) int32; contrastive: (B,) float32
    y_node: np.ndarray  # (L,) int32 node slot in C; padded -> C (contrastive: empty)
    y_slot_mask: np.ndarray  # (L,) bool (contrastive: empty)
    hard_y: np.ndarray  # (B,) float32 (contrastive) or zeros

    idx: np.ndarray  # (B,) int32
    nsamples: np.ndarray  # () int32, number of real graphs

    def asdict(self) -> Dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @property
    def num_graphs(self) -> int:
        return int(self.idx.shape[0])

    @property
    def max_nodes(self) -> int:
        return int(self.in_degree.shape[1])

    @property
    def node_capacity(self) -> int:
        return int(self.input_ids.shape[0])


def to_tensors(batch: Union[Batch, Mapping[str, np.ndarray]], device) -> Dict[str, torch.Tensor]:
    """The batch (a ``Batch`` or its dict of arrays or tensors) as tensors
    on ``device``: integers as int64 (index dtype), floats and masks as
    they are (a tensor already there is not copied)."""
    out = {}
    arrays = batch.asdict() if isinstance(batch, Batch) else batch
    for k, v in arrays.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype in (torch.int32, torch.int64):
            t = t.long()
        out[k] = t.to(device)
    return out


def collate(
    items: List[GraphItem],
    spatial_pos_max: int = 5,
    node_buckets: Sequence[int] = (8, 16, 32, 64, 128, 256),
    node_capacity_buckets: Sequence[int] = (32, 64, 128, 256, 512, 1024),
    image_capacity_buckets: Sequence[int] = (0, 8, 16, 32, 64),
    label_capacity_buckets: Sequence[int] = (8, 16, 32, 64, 128),
    image_shape: Tuple[int, int, int] = (3, 224, 224),
    pad_to_graphs: Optional[int] = None,
    text_len_buckets: Optional[Sequence[int]] = None,
    text_len: Optional[int] = None,
    contrastive: bool = False,
    shard_multiple: int = 1,
) -> Batch:
    """Collate preprocessed GraphItems into one static-shape Batch: node-task
    items, or with ``contrastive`` items carrying a community ``y`` and
    (optionally) ``hard_y``.

    ``pad_to_graphs``: pad the graph axis up to this count with inert
    zero-node graphs (``grid_mask`` all False, ``idx`` -1). A pad graph
    takes no flat text/image/label capacity and ``nsamples`` counts only
    real graphs.

    ``text_len_buckets``: trim the token axis to the smallest bucket that
    covers the batch's longest attended token (the removed columns are
    masked in every consumer).

    ``shard_multiple``: the node, image and label capacities are multiples
    of it (the data-parallel degree, as the JAX collator rounds them).

    ``items`` may be empty when ``pad_to_graphs`` and ``text_len`` are given:
    the result is an all-pad batch (a rank whose slice of a ragged
    evaluation tail is empty)."""
    b = len(items)
    if not items:
        if pad_to_graphs is None or text_len is None:
            raise ValueError("collate([]) needs pad_to_graphs and text_len to emit an all-pad batch")
        t = text_len
    else:
        t = items[0].input_ids.shape[1]
    if text_len_buckets and items:
        longest = max(
            (int(np.max(np.where(it.attention_mask.any(axis=0))[0], initial=0)) + 1 if it.attention_mask.any() else 1)
            for it in items
        )
        t = min(_bucket(longest, text_len_buckets), t)
        items = [
            dataclasses.replace(
                it,
                input_ids=it.input_ids[:, :t],
                token_type_ids=it.token_type_ids[:, :t],
                attention_mask=it.attention_mask[:, :t],
            )
            for it in items
        ]
    n_per_graph = [it.num_nodes for it in items]
    total_nodes = sum(n_per_graph)
    nmax = _bucket(max(n_per_graph, default=1), node_buckets)
    cap = _bucket(total_nodes, node_capacity_buckets, shard_multiple)
    n_images = sum(int(it.x_image_index.sum()) for it in items)
    icap = _bucket(n_images, image_capacity_buckets, shard_multiple)

    input_ids = np.zeros((cap, t), dtype=np.int32)
    token_type_ids = np.zeros((cap, t), dtype=np.int32)
    attention_mask = np.zeros((cap, t), dtype=np.int32)
    node_mask = np.zeros(cap, dtype=bool)
    node_graph = np.full(cap, b, dtype=np.int32)
    node_pos = np.zeros(cap, dtype=np.int32)

    images = np.zeros((icap,) + image_shape, dtype=np.float32)
    image_mask = np.zeros(icap, dtype=bool)
    image_node = np.full(icap, cap, dtype=np.int32)

    ball = max(b, pad_to_graphs or 0)
    spatial_pos = np.zeros((ball, nmax, nmax), dtype=np.int32)
    attn_bias = np.full((ball, nmax + 1, nmax + 1), NEG_INF, dtype=np.float32)
    in_degree = np.zeros((ball, nmax), dtype=np.int32)
    grid_mask = np.zeros((ball, nmax), dtype=bool)

    y_vals: List[np.ndarray] = []
    y_nodes: List[int] = []
    contr_y = np.zeros(ball, dtype=np.float32)
    hard_y = np.zeros(ball, dtype=np.float32)
    idxs = np.full(ball, -1, dtype=np.int32)

    # pad graphs: the n=0 instance of the real-graph bias template
    attn_bias[b:, 0, 0] = 0.0
    attn_bias[b:, 1:, 0] = 0.0

    node_off = 0
    img_off = 0
    for g, it in enumerate(items):
        n = it.num_nodes
        idxs[g] = it.idx
        sl = slice(node_off, node_off + n)
        input_ids[sl] = it.input_ids
        token_type_ids[sl] = it.token_type_ids
        attention_mask[sl] = it.attention_mask
        node_mask[sl] = True
        node_graph[sl] = g
        node_pos[sl] = np.arange(n, dtype=np.int32)

        # +1 shifts: 0 becomes the padding id
        spatial_pos[g, :n, :n] = it.spatial_pos + 1
        in_degree[g, :n] = it.in_degree + 1
        grid_mask[g, :n] = True

        # base attention bias: zeros within the real (n+1, n+1) block, -inf
        # in the [1:, 1:] sub-block where distance >= spatial_pos_max, pad
        # rows -> real cols = 0
        blk = np.zeros((n + 1, n + 1), dtype=np.float32)
        blk[1:, 1:][it.distance >= spatial_pos_max] = NEG_INF
        attn_bias[g, : n + 1, : n + 1] = blk
        attn_bias[g, n + 1 :, : n + 1] = 0.0

        # images, in node order; items with no image carry x_image_index
        # all False and an empty x_images
        img_nodes = np.flatnonzero(it.x_image_index)
        k = len(img_nodes)
        if k:
            images[img_off : img_off + k] = it.x_images[:k]
            image_mask[img_off : img_off + k] = True
            image_node[img_off : img_off + k] = node_off + img_nodes
            img_off += k

        if contrastive:
            contr_y[g] = float(np.asarray(it.y).reshape(-1)[0])
            if it.hard_y is not None:
                hard_y[g] = float(np.asarray(it.hard_y).reshape(-1)[0])
        else:
            if it.y_mask is None:
                raise ValueError("node task items need y_mask")
            lab_nodes = np.flatnonzero(it.y_mask)
            y_vals.append(np.asarray(it.y).reshape(-1))
            y_nodes.extend((node_off + lab_nodes).tolist())

        node_off += n

    if contrastive:
        y = contr_y
        y_node = np.zeros(0, dtype=np.int32)
        y_slot_mask = np.zeros(0, dtype=bool)
    else:
        flat_y = np.concatenate(y_vals) if y_vals else np.zeros(0, dtype=np.int64)
        n_labels = len(flat_y)
        lcap = _bucket(n_labels, label_capacity_buckets, shard_multiple)
        y = np.zeros(lcap, dtype=np.int32)
        y[:n_labels] = flat_y.astype(np.int32)
        y_node = np.full(lcap, cap, dtype=np.int32)
        y_node[:n_labels] = np.asarray(y_nodes, dtype=np.int32)
        y_slot_mask = np.zeros(lcap, dtype=bool)
        y_slot_mask[:n_labels] = True

    return Batch(
        input_ids=input_ids,
        token_type_ids=token_type_ids,
        attention_mask=attention_mask,
        node_mask=node_mask,
        node_graph=node_graph,
        node_pos=node_pos,
        images=images,
        image_mask=image_mask,
        image_node=image_node,
        spatial_pos=spatial_pos,
        attn_bias=attn_bias,
        in_degree=in_degree,
        out_degree=in_degree.copy(),
        grid_mask=grid_mask,
        y=y,
        y_node=y_node,
        y_slot_mask=y_slot_mask,
        hard_y=hard_y,
        idx=idxs,
        nsamples=np.asarray(b, dtype=np.int32),
    )


def pad_batch_to_shapes(batch: Dict[str, np.ndarray], shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, np.ndarray]:
    """Grow a collated batch's capacity axes (text length, C, I, L, Nmax and
    the bias's S) to ``shapes`` with inert padding: what ``collate`` would
    have produced with the larger buckets. The graph count must match. Pad
    sentinels that encode the old capacity (``image_node``/``y_node`` -> C)
    are re-pointed at the new one."""
    b = batch["idx"].shape[0]
    if shapes["idx"][0] != b:
        raise ValueError(
            f"pad_batch_to_shapes cannot grow the graph axis ({b} -> {shapes['idx'][0]}); "
            "accumulation groups must share a batch size"
        )
    new_cap = shapes["input_ids"][0]
    out: Dict[str, np.ndarray] = {}
    for k, v in batch.items():
        tgt = shapes[k]
        if v.shape == tgt:
            out[k] = v
            continue
        grown = np.zeros(tgt, dtype=v.dtype)
        if k == "attn_bias":
            # rows past the old S follow collate's pad-row recipe: columns
            # [0, n_g] are 0, the rest -inf
            n_g = batch["grid_mask"].sum(axis=1)
            old_s, new_s = v.shape[1], tgt[1]
            cols = np.arange(new_s)
            grown[:] = NEG_INF
            grown[:, old_s:, :] = np.where((cols[None, :] <= n_g[:, None])[:, None, :], 0.0, NEG_INF)
            grown[:, :old_s, :old_s] = v
        elif k == "node_graph":
            grown[:] = b
            grown[: v.shape[0]] = v
        elif k in ("image_node", "y_node"):
            mask = batch["image_mask" if k == "image_node" else "y_slot_mask"]
            grown[:] = new_cap
            grown[: v.shape[0]] = np.where(mask, v, new_cap)
        else:
            # ids, masks, degrees and spatial buckets all pad with 0
            grown[tuple(slice(0, d) for d in v.shape)] = v
        out[k] = grown
    return out


def all_pad_like(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An all-pad microbatch with the shapes and dtypes of ``batch``, made
    by ``collate`` itself on zero items with single-entry ladders read off
    the template (a contrastive template has an empty ``y_node``): it adds
    exactly zero loss, gradient, sample size and metric counts."""
    out = collate(
        [],
        node_buckets=[batch["in_degree"].shape[1]],
        node_capacity_buckets=[batch["input_ids"].shape[0]],
        image_capacity_buckets=[batch["images"].shape[0]],
        label_capacity_buckets=[batch["y"].shape[0]],
        image_shape=tuple(batch["images"].shape[1:]),
        pad_to_graphs=batch["idx"].shape[0],
        text_len=batch["input_ids"].shape[1],
        contrastive=batch["y_node"].shape[0] == 0,
    ).asdict()
    mismatched = {k: (v.shape, batch[k].shape) for k, v in out.items() if v.shape != batch[k].shape}
    if mismatched:
        raise ValueError(f"all_pad_like shape mismatch: {mismatched}")
    return out
