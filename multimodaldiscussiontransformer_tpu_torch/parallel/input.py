"""Per-rank input of a data-parallel run: the port's copy of the JAX
package's ``parallel/input.py`` (numpy only).

The contract, as in JAX:
1. every data-parallel rank collates ONLY its slice of each global batch
   (``host_graph_slice``) with per-rank capacity ladders
   (``host_data_config``: the global capacities divided by the rank count,
   single-entry, so that every rank picks the same static shapes without
   talking to the others);
2. the global batch is the concatenation of the rank-local batches with the
   index vectors offset (``assemble_global_batch``): what a one-process
   run's batch holds, row for row;
3. JAX then builds one global ``jax.Array`` from the per-host pieces
   (``put_host_local``). The port has no global array: each rank stages its
   own slice on its own card (``data/loader.py::stage`` and the prefetch
   thread), and the collectives of the trainer combine what the ranks
   compute. The offset functions serve the tests' global assembly.

Padded-slot conventions (``data/collator.py``): ``node_graph`` pads to
B_local, ``image_node``/``y_node`` pad to cap_local; after offsetting, pads
point at the global out-of-range sentinels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig


def host_graph_slice(host_index: int, host_count: int, global_batch: int) -> slice:
    """The contiguous block of global batch rows one data-parallel rank owns."""
    if global_batch % host_count:
        raise ValueError(f"global batch {global_batch} % hosts {host_count}")
    per = global_batch // host_count
    return slice(host_index * per, (host_index + 1) * per)


def host_data_config(cfg: DataConfig, host_count: int) -> DataConfig:
    """Per-rank DataConfig: capacities divided by ``host_count``, single-entry
    ladders (and no per-batch text trimming, whose length would follow each
    rank's own rows), so that every rank picks the same static shapes."""

    def split(ladder: Sequence[int]) -> tuple:
        cap = max(ladder)
        if cap % host_count:
            raise ValueError(f"capacity {cap} % hosts {host_count}")
        return (cap // host_count,)

    return dataclasses.replace(
        cfg,
        node_buckets=(max(cfg.node_buckets),),
        node_capacity_buckets=split(cfg.node_capacity_buckets),
        image_capacity_buckets=split(cfg.image_capacity_buckets),
        label_capacity_buckets=split(cfg.label_capacity_buckets),
        text_len_buckets=((max(cfg.text_len_buckets),) if cfg.text_len_buckets else cfg.text_len_buckets),
    )


def assemble_global_batch(host_batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Concatenate rank-local collated batches into the global batch,
    re-pointing index vectors and pad sentinels at global coordinates."""
    h0 = host_batches[0]
    n_hosts = len(host_batches)
    b_local = h0["idx"].shape[0]
    cap_local = h0["input_ids"].shape[0]
    b_global = b_local * n_hosts
    cap_global = cap_local * n_hosts

    out: Dict[str, np.ndarray] = {}
    for key in h0:
        parts = [hb[key] for hb in host_batches]
        if key == "nsamples":
            out[key] = np.asarray(sum(int(p) for p in parts), h0[key].dtype)
        elif key == "node_graph":
            out[key] = np.concatenate(
                [np.where(hb["node_mask"], p + i * b_local, b_global) for i, (p, hb) in enumerate(zip(parts, host_batches))]
            ).astype(h0[key].dtype)
        elif key == "image_node":
            out[key] = np.concatenate(
                [np.where(hb["image_mask"], p + i * cap_local, cap_global) for i, (p, hb) in enumerate(zip(parts, host_batches))]
            ).astype(h0[key].dtype)
        elif key == "y_node":
            out[key] = np.concatenate(
                [np.where(hb["y_slot_mask"], p + i * cap_local, cap_global) for i, (p, hb) in enumerate(zip(parts, host_batches))]
            ).astype(h0[key].dtype)
        else:
            out[key] = np.concatenate(parts)
    return out


def check_host_shapes(batch: Dict[str, np.ndarray], cfg: DataConfig) -> None:
    """Raise if a rank-local collation overflowed its single-entry capacity
    ladder: its buffers would then be larger than its peers', and a run
    whose ranks disagree on shapes computes garbage or hangs. Provision the
    GLOBAL capacities for the worst rank's slice."""
    expect = {"input_ids": max(cfg.node_capacity_buckets), "images": max(cfg.image_capacity_buckets)}
    if batch["y_node"].size:
        expect["y"] = max(cfg.label_capacity_buckets)
    for key, cap in expect.items():
        got = batch[key].shape[0]
        if got != cap:
            raise ValueError(
                f"host-local batch overflowed its capacity ladder: {key} buffer is {got}, per-host capacity {cap}. "
                "Raise the GLOBAL capacity buckets so every host's worst-case slice fits capacity/host_count "
                "(capacities are split statically across hosts with no communication)."
            )


def local_batch_with_global_indices(local: Dict[str, np.ndarray], host_index: int, host_count: int) -> Dict[str, np.ndarray]:
    """One rank's local batch with the global-coordinate offsets applied
    (the per-rank half of ``assemble_global_batch``)."""
    b_local = local["idx"].shape[0]
    cap_local = local["input_ids"].shape[0]
    out = dict(local)
    out["node_graph"] = np.where(
        local["node_mask"], local["node_graph"] + host_index * b_local, b_local * host_count
    ).astype(local["node_graph"].dtype)
    out["image_node"] = np.where(
        local["image_mask"], local["image_node"] + host_index * cap_local, cap_local * host_count
    ).astype(local["image_node"].dtype)
    if local["y_node"].size:
        out["y_node"] = np.where(
            local["y_slot_mask"], local["y_node"] + host_index * cap_local, cap_local * host_count
        ).astype(local["y_node"].dtype)
    return out


# ---------------------------------------------------------------------------
# sequence parallelism: one sp rank's share of a data rank's batch (JAX
# ``parallel/mesh.py::batch_sharding`` with an sp axis, for a port whose
# ranks hold their own arrays)
# ---------------------------------------------------------------------------

# the flat node capacity, cut into n contiguous blocks (the graph grid's
# fields, attn_bias, spatial_pos, in_degree, out_degree and grid_mask, into
# q-row strips of the padded S)
SP_FLAT_FIELDS = ("input_ids", "token_type_ids", "attention_mask", "node_mask", "node_graph", "node_pos")


def _padded(s: int, n: int) -> int:
    return -(-s // n) * n


def _sp_capacity(counts: Sequence[int], total: int, n: int) -> int:
    """Per-rank capacity of a buffer of ``total`` slots whose entries go to
    the rank holding their node (``counts`` per rank, over every batch of a
    group): a multiple of the even share total/n that fits the fullest
    rank, at least one share."""
    if total % n:
        raise ValueError(f"capacity {total} is not a multiple of sp={n}")
    share = total // n
    if share == 0:
        return 0
    return max(-(-max(counts, default=0) // share), 1) * share


def _token_grid(a: np.ndarray, s_pad: int, fill) -> np.ndarray:
    """(B, N[, N]) node-grid field -> (B, S'[, S']) on the token-prefixed,
    padded axis: index 0 the graph token, 1 .. N the nodes, ``fill``
    elsewhere."""
    b, nmax = a.shape[0], a.shape[1]
    shape = (b,) + (s_pad,) * (a.ndim - 1)
    out = np.full(shape, fill, dtype=a.dtype)
    out[(slice(None),) + (slice(1, nmax + 1),) * (a.ndim - 1)] = a
    return out


def sp_share(batch: Dict[str, np.ndarray], rank: int, size: int, stacked: bool = False) -> Dict[str, np.ndarray]:
    """Sequence-parallel rank ``rank`` of ``size``'s share of one data
    rank's collated batch (or, with ``stacked``, of a (k, ...)-stacked
    group, every microbatch cut alike):
    - the graph grid: S = Nmax + 1 (the graph token first) padded to S', a
      multiple of ``size``; the rank keeps rows [rank c, (rank + 1) c) of
      c = S'/size: ``attn_bias`` the (B, c, S') template strip (padded rows
      and columns -inf: padded keys add nothing, padded rows are all
      masked), ``spatial_pos`` the (B, c, S') strip of +1-shifted bucket ids
      on the token-prefixed axis (0 on the token's row and column and on
      padding), ``in_degree``, ``out_degree``, ``grid_mask`` (B, c) strips
      of the token-prefixed axis (0 / False at the token);
    - the flat node capacity C: block [rank C/size, (rank + 1) C/size);
    - images and labels: those whose node is in the rank's block, in order,
      with ``image_node`` / ``y_node`` re-indexed into the block (pads at
      C/size). Their capacity is a multiple of the even share that fits the
      fullest rank (the same on every rank of the group, which holds the
      same batch);
    - ``graph_mask`` (B,): which graphs are real (the whole grid_mask's
      rows), added; per-graph fields as they are.
    ``model(batch)`` on each rank's share, with the model laid out by
    ``parallel/mesh.py::apply_sequence_parallel``, gives the rank's rows of
    the one-process logits."""
    if not stacked:
        return {k: v[0] for k, v in sp_share({k: np.asarray(v)[None] for k, v in batch.items()}, rank, size, True).items()}
    cap = batch["input_ids"].shape[1]
    if cap % size:
        raise ValueError(f"node capacity {cap} is not a multiple of sp={size}; collate with shard_multiple=sp")
    block = cap // size
    lo, hi = rank * block, (rank + 1) * block

    def owner(node, mask):  # the sp rank of each entry's node (size for pads)
        return np.where(mask, np.minimum(node // block, size), size)

    img_owner = owner(batch["image_node"], batch["image_mask"])
    icap = _sp_capacity([int((img_owner[i] == r).sum()) for i in range(len(img_owner)) for r in range(size)],
                        batch["images"].shape[1], size)
    node_task = batch["y_node"].shape[1] > 0
    if node_task:
        lab_owner = owner(batch["y_node"], batch["y_slot_mask"])
        lcap = _sp_capacity([int((lab_owner[i] == r).sum()) for i in range(len(lab_owner)) for r in range(size)],
                            batch["y"].shape[1], size)
    s = batch["attn_bias"].shape[-1]
    s_pad = _padded(s, size)
    c = s_pad // size
    rows = slice(rank * c, (rank + 1) * c)
    out: Dict[str, np.ndarray] = {}
    micro: List[Dict[str, np.ndarray]] = []
    for i in range(batch["input_ids"].shape[0]):
        mb = {k: v[i] for k, v in batch.items()}
        own = {}
        tpl = np.full((mb["attn_bias"].shape[0], s_pad, s_pad), -np.inf, dtype=mb["attn_bias"].dtype)
        tpl[:, :s, :s] = mb["attn_bias"]
        own["attn_bias"] = tpl[:, rows]
        own["spatial_pos"] = _token_grid(mb["spatial_pos"], s_pad, 0)[:, rows]
        for k in ("in_degree", "out_degree", "grid_mask"):
            own[k] = _token_grid(mb[k], s_pad, 0 if k != "grid_mask" else False)[:, rows]
        own["graph_mask"] = mb["grid_mask"].any(axis=1)
        for k in SP_FLAT_FIELDS:
            own[k] = mb[k][lo:hi]
        keep = np.flatnonzero(img_owner[i] == rank)
        images = np.zeros((icap,) + mb["images"].shape[1:], dtype=mb["images"].dtype)
        images[: len(keep)] = mb["images"][keep]
        own["images"] = images
        own["image_mask"] = np.arange(icap) < len(keep)
        image_node = np.full(icap, block, dtype=mb["image_node"].dtype)
        image_node[: len(keep)] = mb["image_node"][keep] - lo
        own["image_node"] = image_node
        if node_task:
            keep = np.flatnonzero(lab_owner[i] == rank)
            y = np.zeros(lcap, dtype=mb["y"].dtype)
            y[: len(keep)] = mb["y"][keep]
            y_node = np.full(lcap, block, dtype=mb["y_node"].dtype)
            y_node[: len(keep)] = mb["y_node"][keep] - lo
            own.update(y=y, y_node=y_node, y_slot_mask=np.arange(lcap) < len(keep))
        for k, v in mb.items():
            own.setdefault(k, v)
        micro.append(own)
    for k in micro[0]:
        out[k] = np.stack([m[k] for m in micro])
    return out
