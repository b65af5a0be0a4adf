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
