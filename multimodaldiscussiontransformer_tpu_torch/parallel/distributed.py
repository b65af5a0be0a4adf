"""The process group of a run across ranks: the port's counterpart of the JAX
package's ``parallel/distributed.py``.

One process drives one device, as in FairSeq's DDP (the reference's
``run_train.sh:52``): ``--distributed-world-size`` counts ranks, i.e. cards.
(In the JAX package it counts hosts, each driving all of its chips.) A run
gets its rank layout either from the FairSeq flags
(``--distributed-world-size/--distributed-rank/--distributed-init-method
tcp://HOST:PORT``) or from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

The backend follows the device: NCCL for ``cuda`` (the rank's card is
``cuda:LOCAL_RANK``, set before the group starts), gloo for ``cpu``. Ranks
that share one card cannot use NCCL; they ask for gloo explicitly
(``backend="gloo"``), which carries ``all_reduce`` and ``broadcast`` on
CUDA tensors: every collective of the port's data- and tensor-parallel
paths is one of those. No NCCL error is ever caught to fall back.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class RankLayout:
    """Where this process sits: its rank among ``world_size``, its index
    among the ranks of its host (the card it drives), and the rendezvous."""

    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    init_method: Optional[str] = None


def rank_layout(
    world_size: int = 1,
    rank: int = 0,
    init_method: Optional[str] = None,
    env: Optional[Mapping[str, str]] = None,
) -> RankLayout:
    """The rank layout from the FairSeq flags, or from ``torchrun``'s
    environment where it has ``WORLD_SIZE`` and the flags keep their
    defaults. A FairSeq ``init_method`` may be ``tcp://HOST:PORT`` or
    ``HOST:PORT``; the local rank is ``rank`` modulo the cards visible
    (every rank on one host)."""
    env = os.environ if env is None else env
    if world_size == 1 and rank == 0 and init_method is None and "WORLD_SIZE" in env:
        addr = f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}" if "MASTER_PORT" in env else "env://"
        return RankLayout(
            rank=int(env.get("RANK", 0)),
            world_size=int(env["WORLD_SIZE"]),
            local_rank=int(env.get("LOCAL_RANK", env.get("RANK", 0))),
            init_method=addr,
        )
    if not 0 <= rank < max(world_size, 1):
        raise ValueError(f"--distributed-rank {rank} is outside [0, {world_size})")
    if init_method is not None and "://" not in init_method:
        init_method = "tcp://" + init_method
    if world_size > 1 and init_method is None:
        raise ValueError("--distributed-world-size > 1 needs --distributed-init-method tcp://HOST:PORT (or torchrun)")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return RankLayout(rank=rank, world_size=world_size, local_rank=rank % cards if cards else rank,
                      init_method=init_method)


def choose_backend(device: str, backend: Optional[str] = None) -> str:
    """NCCL for a CUDA device, gloo for the CPU, unless ``backend`` names
    one (gloo for ranks that share a card)."""
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"unknown distributed backend {backend!r}: nccl or gloo")
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(layout: RankLayout, device: str = "cuda", backend: Optional[str] = None) -> torch.device:
    """Start the process group of ``layout`` (a no-op for one rank without a
    rendezvous) and return this rank's device. On ``cuda`` the rank's card
    is set before the group starts; ``cuda`` without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
        # ranks that share a card (gloo) all drive card 0 of those visible
        index = layout.local_rank if choose_backend(device, backend) == "nccl" else 0
        if dev.index is not None:
            index = dev.index
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    if layout.init_method is None and layout.world_size == 1:
        return dev
    if not dist.is_initialized():
        # no device_id: a group bound to a device makes DeviceMesh split its
        # communicator, which hung a second group started in one process on
        # four H100s; unbound, the communicators start at first use on the
        # current card (set above)
        dist.init_process_group(
            backend=choose_backend(device, backend), init_method=layout.init_method,
            world_size=layout.world_size, rank=layout.rank,
        )
    return dev


def shutdown() -> None:
    """Wait for every rank, then end the process group (if one is up)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def abandon() -> None:
    """End the process group without waiting for the other ranks (a rank
    that failed)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info():
    """(rank, world size, local rank, cards visible): JAX's
    ``process_info`` with one process per card."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return rank, world, int(os.environ.get("LOCAL_RANK", rank % cards if cards else rank)), cards


def per_host_batch_indices(global_indices: np.ndarray, batch_size: int, rank: int, world_size: int) -> np.ndarray:
    """This rank's contiguous slice of a global batch's indices (JAX's
    ``per_host_batch_indices`` with the rank passed in)."""
    if batch_size % world_size:
        raise ValueError(f"batch_size {batch_size} not divisible by {world_size} ranks")
    per = batch_size // world_size
    return global_indices[rank * per : (rank + 1) * per]
