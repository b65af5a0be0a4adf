"""Batch collation in worker processes (``DataConfig.num_workers > 0``, the
reference's ``--num-workers 8``): the port's counterpart of the JAX
package's ``data/grain_loader.py``, on ``torch.utils.data.DataLoader``.

The epoch's index chunks and the collator come from
``data/dataset.py::epoch_chunks``, as for ``iterate_batches``; the workers
only run the collator on each chunk, and the loader yields the batches in
chunk order. So ``worker_batches`` yields the batches of
``iterate_batches``, bit for bit, a data-parallel rank's slices
(``host_index``/``host_count``) included.

The workers are started with ``spawn``: the parent may hold a CUDA context
and a live prefetch thread, which a forked child must not inherit. The
dataset goes to them by pickle (``GraphItem`` dataclasses, or the lazy
``NpzItemLoader`` of ``hateful_discussions``, which holds its path only).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig, TaskConfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import Batch
from multimodaldiscussiontransformer_tpu_torch.data.dataset import ChunkCollator, DiscussionDataset, epoch_chunks


class _CollatedChunks(torch.utils.data.Dataset):
    """Item ``i`` is chunk ``i`` collated."""

    def __init__(self, chunks: List[np.ndarray], collate_chunk: ChunkCollator):
        self.chunks, self.collate_chunk = chunks, collate_chunk

    def __len__(self) -> int:
        return len(self.chunks)

    def __getitem__(self, i: int) -> Batch:
        return self.collate_chunk(self.chunks[i])


def _as_is(batch: Batch) -> Batch:
    return batch


def worker_batches(
    dataset: DiscussionDataset,
    indices: np.ndarray,
    data_cfg: DataConfig,
    task_cfg: TaskConfig,
    num_workers: Optional[int] = None,
    read_ahead: int = 2,
    **kw,
) -> Iterator[Batch]:
    """``iterate_batches`` (``kw`` as ``epoch_chunks``) with the collation in
    ``num_workers`` (default ``data_cfg.num_workers``, at least 1) spawned
    processes, ``read_ahead`` batches ahead per worker. Closing the iterator
    shuts the workers down."""
    workers = data_cfg.num_workers if num_workers is None else num_workers
    if workers < 1:
        raise ValueError(f"worker_batches needs num_workers >= 1, got {workers}; use iterate_batches")
    chunks, collate_chunk = epoch_chunks(dataset, indices, data_cfg, task_cfg, **kw)
    if not chunks:
        return
    loader = torch.utils.data.DataLoader(
        _CollatedChunks(chunks, collate_chunk), batch_size=None, shuffle=False,
        num_workers=min(workers, len(chunks)), collate_fn=_as_is,
        multiprocessing_context="spawn", prefetch_factor=max(read_ahead, 1),
    )
    it = iter(loader)
    try:
        yield from it
    finally:
        it._shutdown_workers()  # the loader has no public close: stop the workers now, not at collection
