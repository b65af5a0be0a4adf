"""Dataset wrapper, epoch shuffling and batch iteration: the port's copy of
the JAX package's ``data/dataset.py`` (node and contrastive tasks). For the same dataset,
seed and epoch both packages yield bit-equal batches.

- split modes: a random 80/10/10 split, or explicit index arrays with a
  seeded shuffle of the training indices;
- the per-epoch order is ``RandomState(seed + epoch - 1).permutation``;
- the epoch's batch order is a list of index chunks (``batch_index_chunks``);
  ``ChunkCollator`` loads each chunk's graphs and collates them into
  static-capacity buffers (``data/collator.py``), in this process
  (``iterate_batches``) or in worker processes (``data/worker_loader.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig, TaskConfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import Batch, collate
from multimodaldiscussiontransformer_tpu_torch.data.preprocess import GraphItem
from multimodaldiscussiontransformer_tpu_torch.parallel.input import check_host_shapes, host_data_config, host_graph_slice


@dataclass
class DiscussionDataset:
    """Preprocessed discussion graphs (or callables returning them) with
    train/valid/test splits."""

    items: Sequence
    train_idx: np.ndarray
    valid_idx: np.ndarray
    test_idx: np.ndarray

    def get(self, i: int) -> GraphItem:
        it = self.items[i]
        return it() if callable(it) else it

    def __len__(self) -> int:
        return len(self.items)

    def text_length(self, i: int) -> int:
        """Max attended token length across the graph's nodes (cached; used
        by length-grouped batching). A lazy item with a ``text_length``
        probe (``NpzItemLoader``) answers without loading its arrays."""
        cache = self.__dict__.setdefault("_len_cache", {})
        if i not in cache:
            probe = getattr(self.items[i], "text_length", None)
            if callable(probe):
                cache[i] = int(probe())
            else:
                am = self.get(i).attention_mask
                cache[i] = int(np.max(np.where(am.any(axis=0))[0], initial=0)) + 1 if am.any() else 1
        return cache[i]

    @classmethod
    def from_splits(
        cls, items: Sequence, train_idx=None, valid_idx=None, test_idx=None,
        seed: int = 0, train_frac: float = 0.8, valid_frac: float = 0.1,
    ) -> "DiscussionDataset":
        """Explicit index arrays (training indices shuffled with ``seed``) or
        a random 80/10/10 split."""
        n = len(items)
        rng = np.random.RandomState(seed)
        if train_idx is None:
            perm = rng.permutation(n)
            n_train = int(n * train_frac)
            n_valid = int(n * valid_frac)
            train_idx = perm[:n_train]
            valid_idx = perm[n_train : n_train + n_valid]
            test_idx = perm[n_train + n_valid :]
        else:
            train_idx = np.asarray(train_idx)
            rng.shuffle(train_idx)
            valid_idx = np.asarray(valid_idx if valid_idx is not None else test_idx)
            test_idx = np.asarray(test_idx)
        return cls(items, train_idx, valid_idx, test_idx)


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """The epoch's order: ``RandomState(seed + epoch - 1).permutation(n)``."""
    return np.random.RandomState((seed + epoch - 1) % (2**32)).permutation(n)


def batch_index_chunks(
    dataset: DiscussionDataset,
    indices: np.ndarray,
    data_cfg: DataConfig,
    task_cfg: TaskConfig,
    epoch: int = 1,
    shuffle: bool = False,
    drop_last: Optional[bool] = None,
    batch_size: Optional[int] = None,
) -> List[np.ndarray]:
    """The epoch's batch order as index chunks: the seeded epoch shuffle,
    optional length grouping, and drop-last or a ragged tail."""
    order = np.asarray(indices)
    if shuffle:
        order = order[epoch_permutation(len(order), task_cfg.seed, epoch)]
    bs = batch_size if batch_size is not None else data_cfg.batch_size
    drop = data_cfg.drop_last if drop_last is None else drop_last
    if shuffle and data_cfg.length_grouped:
        # sort the shuffled order by text length so a batch holds similar
        # lengths, then shuffle the batch order with the same epoch seed
        lengths = np.asarray([dataset.text_length(int(i)) for i in order])
        order = order[np.argsort(lengths, kind="stable")]
        n_chunks = len(order) // bs
        chunk_perm = epoch_permutation(n_chunks, task_cfg.seed + 1, epoch)
        head = order[: n_chunks * bs].reshape(n_chunks, bs)[chunk_perm]
        order = np.concatenate([head.reshape(-1), order[n_chunks * bs :]])
    end = (len(order) // bs) * bs if drop else len(order)
    return [order[s : s + bs] for s in range(0, end, bs) if len(order[s : s + bs])]


@dataclass
class ChunkCollator:
    """Loads the graphs of one index chunk and collates them. Picklable, so
    worker processes run it too (``data/worker_loader.py``).

    With ``host_count > 1`` (the JAX ``grain_loader._CollateChunk``) a chunk
    is a global batch of ``global_batch`` rows and the collator keeps
    data-parallel rank ``host_index``'s contiguous slice of it
    (``parallel/input.py::host_graph_slice``), collated on the per-rank
    single-entry ladders that ``data_cfg`` then holds; a ragged chunk
    raises unless the tail is padded (``pad_to_graphs``: every rank then
    steps equally often, a rank whose slice of the tail is empty with an
    all-pad batch); ``nsamples`` is the global count of real graphs; and a
    batch that overflows its per-rank capacity raises
    (``check_host_shapes``)."""

    dataset: DiscussionDataset
    data_cfg: DataConfig
    task_cfg: TaskConfig
    image_shape: tuple = (3, 224, 224)
    pad_to_graphs: Optional[int] = None
    contrastive: bool = False
    shard_multiple: int = 1
    host_index: int = 0
    host_count: int = 1
    global_batch: int = 0

    def __call__(self, chunk: np.ndarray) -> Batch:
        cfg, task = self.data_cfg, self.task_cfg
        global_real = len(chunk)
        pad_to = self.pad_to_graphs
        if self.host_count > 1:
            if len(chunk) != self.global_batch and pad_to is None:
                raise ValueError(
                    f"multi-rank loading got a ragged chunk of {len(chunk)} rows (global batch {self.global_batch}); "
                    "use drop_last=True for training or pad_tail_to_batch=True for eval so every chunk is rank-sliceable"
                )
            chunk = chunk[host_graph_slice(self.host_index, self.host_count, self.global_batch)]
            pad_to = None if pad_to is None else pad_to // self.host_count
        items = [self.dataset.get(int(i)) for i in chunk]
        over = [(int(i), it.num_nodes) for i, it in zip(chunk, items) if it.num_nodes > task.max_nodes]
        if over:
            raise ValueError(
                f"graph(s) exceed task.max_nodes={task.max_nodes} (idx, nodes): {over[:5]}; "
                "raise --max-nodes or prune the trees"
            )
        out = collate(
            items,
            pad_to_graphs=pad_to,
            spatial_pos_max=task.spatial_pos_max,
            node_buckets=cfg.node_buckets,
            node_capacity_buckets=cfg.node_capacity_buckets,
            image_capacity_buckets=cfg.image_capacity_buckets,
            label_capacity_buckets=cfg.label_capacity_buckets,
            image_shape=self.image_shape,
            text_len_buckets=cfg.text_len_buckets,
            text_len=cfg.max_text_len,
            contrastive=self.contrastive,
            shard_multiple=self.shard_multiple,
        )
        if self.host_count > 1:
            check_host_shapes(out.asdict(), cfg)
            out = dataclasses.replace(out, nsamples=np.asarray(global_real, out.nsamples.dtype))
        return out


def epoch_chunks(
    dataset: DiscussionDataset,
    indices: np.ndarray,
    data_cfg: DataConfig,
    task_cfg: TaskConfig,
    epoch: int = 1,
    shuffle: bool = False,
    image_shape=(3, 224, 224),
    drop_last: Optional[bool] = None,
    batch_size: Optional[int] = None,
    pad_tail_to_batch: bool = False,
    contrastive: bool = False,
    shard_multiple: int = 1,
    host_index: int = 0,
    host_count: int = 1,
) -> Tuple[List[np.ndarray], ChunkCollator]:
    """The epoch's index chunks and the collator that turns each into a
    batch: what ``iterate_batches`` runs in this process and
    ``worker_batches`` in worker processes. With ``host_count > 1`` the
    chunks are the global batches and the collator yields data-parallel
    rank ``host_index``'s slice of each (``ChunkCollator``)."""
    bs = batch_size if batch_size is not None else data_cfg.batch_size
    chunks = batch_index_chunks(dataset, indices, data_cfg, task_cfg, epoch=epoch, shuffle=shuffle,
                                drop_last=drop_last, batch_size=bs)
    cfg = data_cfg if host_count == 1 else host_data_config(data_cfg, host_count)
    return chunks, ChunkCollator(dataset, cfg, task_cfg, tuple(image_shape), bs if pad_tail_to_batch else None,
                                 contrastive, shard_multiple, host_index, host_count, bs)


def iterate_batches(dataset: DiscussionDataset, indices: np.ndarray, data_cfg: DataConfig, task_cfg: TaskConfig,
                    **kw) -> Iterator[Batch]:
    """Yield collated static-shape batches for one epoch (per-graph targets
    with ``contrastive``); ``kw`` as ``epoch_chunks``. With
    ``pad_tail_to_batch`` a ragged final batch (``drop_last=False``) is
    padded to the full batch size with inert zero-node graphs."""
    chunks, collate_chunk = epoch_chunks(dataset, indices, data_cfg, task_cfg, **kw)
    for chunk in chunks:
        yield collate_chunk(chunk)
