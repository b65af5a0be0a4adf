"""Grouping host batches into the stacked microbatches of one update: the
port's copy of ``stack_microbatches`` from the JAX package's
``data/loader.py``. A pinned-memory prefetch to the card is still to come
(``ROADMAP.md``); the trainer copies each microbatch when it runs it."""

from __future__ import annotations

from typing import Dict, Iterable, Iterator

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.data.collator import all_pad_like, pad_batch_to_shapes


def stack_microbatches(batches: Iterable, k: int, pad_tail: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Group a host batch stream into (k, ...)-stacked dicts for the
    scan-accumulated train step.

    Members with different bucket shapes are grown to the group's
    member-wise max with inert padding. A ragged final group keeps its
    smaller leading dim, unless ``pad_tail``, which appends all-pad
    microbatches (zero loss, gradient, sample size and counts) so that the
    group has k members; the update is the short group's."""

    def flush(buf):
        if len(buf) == 1:
            return {key: v[None] for key, v in buf[0].items()}
        shapes = {
            key: tuple(max(np.asarray(b[key]).shape[i] for b in buf) for i in range(np.asarray(buf[0][key]).ndim))
            for key in buf[0]
        }
        if any(np.asarray(b[key]).shape != shapes[key] for b in buf for key in shapes):
            buf = [pad_batch_to_shapes(b, shapes) for b in buf]
        return {key: np.stack([b[key] for b in buf]) for key in buf[0]}

    buf = []
    for b in batches:
        buf.append(b.asdict() if hasattr(b, "asdict") else b)
        if len(buf) == k:
            yield flush(buf)
            buf = []
    if buf:
        if pad_tail and len(buf) < k:
            pad = all_pad_like(buf[0])
            buf.extend(pad for _ in range(k - len(buf)))
        yield flush(buf)
