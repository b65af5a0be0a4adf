"""Host-side batching and the input prefetch: the port's copy of the JAX
package's ``data/loader.py``.

- ``stack_microbatches`` groups host batches into the (k, ...)-stacked
  groups of one scan update;
- ``ThreadedPrefetcher`` runs a batch iterator on a background thread, so
  that collation and the host -> card copy of the next groups overlap the
  current update (depth 2, as JAX);
- ``stage`` is what the thread does to each host dict for the card: float
  images cast to the compute dtype on the host (``cast_images_for_transfer``:
  the ViT casts them first thing anyway, so a bf16 model sees the same
  values and the largest payload halves), integers as int64 and masks as
  bool (``collator.to_tensors``), copied into pinned memory and sent with
  non-blocking copies on a side CUDA stream; the consumer's stream waits
  for that copy when it takes the batch (``ready``). On the CPU staging is
  ``to_tensors``.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from multimodaldiscussiontransformer_tpu_torch.data.collator import all_pad_like, pad_batch_to_shapes, to_tensors

_SENTINEL = object()


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


def cast_images_for_transfer(host: Dict[str, Any], dtype: Optional[torch.dtype]) -> Dict[str, Any]:
    """``host`` with its float image buffer as a CPU tensor of ``dtype``
    (no-op without a dtype or a float image buffer)."""
    imgs = host.get("images")
    if dtype is None or imgs is None or not np.issubdtype(np.asarray(imgs).dtype, np.floating):
        return host
    return {**host, "images": torch.from_numpy(np.ascontiguousarray(imgs)).to(dtype)}


class Staged:
    """A batch on the card: its tensors (``tensors``), the event its copy
    completes at and the pinned buffers that copy reads (kept alive until
    the batch is taken)."""

    __slots__ = ("tensors", "device", "event", "pinned")

    def __init__(self, tensors: Dict[str, torch.Tensor], device=None, event=None, pinned=None):
        self.tensors, self.device, self.event, self.pinned = tensors, device, event, pinned

    def ready(self) -> Dict[str, torch.Tensor]:
        """The tensors, usable on the current stream: the stream waits for
        the copy, and the allocator learns that the stream uses them."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
            self.event = self.pinned = None
        return self.tensors


def stage(host: Dict[str, Any], device: torch.device, image_dtype: Optional[torch.dtype] = None,
          stream: Optional["torch.cuda.Stream"] = None) -> Staged:
    """A host batch (or (k, ...)-stacked group) dict on ``device``. On the
    card the copy goes from pinned memory on ``stream`` (a side stream),
    after the host cast of the images to ``image_dtype``."""
    host = cast_images_for_transfer(host, image_dtype)
    if device.type != "cuda":
        return Staged(to_tensors(host, device))
    pinned = {k: t.pin_memory() for k, t in to_tensors(host, "cpu").items()}
    stream = stream if stream is not None else torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        tensors = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return Staged(tensors, device, event, pinned)


class ThreadedPrefetcher:
    """Run ``put_fn`` over ``batches`` on a background thread, ``depth``
    items ahead of the consumer.

    An exception of the thread (in the iterator or in ``put_fn``) is raised
    on the consumer's side when it reaches that item. ``close()`` (also on
    leaving a ``with`` block, at the end or a ``break`` of iteration, and on
    garbage collection) stops the thread, drops the staged items and joins
    it; the iterator is closed on the thread, which shuts down a worker
    loader's processes. ``waits`` holds the seconds the consumer blocked for
    each item."""

    def __init__(self, batches: Iterable, put_fn: Callable[[Any], Any], depth: int = 2,
                 device: Optional[torch.device] = None):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self.waits: List[float] = []
        # the consumer's card, which the thread's copies must target
        card = None
        if device is not None and device.type == "cuda":
            card = device.index if device.index is not None else torch.cuda.current_device()

        def offer(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            it = iter(batches)
            try:
                if card is not None:
                    torch.cuda.set_device(card)
                for b in it:
                    if self._stop.is_set() or not offer(put_fn(b)):
                        return
            except BaseException as e:  # surfaced on the consumer's side
                self._err = e
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                offer(_SENTINEL)

        self._thread = threading.Thread(target=work, daemon=True, name="mdt-prefetch")
        self._thread.start()

    def close(self) -> None:
        """Stop the thread and drop the staged items."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            warnings.warn("the prefetch thread did not stop within 60 s", RuntimeWarning)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        try:
            while True:
                t = time.perf_counter()
                item = self._q.get()
                if item is _SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                self.waits.append(time.perf_counter() - t)
                yield item
        finally:
            self.close()
