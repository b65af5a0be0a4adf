"""HatefulDiscussions ingestion, raw JSON trees -> processed graphs: the
port's copy of the JAX package's ``experiments/hateful_discussions/ingest.py``.

``HatefulDiscussions.process()``
(mDT/experiments/hateful_discussions/datasets/hateful_discussions.py:46-236)
with the per-tree O(n^2) Python recursion replaced by
``data/trees.py::tree_distance_pairs`` (the C++ host helper where it builds)
and torch tensors by ``.npz`` arrays for the static-bucket collator.

Per JSON line (one discussion tree ``{data, tree: [...], id}``):
1. ``collapse_tree`` flattens the nested tree in DFS preorder (ref
   ``collapse_tree``, lines 266-298: the "[deleted]"-body rule and
   root-image inheritance);
2. all-pairs (up, down) tree distances from the parent pointers;
3. text: markdown-link and URL regexes (lines 51-65), title + selftext/body
   (``extract_text``, lines 67-86), tokenized to 100 tokens;
4. at most one image per node, 224x224 with ViT normalization; a node
   without an image has mask False;
5. the binary label: hate = {DEG, lti_hate, IdentityDirectedAbuse,
   AffiliationDirectedAbuse}, normal = {Neutral, lti_normal, NDG, HOM}
   (lines 185-191); one graph copy per labelled node, with a single-label
   ``y_mask`` (lines 196-232);
6. the writers below save ``graph-<k>.npz`` (a tree's arrays once in
   ``shared-<tree>.npz`` and a stub per copy, or self-contained) and append
   to ``{train,test}-idx-many.txt``; ``dataset.py`` reads them back.

The tokenizer is the offline WordPiece (``data/tokenizer.py``) over
``$MDT_BERT_VOCAB``, else a local HF tokenizer; without either it raises
unless the hash fallback is asked for. ``transformers`` and PIL are imported
only on the routes that need them: an image given as a 224x224 array needs
neither.

Run: ``python -m multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.ingest
pruned-with-images.json OUT_ROOT [--train-idx F --test-idx F] [--image-root D] [--workers N]``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.data.preprocess import GraphItem, preprocess_item
from multimodaldiscussiontransformer_tpu_torch.data.trees import tree_distance_pairs
from multimodaldiscussiontransformer_tpu_torch.native import loader as native_loader

MARKDOWN_REGEX = re.compile(
    r"^\[([\w\s\d]+)\]\(((?:\/|https?:\/\/)[\w\d./?=#]+)\)$"
)
ALL_URL_REGEX = re.compile(
    r"https?:\/\/(?:www\.)?[-a-zA-Z0-9@:%._\+~#=]{1,256}\.[a-zA-Z0-9()]{1,6}"
    r"\b(?:[-a-zA-Z0-9()@:%_\+.~#?&\/=]*)"
)

HATE_LABELS = ("DEG", "lti_hate", "IdentityDirectedAbuse", "AffiliationDirectedAbuse")
GOOD_LABELS = ("Neutral", "lti_normal", "NDG", "HOM")

# ViT image preprocessing constants (google/vit-base-patch16-224
# preprocessor: resize 224, rescale 1/255, normalize mean=std=0.5)
VIT_SIZE = 224
VIT_MEAN = 0.5
VIT_STD = 0.5


def clean_urls(x: str) -> str:
    """hateful_discussions.py:61-65."""
    x = MARKDOWN_REGEX.sub(r"[LINK1] \g<1> [LINK2]", x)
    return ALL_URL_REGEX.sub("", x)


def extract_text(data: Dict) -> str:
    """hateful_discussions.py:67-86: submissions use title + selftext/body,
    comments use body."""
    if "title" in data:
        if "selftext" in data:
            body = "\n" + clean_urls(data["selftext"]) if data["selftext"] != "" else ""
        else:
            body = "\n" + clean_urls(data["body"]) if data.get("body") != "NA" else ""
        return data["title"] + body
    return clean_urls(data.get("body", ""))


# ---------------------------------------------------------------------------
# tokenizers and image preprocessing
# ---------------------------------------------------------------------------


class HashTokenizer:
    """Deterministic offline stand-in for the BERT tokenizer: whitespace
    split + stable hashing into the BERT vocab range. Preserves the exact
    output contract (input_ids / token_type_ids / attention_mask, CLS/SEP
    conventions, max_length padding+truncation). NOT vocabulary-compatible
    with bert-base-uncased — use only when the real tokenizer is
    unavailable (tests, offline ingestion dry-runs)."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self.pad_id = 0
        self.cls_id = 101 if vocab_size > 1100 else 1
        self.sep_id = 102 if vocab_size > 1100 else 2

    def __call__(self, texts: Sequence[str], max_length: int = 100):
        import hashlib

        n = len(texts)
        ids = np.zeros((n, max_length), np.int32)
        mask = np.zeros((n, max_length), np.int32)
        for i, t in enumerate(texts):
            toks = [self.cls_id]
            base = 1000 if self.vocab_size > 1100 else 3
            for w in t.lower().split():
                h = int.from_bytes(
                    hashlib.md5(w.encode()).digest()[:4], "little"
                )
                toks.append(base + h % (self.vocab_size - base - 1))
                if len(toks) >= max_length - 1:
                    break
            toks.append(self.sep_id)
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {
            "input_ids": ids,
            "token_type_ids": np.zeros_like(ids),
            "attention_mask": mask,
        }


def make_tokenizer(
    name: str = "bert-base-uncased",
    vocab_size: int = 30522,
    allow_hash_fallback: bool = False,
) -> Callable:
    """Real WordPiece when a vocab is available, HF tokenizer as second
    choice. FAILS LOUDLY otherwise: the reference contract is real WordPiece
    ids (hateful_discussions.py:160-166) and a silent HashTokenizer fallback
    would produce vocab-incompatible ids that burn a full training run.

    Resolution order:
    1. ``name="__offline__"`` forces the hash fallback explicitly (smoke
       runs with tiny-vocab models);
    2. a vendored ``vocab.txt`` (``$MDT_BERT_VOCAB``) drives the offline
       WordPiece implementation (data/tokenizer.py) — vocabulary-exact
       bert-base-uncased tokenization with zero network;
    3. the local HF cache (fail-fast, no retry storm in zero-egress
       environments); a network download only when ``MDT_ALLOW_DOWNLOAD=1``;
    4. HashTokenizer ONLY when ``allow_hash_fallback=True`` (NOT
       vocab-compatible); otherwise raise."""
    if name == "__offline__":
        return HashTokenizer(vocab_size)
    if name == "bert-base-uncased":
        from multimodaldiscussiontransformer_tpu_torch.data.tokenizer import (
            BertWordPieceTokenizer,
            find_vocab,
        )

        vocab = find_vocab()
        if vocab is not None:
            return BertWordPieceTokenizer(vocab)
    try:
        from transformers import AutoTokenizer

        try:
            tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
        except Exception:
            if os.environ.get("MDT_ALLOW_DOWNLOAD") != "1":
                raise
            tok = AutoTokenizer.from_pretrained(name)

        def call(texts, max_length=100):
            out = tok(
                list(texts),
                padding="max_length",
                truncation=True,
                max_length=max_length,
                return_tensors="np",
            )
            return {
                "input_ids": out["input_ids"].astype(np.int32),
                "token_type_ids": out.get(
                    "token_type_ids", np.zeros_like(out["input_ids"])
                ).astype(np.int32),
                "attention_mask": out["attention_mask"].astype(np.int32),
            }

        return call
    except Exception as e:
        if allow_hash_fallback:
            return HashTokenizer(vocab_size)
        raise RuntimeError(
            f"cannot build a real tokenizer for {name!r}: no vendored "
            "vocab.txt ($MDT_BERT_VOCAB / data/vocab search paths), no "
            f"local HF cache, and downloads are disabled ({e!r}). Refusing "
            "to fall back to the vocab-INCOMPATIBLE HashTokenizer — pass "
            "allow_hash_fallback=True (CLI: --allow-hash-fallback) or use "
            "tokenizer name '__offline__' to opt in explicitly."
        ) from e


def preprocess_image(path_or_array, size: int = VIT_SIZE) -> np.ndarray:
    """(3, 224, 224) float32 pixel values with ViT normalization —
    functional equivalent of ``ViTImageProcessor`` (hateful_discussions.py:
    48-50,172-180): RGB convert, bilinear resize, rescale 1/255,
    normalize mean/std 0.5. A path ending in ``.npy`` holds an (H, W, 3)
    uint8 array, loaded without PIL; an array is taken as it is (PIL only
    resizes one that is not ``size`` x ``size``)."""
    if isinstance(path_or_array, str) and path_or_array.endswith(".npy"):
        path_or_array = np.load(path_or_array, allow_pickle=False)
    if isinstance(path_or_array, str):
        from PIL import Image

        img = Image.open(path_or_array).convert("RGB").resize(
            (size, size), resample=2  # BILINEAR
        )
        arr = np.asarray(img, np.float32)
    else:
        arr = np.asarray(path_or_array, np.float32)
        if arr.shape[:2] != (size, size):
            from PIL import Image

            arr = np.asarray(
                Image.fromarray(arr.astype(np.uint8)).resize((size, size), resample=2),
                np.float32,
            )
    arr = arr / 255.0
    arr = (arr - VIT_MEAN) / VIT_STD
    return arr.transpose(2, 0, 1)


@dataclasses.dataclass
class IngestStats:
    """Per-run ingestion accounting. The reference crashes on the first
    unreadable image (hateful_discussions.py:172-176 has no handler); we
    stay robust but LOUD: every drop is counted and summarized, never
    silently swallowed."""

    trees: int = 0
    nodes: int = 0
    labelled_nodes: int = 0
    graph_copies: int = 0
    images_attempted: int = 0
    images_loaded: int = 0
    images_dropped: int = 0
    # per-phase wall seconds, summed over workers (on a pool they exceed
    # the wall clock)
    t_tokenize: float = 0.0
    t_images: float = 0.0
    t_featurize: float = 0.0  # distances + degree/spatial featurization
    t_write: float = 0.0  # npz serialization (consumer side)
    # up to MAX_EXAMPLES "path: error" strings for the summary
    drop_examples: List[str] = dataclasses.field(default_factory=list)

    MAX_EXAMPLES = 5

    def record_image_drop(self, path: str, err: Exception) -> None:
        self.images_dropped += 1
        if len(self.drop_examples) < self.MAX_EXAMPLES:
            self.drop_examples.append(f"{path}: {type(err).__name__}: {err}")

    def merge(self, other: "IngestStats") -> None:
        self.trees += other.trees
        self.nodes += other.nodes
        self.labelled_nodes += other.labelled_nodes
        self.graph_copies += other.graph_copies
        self.images_attempted += other.images_attempted
        self.images_loaded += other.images_loaded
        self.images_dropped += other.images_dropped
        self.t_tokenize += other.t_tokenize
        self.t_images += other.t_images
        self.t_featurize += other.t_featurize
        self.t_write += other.t_write
        for ex in other.drop_examples:
            if len(self.drop_examples) < self.MAX_EXAMPLES:
                self.drop_examples.append(ex)

    def phase_seconds(self) -> Dict[str, float]:
        return {
            "tokenize": round(self.t_tokenize, 2),
            "images": round(self.t_images, 2),
            "featurize": round(self.t_featurize, 2),
            "write": round(self.t_write, 2),
        }

    def summary(self) -> str:
        lines = [
            f"trees={self.trees} nodes={self.nodes} "
            f"labelled={self.labelled_nodes} graph_copies={self.graph_copies}",
            f"images: attempted={self.images_attempted} "
            f"loaded={self.images_loaded} dropped={self.images_dropped}",
            "phase seconds (summed over workers): "
            + " ".join(f"{k}={v}" for k, v in self.phase_seconds().items()),
        ]
        if self.images_dropped:
            lines.append(
                f"WARNING: {self.images_dropped} image(s) failed to load and "
                "were ingested as no-image nodes; first failures:"
            )
            lines.extend(f"  {ex}" for ex in self.drop_examples)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# tree flattening
# ---------------------------------------------------------------------------


def collapse_tree(root: Dict) -> Tuple[List[str], Dict[str, Dict], np.ndarray]:
    """Flatten the nested ``{data, tree, id}`` discussion into
    (ordered ids, id -> node record, parent-pointer array).

    Follows the reference rules (hateful_discussions.py:266-298): DFS
    preorder; duplicate ids keep the first record unless the first body was
    "[deleted]" and a later copy differs; nodes with no images inherit the
    root's images."""
    order: List[str] = []
    records: Dict[str, Dict] = {}
    parent_of: Dict[str, Optional[str]] = {}
    root_images = root.get("images", [])

    stack = [(root, None)]
    # iterative DFS preorder matching the recursion order: push children
    # reversed so the first child is visited first
    while stack:
        node, parent = stack.pop()
        data = dict(node.get("data", {}))
        data["id"] = node.get("id", data.get("id"))
        nid = data["id"]
        images = node.get("images", []) or root_images
        label = data.get("label", "NA")
        if nid in records:
            if (
                data.get("body") != records[nid]["data"].get("body")
                and records[nid]["data"].get("body") == "[deleted]"
            ):
                records[nid] = {"data": data, "images": images, "label": label}
        else:
            order.append(nid)
            records[nid] = {"data": data, "images": images, "label": label}
            parent_of[nid] = parent
        for child in reversed(node.get("tree", [])):
            stack.append((child, nid))

    index = {nid: i for i, nid in enumerate(order)}
    parents = np.asarray(
        [index[parent_of[nid]] if parent_of[nid] is not None else -1 for nid in order],
        np.int64,
    )
    return order, records, parents


def tree_to_items(
    raw: Dict,
    tokenizer: Callable,
    image_root: str = "",
    max_length: int = 100,
    image_loader: Callable = preprocess_image,
    start_idx: int = 0,
    image_size: int = VIT_SIZE,
    stats: Optional[IngestStats] = None,
) -> List[GraphItem]:
    """One raw discussion -> one GraphItem per labelled node
    (the per-label graph duplication of hateful_discussions.py:196-232).

    The copies differ only in (idx, y, y_mask): tokens, distances,
    featurization and images are computed once per tree and shared by
    reference across the copies (the reference's duplication is
    storage-side too, hateful_discussions.py:196-232)."""
    import time as _time

    order, records, parents = collapse_tree(raw)
    n = len(order)
    _t = _time.perf_counter()
    pairs = tree_distance_pairs(parents)
    if stats is not None:
        stats.t_featurize += _time.perf_counter() - _t
    edges = [(int(p), i) for i, p in enumerate(parents) if p >= 0]
    edge_index = (
        np.asarray(edges + [(b, a) for a, b in edges], np.int64).T
        if edges
        else np.zeros((2, 0), np.int64)
    )

    _t = _time.perf_counter()
    texts = [extract_text(records[nid]["data"]) for nid in order]
    tokens = tokenizer(texts, max_length=max_length)
    if stats is not None:
        stats.t_tokenize += _time.perf_counter() - _t

    _t = _time.perf_counter()
    has_image = np.zeros(n, bool)
    imgs = []
    for i, nid in enumerate(order):
        paths = records[nid]["images"]
        if paths:
            full = os.path.join(image_root, paths[0]) if image_root else paths[0]
            if stats is not None:
                stats.images_attempted += 1
            try:
                imgs.append(image_loader(full, image_size))
                has_image[i] = True
                if stats is not None:
                    stats.images_loaded += 1
            except Exception as e:
                # robust-but-loud: the node becomes a no-image node, and the
                # drop is accounted for in the per-run summary (the reference
                # would crash here instead — silent drops burn corpora).
                if stats is not None:
                    stats.record_image_drop(full, e)
    x_images = (
        np.stack(imgs).astype(np.float32)
        if imgs
        else np.zeros((0, 3, image_size, image_size), np.float32)
    )
    if stats is not None:
        stats.t_images += _time.perf_counter() - _t

    labels = [records[nid]["label"] for nid in order]
    labelled = [
        i for i, l in enumerate(labels) if l in HATE_LABELS or l in GOOD_LABELS
    ]

    items = []
    if labelled:
        # shared featurization ONCE; per-copy fields swapped in by replace
        _t = _time.perf_counter()
        base = preprocess_item(
            idx=start_idx,
            tokens=tokens,
            edge_index=edge_index,
            distance_pairs=pairs,
            x_images=x_images,
            x_image_index=has_image,
            y=np.zeros(1, np.int64),
            y_mask=np.zeros(n, bool),
        )
        if stats is not None:
            stats.t_featurize += _time.perf_counter() - _t
        for j, node_i in enumerate(labelled):
            y_mask = np.zeros(n, bool)
            y_mask[node_i] = True
            y = np.asarray(
                [1 if labels[node_i] in HATE_LABELS else 0], np.int64
            )
            items.append(
                dataclasses.replace(
                    base, idx=start_idx + j, y=y, y_mask=y_mask
                )
            )
    if stats is not None:
        stats.trees += 1
        stats.nodes += n
        stats.labelled_nodes += len(labelled)
        stats.graph_copies += len(items)
    return items


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

SHARED_FIELDS = (
    "input_ids", "token_type_ids", "attention_mask", "spatial_pos",
    "distance", "in_degree", "x_images", "x_image_index",
)


def _text_len(item: GraphItem) -> int:
    am = item.attention_mask
    return int(np.max(np.where(am.any(axis=0))[0], initial=0)) + 1 if am.any() else 1


def _label_arrays(item: GraphItem) -> dict:
    """``y``, with ``y_mask`` (node task) and ``hard_y`` (contrastive task)
    where the item has them."""
    out = {"y": item.y}
    if item.y_mask is not None:
        out["y_mask"] = item.y_mask
    if item.hard_y is not None:
        out["hard_y"] = item.hard_y
    return out


def save_shared_npz(path: str, item: GraphItem) -> None:
    """The arrays every copy of one tree shares, written once per tree."""
    np.savez_compressed(path, **{f: getattr(item, f) for f in SHARED_FIELDS})


def save_copy_npz(path: str, item: GraphItem, shared_ref: str) -> None:
    """A per-copy stub: the labels, the ``text_len`` probe and
    ``shared_ref``, the shared file's name relative to the stub."""
    np.savez_compressed(
        path,
        idx=np.asarray(item.idx),
        text_len=np.asarray(_text_len(item), np.int32),
        shared_ref=np.asarray(shared_ref),
        **_label_arrays(item),
    )


def save_graph_npz(path: str, item: GraphItem) -> None:
    """One self-contained graph, with the ``text_len`` probe that
    length-grouped batching reads instead of the arrays."""
    np.savez_compressed(
        path,
        idx=np.asarray(item.idx),
        text_len=np.asarray(_text_len(item), np.int32),
        **{f: getattr(item, f) for f in SHARED_FIELDS},
        **_label_arrays(item),
    )


# ---------------------------------------------------------------------------
# ingestion of a whole corpus (the reference's process() is serial; this one can
# spread the per-tree work over a process pool)
# ---------------------------------------------------------------------------
_WORKER_STATE: Dict = {}


def _ingest_worker_init(
    tokenizer_name, vocab_size, image_root, max_length, image_size,
    allow_hash_fallback=False,
):
    _WORKER_STATE["tokenizer"] = make_tokenizer(
        tokenizer_name, vocab_size, allow_hash_fallback=allow_hash_fallback
    )
    _WORKER_STATE["args"] = (image_root, max_length, image_size)


def _ingest_worker(line: str) -> Tuple[List[GraphItem], IngestStats]:
    image_root, max_length, image_size = _WORKER_STATE["args"]
    stats = IngestStats()
    items = tree_to_items(
        json.loads(line), _WORKER_STATE["tokenizer"], image_root=image_root,
        max_length=max_length, start_idx=0, image_size=image_size,
        stats=stats,
    )
    return items, stats


def process(
    json_path: str,
    out_root: str,
    train_idx_file: Optional[str] = None,
    test_idx_file: Optional[str] = None,
    tokenizer_name: str = "bert-base-uncased",
    image_root: str = "",
    max_length: int = 100,
    limit: Optional[int] = None,
    log_every: int = 1000,
    vocab_size: int = 30522,
    image_size: int = VIT_SIZE,
    workers: int = 0,
    allow_hash_fallback: bool = False,
    dedup: bool = True,
    stats_sink: Optional[IngestStats] = None,
) -> int:
    """Full ingestion over ``pruned-with-images.json``; returns the number of
    processed graph copies. Layout mirrors the reference
    (graph-<k>.npz under <out_root>/processed + *-idx-many.txt index files,
    hateful_discussions.py:88-106,225-231).

    ``workers > 0`` fans the per-tree work (tokenize, image preprocess,
    distance matrices) out over a process pool, preserving output order and
    idx assignment exactly (ordered imap; idx numbering happens here).

    Prints a per-corpus accounting summary at the end (trees / nodes /
    labelled / graph copies / image drops — the reference's FINAL K /
    TOTAL Ys summary, hateful_discussions.py:234-236, extended with
    robust-but-loud image-failure accounting), and which path computed the
    tree distances (the C++ host helper, or numpy)."""
    os.makedirs(os.path.join(out_root, "processed"), exist_ok=True)

    def read_idx(path):
        if path and os.path.exists(path):
            with open(path) as f:
                return {int(line) for line in f if line.strip()}
        return None

    train_nums = read_idx(train_idx_file)
    test_nums = read_idx(test_idx_file)

    def selected_lines(f):
        for graph_num, line in enumerate(f):
            if limit is not None and graph_num >= limit:
                break
            if train_nums is not None and test_nums is not None:
                if graph_num not in train_nums and graph_num not in test_nums:
                    continue
            yield graph_num, line

    init_args = (
        tokenizer_name, vocab_size, image_root, max_length, image_size,
        allow_hash_fallback,
    )

    k = 0
    run_stats = IngestStats()
    with open(json_path) as f, open(
        os.path.join(out_root, "train-idx-many.txt"), "w"
    ) as train_out, open(
        os.path.join(out_root, "test-idx-many.txt"), "w"
    ) as test_out, open(
        os.path.join(out_root, "tree-map.txt"), "w"
    ) as map_out:

        def consume(results):
            import time as _time

            nonlocal k
            for graph_num, (items, tree_stats) in results:
                run_stats.merge(tree_stats)
                # tree -> graph-copy mapping: "<tree_line> <first_k>
                # <n_copies>" per source tree, so downstream stages (e.g.
                # the contrastive corpus: one graph per TREE) can reuse the
                # ingested npz files without re-tokenizing the raw JSON
                map_out.write(f"{graph_num} {k} {len(items)}\n")
                _t = _time.perf_counter()
                shared_name = None
                if dedup and items:
                    # shared per-tree arrays once; copies are tiny stubs
                    shared_name = f"shared-{graph_num}.npz"
                    save_shared_npz(
                        os.path.join(out_root, "processed", shared_name),
                        items[0],
                    )
                for item in items:
                    item = dataclasses.replace(item, idx=k)
                    path = os.path.join(
                        out_root, "processed", f"graph-{k}.npz"
                    )
                    if shared_name is not None:
                        save_copy_npz(path, item, shared_name)
                    else:
                        save_graph_npz(path, item)
                    if test_nums is not None and graph_num in test_nums:
                        test_out.write(f"{k}\n")
                    else:
                        train_out.write(f"{k}\n")
                    k += 1
                run_stats.t_write += _time.perf_counter() - _t
                if log_every and graph_num % log_every == 0:
                    print(f"graph {graph_num}: {k} copies written")

        if workers and workers > 1:
            import multiprocessing as mp
            import threading

            selected = list(selected_lines(f))
            ctx = mp.get_context("fork" if hasattr(os, "fork") else "spawn")
            # backpressure: imap queues results without bound, and the
            # consumer (np.savez_compressed) is slower than the workers, so
            # pickled image-bearing items would pile up in this process.
            # The input iterator waits on a semaphore released per consumed
            # tree: at most ``max_in_flight`` trees are ever in the queue.
            chunksize = 8
            max_in_flight = max(8 * workers, 4 * chunksize)
            gate = threading.BoundedSemaphore(max_in_flight)

            def gated_lines():
                for _, line in selected:
                    gate.acquire()
                    yield line

            def released(results):
                for r in results:
                    gate.release()
                    yield r

            with ctx.Pool(
                workers, initializer=_ingest_worker_init, initargs=init_args
            ) as pool:
                try:
                    consume(
                        zip(
                            (g for g, _ in selected),
                            released(
                                pool.imap(
                                    _ingest_worker, gated_lines(),
                                    chunksize=chunksize,
                                )
                            ),
                        )
                    )
                finally:
                    # unblock imap's task-feeder thread if consumption
                    # stopped early (exception): Pool teardown joins it,
                    # and it may be parked on gate.acquire()
                    for _ in range(max_in_flight):
                        try:
                            gate.release()
                        except ValueError:
                            break
        else:
            _ingest_worker_init(*init_args)
            consume(
                (graph_num, _ingest_worker(line))
                for graph_num, line in selected_lines(f)
            )
    print(f"FINAL K {k}")
    print(run_stats.summary())
    print(f"tree distances: {'the C++ host helper' if native_loader.try_load() is not None else 'numpy'}")
    if stats_sink is not None:
        stats_sink.merge(run_stats)
    return k


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="HatefulDiscussions ingestion")
    p.add_argument("json_path")
    p.add_argument("out_root")
    p.add_argument("--train-idx", default=None)
    p.add_argument("--test-idx", default=None)
    p.add_argument("--image-root", default="")
    p.add_argument("--tokenizer", default="bert-base-uncased")
    p.add_argument("--max-length", type=int, default=100)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--vocab-size", type=int, default=30522)
    p.add_argument("--workers", type=int, default=0)
    p.add_argument(
        "--allow-hash-fallback", action="store_true",
        help="permit the vocab-INCOMPATIBLE HashTokenizer when no real "
        "tokenizer resolves (otherwise ingestion fails loudly)",
    )
    p.add_argument(
        "--no-dedup", action="store_true",
        help="write self-contained graph-<k>.npz files instead of "
        "shared-<tree>.npz + per-copy stubs",
    )
    args = p.parse_args(argv)
    process(
        args.json_path, args.out_root,
        train_idx_file=args.train_idx, test_idx_file=args.test_idx,
        tokenizer_name=args.tokenizer, image_root=args.image_root,
        max_length=args.max_length, limit=args.limit,
        vocab_size=args.vocab_size, workers=args.workers,
        allow_hash_fallback=args.allow_hash_fallback,
        dedup=not args.no_dedup,
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
