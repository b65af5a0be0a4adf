"""One-command two-stage rehearsal, raw JSON -> ingest -> contrastive
pre-training -> transfer -> fine-tuning -> test F1: the port's copy of the
JAX package's ``experiments/hateful_discussions/two_stage.py``.

The reference's training story is two stages (run_train.sh:57-63): restore
a contrastive pre-training checkpoint with ``--reset-optimizer`` and
fine-tune on node prediction. The real corpus and tower weights are out of
reach, so this module rehearses the whole pipeline on a mini-corpus it
generates itself:

1. ``generate_mini_corpus`` writes raw discussion trees in the reference
   JSON schema (nested ``{id, data, images, tree}`` lines) with hate/normal
   labels, per-tree communities (for the contrastive stage), images on some
   roots and a mini WordPiece ``vocab.txt``. It draws from one
   ``np.random.RandomState(seed)`` in the JAX generator's order, so that
   ``raw.json``, ``communities.json``, ``vocab.txt`` and the PNG images are
   byte-equal to JAX's at the same seed. Images are PNG through PIL
   (``image_format="png"``, JAX's only format) or, asked for explicitly,
   ``.npy`` arrays of the same pixels (``image_format="npy"``, no PIL; the
   tree then names ``images/img<t>.npy``, which the ingest reads without
   PIL). ``image_style="smooth"`` resizes with PIL's bilinear filter and
   raises without PIL;
2. ``data_prep.splits.make_splits`` writes hate-stratified splits;
3. ``ingest.process`` tokenizes with the offline WordPiece and writes
   ``graph-<k>.npz`` + the index files;
4. stage 1 trains ``contrastive_learning`` on the per-tree communities
   (polar-opposite pairs as hard negatives), lazily over the ingested npz
   graphs (``contrastive_dataset_from_ingest``);
5. the checkpoint is restored into a ``node_prediction`` trainer with the
   optimizer and the classifier head reset. The head is drawn from a CPU
   ``torch.Generator`` seeded with ``seed + 17`` (JAX: the PRNG key
   ``seed + 17``): the same initializer, other bits;
6. stage 2 fine-tunes and prints test accuracy/P/R/F1 as one ``TEST`` line.

Run: ``python -m multimodaldiscussiontransformer_tpu_torch.experiments.\
hateful_discussions.two_stage --out DIR`` (on the card; ``--device cpu``
for the CPU). The model is the module's own small geometry (hidden 64).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

# word lists: hate-labelled comments draw from HATE_WORDS, others from
# NEUTRAL_WORDS; communities skew topic words so contrastive can learn
HATE_WORDS = "blight vermin scum filth degenerate parasite".split()
NEUTRAL_WORDS = (
    "thanks interesting agree point source fair question answer detail "
    "update thread reply topic post story"
).split()
COMMUNITY_WORDS = {
    0: "gaming console pixel quest".split(),
    1: "garden flower seed bloom".split(),
    2: "finance market stock trade".split(),
    3: "cooking recipe flavor spice".split(),
}
# polar-opposite community pairs (hard negatives, contrastive_loss.py:124)
POLAR = {0: 1, 1: 0, 2: 3, 3: 2}

# context-mode markers: planted in the PARENT's text; the child's label
# depends only on whether its parent carries one (see _write_context_tree)
MARKER_WORDS = "klaxon beacon omen".split()

IMAGE_FORMATS = ("png", "npy")


def _mini_vocab() -> List[str]:
    words = sorted(
        set(
            HATE_WORDS
            + NEUTRAL_WORDS
            + MARKER_WORDS
            + [w for ws in COMMUNITY_WORDS.values() for w in ws]
            + "a the this is so very and much title link1 link2".split()
        )
    )
    return ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[", "]"] + words


def _sentence(rng, community: int, hateful: bool, n_words: int = 8) -> str:
    pool = (HATE_WORDS if hateful else NEUTRAL_WORDS) + COMMUNITY_WORDS[community]
    return " ".join(rng.choice(pool) for _ in range(n_words))


def _pil_image(what: str):
    """PIL's ``Image`` module, or ImportError naming PIL and what needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{what} needs PIL (Pillow), which is not installed; "
                          "image_format='npy' writes noise images without it") from e
    return Image


def _write_image(out_dir: str, t: int, rng, image_px: int, image_style: str, image_format: str) -> str:
    """Root image ``t``'s pixels, drawn from ``rng`` as JAX draws them, saved
    as ``images/img<t>.png`` (PIL) or ``.npy``; its path in the tree."""
    if image_style == "smooth":
        Image = _pil_image("image_style='smooth' (a bilinear resize)")
        # low-frequency content (photo-like compressibility)
        base = rng.randint(0, 255, (4, 4, 3), dtype=np.uint8)
        arr = np.asarray(Image.fromarray(base).resize((image_px, image_px), resample=2))
    else:
        arr = rng.randint(0, 255, (image_px, image_px, 3), dtype=np.uint8)
    if image_format == "npy":
        image = f"images/img{t}.npy"
        np.save(os.path.join(out_dir, image), arr)
    else:
        image = f"images/img{t}.png"
        _pil_image("a PNG image").fromarray(arr).save(os.path.join(out_dir, image))
    return image


def generate_mini_corpus(
    out_dir: str,
    n_trees: int = 200,
    seed: int = 0,
    image_prob: float = 0.2,
    image_px: int = 32,
    label_mode: str = "text",
    marker_repeats: int = 3,
    context_star: bool = False,
    image_style: str = "noise",
    comment_dist=None,
    image_format: str = "png",
) -> Dict[str, str]:
    """Write raw.json (reference schema), per-tree communities.json, root
    images and a covering mini vocab.txt. Returns the file paths.

    ``label_mode``:
    - "text": a hateful comment's own body draws from HATE_WORDS (labels are
      text-separable: a pipeline rehearsal);
    - "context": every labelled body is hate-word-free; a comment is hate
      iff its PARENT's text carries a MARKER word (markers are independent
      coins per node): only the tree separates the classes;
    - "marker": the "context" trees, each comment labelled by its OWN
      marker (the supervised warm-up of the context ablation);
    - "context_or": hate iff own OR parent marker (the headline ablation
      corpus: a context-blind classifier has an F1 ceiling below 1).

    ``image_format`` "png" writes PNGs through PIL (JAX's files, byte for
    byte); "npy" writes the same pixels as ``.npy`` arrays without PIL.
    ``comment_dist(rng) -> int`` overrides the tree size of "text" mode."""
    if image_format not in IMAGE_FORMATS:
        raise ValueError(f"image_format {image_format!r}: one of {IMAGE_FORMATS}")
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    raw_path = os.path.join(out_dir, "raw.json")
    communities: List[int] = []
    with open(raw_path, "w") as f:
        for t in range(n_trees):
            community = int(rng.randint(0, 4))
            communities.append(community)
            image = None
            if rng.rand() < image_prob:
                image = _write_image(out_dir, t, rng, image_px, image_style, image_format)
            if label_mode in ("context", "marker", "context_or"):
                _write_context_tree(
                    f, rng, t, community, image, marker_repeats=marker_repeats, star=context_star,
                    label_by={"marker": "self", "context": "parent", "context_or": "self_or_parent"}[label_mode],
                )
                continue
            n_comments = int(comment_dist(rng)) if comment_dist is not None else int(rng.randint(3, 8))
            nodes = []
            for c in range(n_comments):
                hateful = bool(rng.rand() < 0.3)
                label = "DEG" if hateful else ("lti_normal" if rng.rand() < 0.8 else "NA")
                nodes.append(
                    {
                        "id": f"c{t}_{c}",
                        "data": {
                            "id": f"c{t}_{c}",
                            "body": _sentence(rng, community, hateful),
                            "label": label,
                            "parent_id": f"t3_{t}",
                            "link_id": f"t3_{t}",
                        },
                        "images": [],
                        "tree": [],
                    }
                )
            # chain some comments under others for real tree shapes
            top: List[dict] = []
            for i, node in enumerate(nodes):
                if i and rng.rand() < 0.5:
                    parent = nodes[int(rng.randint(0, i))]
                    node["data"]["parent_id"] = parent["id"]
                    parent["tree"].append(node)
                else:
                    top.append(node)
            tree = {
                "id": f"t3_{t}",
                "data": {
                    "id": f"t3_{t}",
                    "title": _sentence(rng, community, False, 4),
                    "selftext": _sentence(rng, community, False, 6),
                    "label": "Neutral",
                    "link_id": f"t3_{t}",
                },
                "images": [image] if image else [],
                "tree": top,
            }
            f.write(json.dumps(tree) + "\n")
    vocab_path = os.path.join(out_dir, "vocab.txt")
    with open(vocab_path, "w") as f:
        f.write("\n".join(_mini_vocab()) + "\n")
    comm_path = os.path.join(out_dir, "communities.json")
    with open(comm_path, "w") as f:
        json.dump(communities, f)
    return {"raw": raw_path, "vocab": vocab_path, "communities": comm_path}


def _write_context_tree(
    f, rng, t: int, community: int, image, marker_repeats: int = 3, star: bool = False, label_by: str = "parent",
) -> None:
    """One raw.json line in a context label mode (see generate_mini_corpus).

    ``marker_repeats``: how many marker tokens a marked body carries.
    ``star``: 1-3 comments, all directly under the submission, so that every
    label depends on the submission's text; otherwise 4-8 comments, each
    under the submission or a random earlier comment."""
    if star:
        n_comments = int(rng.randint(1, 4))
        parents = [-1] * n_comments
    else:
        n_comments = int(rng.randint(4, 9))
        parents = [-1 if (i == 0 or rng.rand() < 0.5) else int(rng.randint(0, i)) for i in range(n_comments)]
    # marker flags are independent coins per node (the submission too)
    sub_marker = bool(rng.rand() < 0.4)
    markers = [bool(rng.rand() < 0.4) for _ in range(n_comments)]

    def body_for(marker: bool) -> str:
        # length-matched: unmarked bodies append as many neutral filler
        # words, so that the attention mask's length does not leak the label
        text = _sentence(rng, community, False)
        pool = MARKER_WORDS if marker else NEUTRAL_WORDS
        text += "".join(" " + str(rng.choice(pool)) for _ in range(marker_repeats))
        return text

    nodes = []
    for c in range(n_comments):
        parent_marker = sub_marker if parents[c] == -1 else markers[parents[c]]
        label_flag = {"self": markers[c], "parent": parent_marker, "self_or_parent": markers[c] or parent_marker}[label_by]
        label = "DEG" if label_flag else ("lti_normal" if rng.rand() < 0.8 else "NA")
        nodes.append(
            {
                "id": f"c{t}_{c}",
                "data": {
                    "id": f"c{t}_{c}",
                    "body": body_for(markers[c]),
                    "label": label,
                    "parent_id": f"t3_{t}",
                    "link_id": f"t3_{t}",
                },
                "images": [],
                "tree": [],
            }
        )
    top: List[dict] = []
    for c, p in enumerate(parents):
        if p == -1:
            top.append(nodes[c])
        else:
            nodes[c]["data"]["parent_id"] = nodes[p]["id"]
            nodes[p]["tree"].append(nodes[c])
    tree = {
        "id": f"t3_{t}",
        "data": {
            "id": f"t3_{t}",
            "title": _sentence(rng, community, False, 4),
            "selftext": body_for(sub_marker),
            "label": "NA",  # unlabelled: its marker predicts its children
            "link_id": f"t3_{t}",
        },
        "images": [image] if image else [],
        "tree": top,
    }
    f.write(json.dumps(tree) + "\n")


def build_contrastive_items(
    raw_path: str, communities: List[int], tokenizer, max_length: int, image_root: str, image_size: int,
):
    """One contrastive GraphItem per discussion, in memory: y = community
    id, hard_y = the polar-opposite community."""
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.ingest import tree_to_items

    items = []
    with open(raw_path) as f:
        for t, line in enumerate(f):
            per_label = tree_to_items(json.loads(line), tokenizer, image_root=image_root, max_length=max_length,
                                      start_idx=t, image_size=image_size)
            if not per_label:
                continue
            items.append(dataclasses.replace(
                per_label[0], idx=t, y=np.asarray([communities[t]], np.int64), y_mask=None,
                hard_y=np.asarray([POLAR[communities[t]]], np.int64),
            ))
    return items


class ContrastiveNpzLoader:
    """A picklable lazy contrastive item: one ingested graph copy relabelled
    for the contrastive task (y = community id, hard_y = polar opposite,
    y_mask dropped), loaded at collate time only."""

    __slots__ = ("path", "idx", "community", "hard")

    def __init__(self, path: str, idx: int, community: int, hard: int):
        self.path = path
        self.idx = idx
        self.community = community
        self.hard = hard

    def __call__(self):
        from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset import load_graph_npz

        return dataclasses.replace(
            load_graph_npz(self.path), idx=self.idx, y=np.asarray([self.community], np.int64), y_mask=None,
            hard_y=np.asarray([self.hard], np.int64),
        )

    def text_length(self) -> int:
        from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset import NpzItemLoader

        return NpzItemLoader(self.path).text_length()


def contrastive_dataset_from_ingest(data_root: str, communities: List[int], seed: int = 0):
    """The stage-1 corpus: one lazy contrastive item per source tree, over
    the ingested npz graphs (``tree-map.txt``), with nothing re-tokenized."""
    from multimodaldiscussiontransformer_tpu_torch.data.dataset import DiscussionDataset

    items = []
    with open(os.path.join(data_root, "tree-map.txt")) as f:
        for line in f:
            g, k0, n = (int(x) for x in line.split())
            if n == 0:
                continue  # the tree contributed no labelled copies
            c = int(communities[g])
            items.append(ContrastiveNpzLoader(os.path.join(data_root, "processed", f"graph-{k0}.npz"), g, c, POLAR[c]))
    return DiscussionDataset.from_splits(items, seed=seed)


class _VocabEnv:
    """``$MDT_BERT_VOCAB`` set to ``path`` inside the block (the ingest's
    tokenizer reads it), the caller's value restored after."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        self.prev = os.environ.get("MDT_BERT_VOCAB")
        os.environ["MDT_BERT_VOCAB"] = self.path
        return self

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop("MDT_BERT_VOCAB", None)
        else:
            os.environ["MDT_BERT_VOCAB"] = self.prev


def run(
    out: str,
    n_trees: int = 200,
    seed: int = 0,
    stage1_updates: int = 30,
    stage2_updates: int = 120,
    max_length: int = 24,
    min_f1: Optional[float] = None,
    dp_size: int = 1,
    device: str = "cuda",
    image_format: str = "png",
) -> Dict[str, float]:
    """The whole rehearsal (module docstring) on ``device``; the test
    metrics, also printed as one ``[two_stage] TEST {...}`` line."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core import registry
    from multimodaldiscussiontransformer_tpu_torch.core.config import (
        BertTowerConfig,
        DataConfig,
        OptimConfig,
        TaskConfig,
        TrainConfig,
        ViTTowerConfig,
        tiny_model_config,
    )
    from multimodaldiscussiontransformer_tpu_torch.data.tokenizer import BertWordPieceTokenizer
    from multimodaldiscussiontransformer_tpu_torch.data_prep.splits import make_splits
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset import (
        create_hatespeech_dataset,
    )
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.ingest import process
    from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import Checkpointer, reset_classifier_head

    registry.populate()
    image_px = 32

    # 1. corpus
    paths = generate_mini_corpus(out, n_trees=n_trees, seed=seed, image_px=image_px, image_format=image_format)
    with open(paths["communities"]) as f:
        communities = json.load(f)
    with _VocabEnv(paths["vocab"]):
        tokenizer = BertWordPieceTokenizer(paths["vocab"])
        print(f"[two_stage] corpus: {n_trees} trees, vocab {tokenizer.vocab_size}")
        # 2. splits (stratified by hate presence)
        split_dir = os.path.join(out, "splits")
        make_splits(paths["raw"], split_dir, n_splits=1, seed=seed)
        # 3. ingest
        data_root = os.path.join(out, "data")
        n_copies = process(
            paths["raw"], data_root, train_idx_file=os.path.join(split_dir, "train-idx.txt"),
            test_idx_file=os.path.join(split_dir, "test-idx.txt"),
            tokenizer_name="bert-base-uncased",  # the WordPiece over $MDT_BERT_VOCAB
            image_root=out, max_length=max_length, image_size=image_px, log_every=0,
        )
    print(f"[two_stage] ingested {n_copies} graph copies")

    # the rehearsal's small geometry: towers of hidden 64, 4 layers, 4 heads
    model_cfg = tiny_model_config().replace(
        text_tower=BertTowerConfig(vocab_size=tokenizer.vocab_size, hidden_size=64, num_hidden_layers=4,
                                   num_attention_heads=4, intermediate_size=128,
                                   max_position_embeddings=max(64, max_length)),
        image_tower=ViTTowerConfig(image_size=image_px, patch_size=16, hidden_size=64, num_hidden_layers=4,
                                   num_attention_heads=4, intermediate_size=128),
    )
    img_shape = (3, image_px, image_px)
    data_cfg = DataConfig(
        batch_size=8, max_text_len=max_length, text_len_buckets=(max_length,), node_buckets=(8, 16),
        node_capacity_buckets=(64, 128, 256), image_capacity_buckets=(0, 8, 16, 32),
        label_capacity_buckets=(16, 32, 64, 128),
    )

    # 4. stage 1: contrastive pre-training over the lazy per-tree corpus
    contr_ds = contrastive_dataset_from_ingest(data_root, communities, seed=seed)
    cfg1 = TrainConfig(
        model=model_cfg, data=data_cfg,
        optim=OptimConfig(lr=1e-3, warmup_updates=5, total_num_update=max(stage1_updates, 1), update_freq=1),
        task_cfg=TaskConfig(dataset_name="hateful_discussions", seed=seed),
        task="contrastive_learning", criterion="contrastive_loss", save_dir=os.path.join(out, "stage1"),
        log_interval=10, validate_interval_updates=0, dp_size=dp_size, tp_size=1,
    )
    trainer1 = registry.TASKS.get("contrastive_learning")(cfg1).build_trainer(image_shape=img_shape, device=device)
    state1 = trainer1.fit(contr_ds, max_epoch=1000, max_updates=stage1_updates)
    ckpt1 = Checkpointer(cfg1.save_dir)
    ckpt1.save(state1, int(state1.step))
    ckpt1.wait()
    print(f"[two_stage] stage 1 done @ {int(state1.step)} microsteps")

    # 5. transfer: restore the params, reset the head and the optimizer
    ds2 = create_hatespeech_dataset(root=data_root, seed=seed)
    cfg2 = TrainConfig(
        model=model_cfg, data=data_cfg,
        optim=OptimConfig(lr=1e-3, warmup_updates=10, total_num_update=max(stage2_updates, 1), update_freq=1),
        task_cfg=TaskConfig(dataset_name="hateful_discussions", seed=seed),
        task="node_prediction", criterion="node_cross_entropy",
        positive_weight=1.5,  # run_train.sh:41
        save_dir=os.path.join(out, "stage2"), log_interval=20, validate_interval_updates=0,
        dp_size=dp_size, tp_size=1,
    )
    trainer2 = registry.TASKS.get("node_prediction")(cfg2).build_trainer(image_shape=img_shape, device=device)
    state2 = trainer2.init_state()
    restored = ckpt1.restore()
    ckpt1.close()
    params = reset_classifier_head(restored["params"], torch.Generator().manual_seed(seed + 17))
    state2 = trainer2.load_params(state2, params)  # the --reset-optimizer path
    print("[two_stage] transferred stage-1 params (head + optimizer reset)")

    # 6. fine-tune + test
    state2 = trainer2.fit(ds2, state=state2, max_epoch=1000, max_updates=stage2_updates)
    metrics = trainer2.evaluate(state2, ds2, "test")
    result = {
        "stage1_updates": stage1_updates,
        "stage2_updates": stage2_updates,
        "n_trees": n_trees,
        **{k: round(float(v), 4) for k, v in metrics.items()},
    }
    print("[two_stage] TEST " + json.dumps(result))
    if min_f1 is not None and result.get("f1", 0.0) < min_f1:
        raise SystemExit(f"two_stage F1 {result.get('f1')} below required {min_f1}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="two-stage mini-corpus rehearsal")
    p.add_argument("--out", required=True)
    p.add_argument("--n-trees", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stage1-updates", type=int, default=30)
    p.add_argument("--stage2-updates", type=int, default=120)
    p.add_argument("--max-length", type=int, default=24)
    p.add_argument("--min-f1", type=float, default=None)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--image-format", choices=IMAGE_FORMATS, default="png",
                   help="root images as PNG (PIL, JAX's files) or as .npy arrays (no PIL)")
    a = p.parse_args(argv)
    run(a.out, n_trees=a.n_trees, seed=a.seed, stage1_updates=a.stage1_updates, stage2_updates=a.stage2_updates,
        max_length=a.max_length, min_f1=a.min_f1, dp_size=a.dp, device=a.device, image_format=a.image_format)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
