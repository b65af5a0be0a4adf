"""A seeded raw corpus in the reference's ``pruned-with-images.json`` schema,
and a WordPiece ``vocab.txt`` built from it, for driving the offline
pipeline (``data_prep/``, the ingest CLI, ``data/tokenizer.py``) without the
Pushshift data or a ``bert-base-uncased`` vocab.

One JSON line per discussion (``{"id", "data", "images", "tree"}``, as
hateful_discussions.py:107-232 reads it): a submission (title, selftext or
body) and nested comments (body, ``parent_id``, ``link_id``), a share of
them labelled with the reference's hate / normal labels, the rest "NA".
Bodies carry bare URLs, whole-body markdown links, "[deleted]" bodies (one
with a later duplicate of its id), repeated bot text, and now and then an
unknown word. A share of the comments carries one image: a path under
``image_root`` to one of ``image_pool`` distinct images (reposts: written
once each), as ``.npy`` (an (H, W, 3) uint8 array, which the port's ingest
reads without PIL) or ``.png``; a few image paths are missing, so
ingestion drops and counts them.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

HATE_LABELS = ("DEG", "lti_hate", "IdentityDirectedAbuse", "AffiliationDirectedAbuse")
GOOD_LABELS = ("Neutral", "lti_normal", "NDG", "HOM")
BOT_TEXT = "I am a bot, and this action was performed automatically. Please contact the moderators."
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
_SYLLABLES = ("ka", "lo", "mi", "ne", "ru", "ta", "vo", "shi", "qua", "ber", "dex", "pol", "zan", "fi", "gor", "el")


def _words(rng: np.random.Generator, n: int) -> List[str]:
    out = set()
    while len(out) < n:
        out.add("".join(rng.choice(_SYLLABLES, size=int(rng.integers(1, 4)))))
    return sorted(out)


def _image(rng: np.random.Generator, size: int) -> np.ndarray:
    """A (size, size, 3) uint8 image: a 7x7 grid of random colours, blown
    up."""
    cells = rng.integers(0, 256, size=(7, 7, 3), dtype=np.uint8)
    step = -(-size // 7)
    return cells.repeat(step, 0).repeat(step, 1)[:size, :size]


def _save_image(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.endswith(".npy"):
        np.save(path, arr)
    else:
        from PIL import Image

        Image.fromarray(arr).save(path)


def synthetic_raw_corpus(
    json_path: str,
    image_root: str,
    num_trees: int = 240,
    comments: Tuple[int, int] = (8, 32),
    big_trees: int = 4,
    big_comments: Tuple[int, int] = (520, 600),
    image_prob: float = 0.25,
    label_prob: float = 0.3,
    big_label_prob: float = 0.01,
    image_format: str = "npy",
    image_size: int = 224,
    image_pool: int = 128,
    seed: int = 0,
) -> Dict[str, int]:
    """Write ``num_trees`` discussions of ``comments`` comments (inclusive
    range) and ``big_trees`` of ``big_comments`` to ``json_path``, and their
    images under ``image_root``; returns counts. A comment is labelled with
    ``label_prob`` (``big_label_prob`` in the big discussions, whose every
    labelled node becomes a graph copy of the whole tree)."""
    rng = np.random.default_rng(seed)
    vocab_words = _words(rng, 400)
    counts = Counter()
    pool = [os.path.join("images", "pool", f"img-{k}.{image_format}") for k in range(image_pool)]
    for rel in pool:
        _save_image(os.path.join(image_root, rel), _image(rng, image_size))

    def text(lo: int, hi: int) -> str:
        words = list(rng.choice(vocab_words, size=int(rng.integers(lo, hi + 1))))
        if rng.random() < 0.15:
            words.insert(int(rng.integers(0, len(words) + 1)), f"https://www.example.com/{words[0]}?id={int(rng.integers(1000))}")
        if rng.random() < 0.1:
            words.append("Ünïcödé" if rng.random() < 0.5 else "zzqxj")
        if rng.random() < 0.3:
            words[-1] += str(rng.choice([".", "!", "?", ","]))
        return " ".join(words)

    def body() -> str:
        r = rng.random()
        if r < 0.05:
            return "[deleted]"
        if r < 0.10:
            return BOT_TEXT
        if r < 0.13:
            return f"[{' '.join(rng.choice(vocab_words, size=2))}](https://foo.example.org/{rng.choice(vocab_words)})"
        return text(3, 40)

    def label(p: float) -> str:
        if rng.random() >= p:
            return "NA"
        return str(rng.choice(HATE_LABELS if rng.random() < 0.4 else GOOD_LABELS))

    with open(json_path, "w") as out:
        sizes = [int(rng.integers(comments[0], comments[1] + 1)) for _ in range(num_trees)]
        sizes += [int(rng.integers(big_comments[0], big_comments[1] + 1)) for _ in range(big_trees)]
        for t, n in enumerate(sizes):
            link = f"t{t:04d}"
            p = label_prob if t < num_trees else big_label_prob
            data = {"id": link, "title": text(2, 12), "label": label(p)}
            if rng.random() < 0.7:
                data["selftext"] = "" if rng.random() < 0.2 else text(5, 60)
            else:
                data["body"] = "NA" if rng.random() < 0.5 else text(5, 30)
            root = {"id": link, "data": data, "images": [], "tree": []}
            nodes = [root]
            for c in range(n):
                parent = nodes[int(rng.integers(0, len(nodes)))]
                cid = f"{link}c{c}"
                node = {"id": cid, "images": [], "tree": [],
                        "data": {"id": cid, "body": body(), "label": label(p), "parent_id": f"t1_{parent['id']}",
                                 "link_id": f"t3_{link}"}}
                if rng.random() < image_prob:
                    if rng.random() < 0.02:  # a path whose file was never written
                        node["images"] = [os.path.join("images", link, f"{cid}-0.{image_format}")]
                        counts["missing_images"] += 1
                    else:
                        node["images"] = [pool[int(rng.integers(0, image_pool))]]
                        counts["images"] += 1
                parent["tree"].append(node)
                nodes.append(node)
                if node["data"]["body"] == "[deleted]" and rng.random() < 0.5:
                    # the same comment again with its text: ingestion keeps this copy
                    again = dict(node, tree=[], data=dict(node["data"], body=text(3, 20)))
                    parent["tree"].append(again)
                    counts["duplicated_ids"] += 1
            counts["trees"] += 1
            counts["comments"] += n
            out.write(json.dumps(root) + "\n")
    return dict(counts)


def build_vocab(json_path: str, vocab_path: str, held_out_every: int = 9) -> int:
    """A WordPiece ``vocab.txt`` from the corpus' own words: the specials,
    every punctuation character and word of its texts (lower-cased, accents
    stripped, as ``BasicTokenizer`` splits them), except every
    ``held_out_every``-th word, which enters as a three-letter head and a
    ``##`` tail instead (so WordPiece splits it), and words of 5+ characters
    ending in "j", left out ([UNK]). Returns the vocab size."""
    from multimodaldiscussiontransformer_tpu_torch.data.tokenizer import BasicTokenizer
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.ingest import extract_text

    basic = BasicTokenizer()
    counts: Counter = Counter()

    def visit(node: dict) -> None:
        counts.update(basic.tokenize(extract_text(node["data"])))
        for child in node.get("tree", []):
            visit(child)

    with open(json_path) as f:
        for line in f:
            if line.strip():
                visit(json.loads(line))
    vocab: List[str] = list(SPECIALS)
    seen = set(vocab)
    for i, word in enumerate(sorted(counts, key=lambda w: (-counts[w], w))):
        if len(word) >= 5 and word.endswith("j"):
            continue
        pieces = [word[:3], "##" + word[3:]] if i % held_out_every == held_out_every - 1 and len(word) > 3 else [word]
        for piece in pieces:
            if piece not in seen:
                seen.add(piece)
                vocab.append(piece)
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return len(vocab)

