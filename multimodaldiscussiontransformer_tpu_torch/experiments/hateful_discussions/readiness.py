"""Real-data readiness gate: validate the assets, then run a tiny end-to-end
smoke. The port's copy of the JAX package's
``experiments/hateful_discussions/readiness.py``.

The published F1 run waits only on external assets: the Pushshift-derived
``pruned-with-images*.json`` corpus, the bert-base-uncased ``vocab.txt`` and
the HF tower checkpoints. This gate makes the real run one command the day
the assets exist:

    python -m multimodaldiscussiontransformer_tpu_torch.experiments.\
hateful_discussions.readiness --assets DIR --out OUT

It checks each asset, prints a verdict per check and, when the required
assets are there, ingests the first ``--smoke-trees`` trees and trains and
evaluates a few updates through the port's ``Trainer`` (on the card;
``--device cpu`` for the CPU).

Asset layout under ``--assets DIR`` (each overridable by a flag):
- ``vocab.txt``                       bert-base-uncased WordPiece vocab
- ``pruned-with-images*.json``        raw discussion trees (one per line)
- ``images/``                         the image root the trees refer to
- ``bert-base-uncased/``              (optional) local HF text checkpoint
- ``vit-base-patch16-224/``           (optional) local HF image checkpoint

Exit code 0 iff every REQUIRED check passes (vocab, trees, smoke). The HF
checkpoints are optional: the smoke runs random-init towers. Their check
resolves each as ``--hf-init`` does (a directory, or a name in the HF
cache; ``--text-ckpt bert-base-uncased``), without ``transformers``: ok
when a config and weights are found, else not ok, naming what is missing.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
from typing import Dict, Optional


def _check(ok: bool, detail: str) -> Dict[str, object]:
    return {"ok": bool(ok), "detail": detail}


def check_vocab(path: Optional[str]) -> Dict[str, object]:
    if not path or not os.path.exists(path):
        return _check(False, f"vocab.txt not found ({path})")
    with open(path, encoding="utf-8") as f:
        tokens = [ln.rstrip("\n") for ln in f if ln.strip()]
    specials = {"[PAD]", "[UNK]", "[CLS]", "[SEP]"}
    missing = specials - set(tokens[:1000])
    if missing:
        return _check(False, f"{path}: missing special tokens {sorted(missing)}")
    # bert-base-uncased has 30,522 entries; a small vocab passes, flagged
    note = "" if len(tokens) >= 1000 else f" (small vocab: {len(tokens)})"
    return _check(True, f"{len(tokens)} tokens{note}")


def check_trees(path: Optional[str]) -> Dict[str, object]:
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.ingest import collapse_tree

    if not path:
        return _check(False, "no pruned-with-images*.json found")
    try:
        n_ok = 0
        with open(path) as f:
            for i, line in enumerate(f):
                if i >= 3:
                    break
                tree = json.loads(line)
                for key in ("id", "tree"):
                    if key not in tree:
                        return _check(False, f"{path} line {i}: missing key {key!r} "
                                             "(expected the reference schema {id, data, images, tree})")
                ids, _, _ = collapse_tree(tree)
                if not ids:
                    return _check(False, f"{path} line {i}: empty tree")
                n_ok += 1
        return _check(n_ok > 0, f"{path}: first {n_ok} trees parse + collapse")
    except (json.JSONDecodeError, KeyError, ValueError) as e:
        return _check(False, f"{path}: {e!r}")


def check_hf_checkpoint(path_or_name: str, kind: str) -> Dict[str, object]:
    """A loadable local HF checkpoint (no network): a directory, or a name
    in the HF cache, with a ``config.json`` and weights, resolved as
    ``--hf-init`` resolves it (``utils/hf_import.py``, no
    ``transformers``). Optional: random-init towers still smoke-test the
    pipeline; the real run wants --hf-init."""
    from multimodaldiscussiontransformer_tpu_torch.utils.hf_import import check_pretrained

    try:
        return _check(True, check_pretrained(path_or_name))
    except (OSError, ValueError) as e:
        return _check(False, f"{kind} checkpoint unavailable: {str(e)[:300]}")


def check_images(root: Optional[str], trees_path: Optional[str]) -> Dict[str, object]:
    """Resolve the first trees' image paths against ``root`` (the directory
    that tree-relative paths like ``images/img4.png`` resolve from)."""
    if not root or not os.path.isdir(root):
        return _check(False, f"image root not found ({root}); image-bearing nodes would "
                             "be dropped loudly at ingest (IngestStats)")
    refs, found = 0, 0
    if trees_path and os.path.exists(trees_path):
        with open(trees_path) as f:
            for i, line in enumerate(f):
                if i >= 5 or refs >= 20:
                    break
                try:
                    tree = json.loads(line)
                except json.JSONDecodeError:
                    continue
                stack = [tree]
                while stack:
                    node = stack.pop()
                    for img in node.get("images", []) or []:
                        refs += 1
                        if os.path.exists(os.path.join(root, img)):
                            found += 1
                    stack.extend(node.get("tree", []) or [])
    if refs == 0:
        return _check(True, f"{root}: no image refs in the first trees")
    return _check(found > 0, f"{root}: {found}/{refs} sampled image paths resolve")


def run_smoke(trees_path: str, vocab_path: str, image_root: str, out_dir: str, n_trees: int, updates: int,
              full_model: bool, device: str = "cuda") -> Dict[str, object]:
    """Ingest the first ``n_trees`` trees and train and evaluate a few
    updates end to end (tokenizer -> distances -> npz -> lazy dataset ->
    collator -> train step -> eval metrics) on ``device``."""
    os.environ["MDT_BERT_VOCAB"] = vocab_path
    from multimodaldiscussiontransformer_tpu_torch.core.config import (
        BertTowerConfig,
        DataConfig,
        ModelConfig,
        OptimConfig,
        TaskConfig,
        TrainConfig,
        ViTTowerConfig,
        tiny_model_config,
    )
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import ingest
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset import (
        create_hatespeech_dataset,
    )
    from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

    os.makedirs(out_dir, exist_ok=True)
    k = ingest.process(trees_path, out_dir, tokenizer_name="bert-base-uncased", image_root=image_root or "",
                       limit=n_trees, log_every=max(n_trees, 1))
    if k <= 0:
        return _check(False, f"ingest produced {k} graph copies")
    ds = create_hatespeech_dataset(root=out_dir)
    if full_model:
        model = ModelConfig()  # canonical: the real run's geometry
    else:
        # the real ingest's geometry (30,522-token vocab, 100-token text,
        # 224 px / 16 px-patch images) at hidden 64
        model = tiny_model_config().replace(
            text_tower=BertTowerConfig(vocab_size=30522, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                                       intermediate_size=128, max_position_embeddings=128),
            image_tower=ViTTowerConfig(image_size=224, patch_size=16, hidden_size=64, num_hidden_layers=4,
                                       num_attention_heads=4, intermediate_size=128),
        )
    bs = max(1, min(4, len(ds.train_idx)))
    cfg = TrainConfig(
        model=model,
        data=DataConfig(batch_size=bs),
        optim=OptimConfig(update_freq=1, scan_microbatches=False, lr=1e-4),
        task_cfg=TaskConfig(dataset_name="hateful_discussions"),
        fast_dropout_rng=False,
        dp_size=1,
        save_dir=os.path.join(out_dir, "smoke_ckpt"),
        log_interval=1,
        validate_interval_updates=0,
    )
    trainer = Trainer(cfg, device=device)
    state = trainer.fit(ds, max_updates=updates)
    # a smoke ingest without split files may route every copy to train;
    # score whichever eval split has items
    split = "test" if len(ds.test_idx) else "valid"
    if len(ds.test_idx) or len(ds.valid_idx):
        metrics = trainer.evaluate(state, ds, split)
        detail_m = f"{split} metrics {json.dumps(metrics)}"
    else:
        metrics = {}
        detail_m = "no eval split in the smoke slice (all copies -> train)"
    ok = all(v == v for v in metrics.values() if isinstance(v, float))  # no NaNs
    return _check(ok, f"{k} graph copies from {n_trees} trees; {updates} updates; " + detail_m)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="real-data readiness gate (assets + end-to-end smoke)")
    p.add_argument("--assets", required=True, help="asset directory")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "mdt_readiness_smoke"),
                   help="the smoke's ingest and checkpoint directory")
    p.add_argument("--vocab", default=None, help="override vocab.txt path")
    p.add_argument("--trees", default=None, help="override pruned-with-images*.json path")
    p.add_argument("--image-root", default=None)
    p.add_argument("--text-ckpt", default=None,
                   help="local HF text checkpoint dir or cache name (default ASSETS/bert-base-uncased)")
    p.add_argument("--image-ckpt", default=None,
                   help="local HF image checkpoint dir or cache name (default ASSETS/vit-base-patch16-224)")
    p.add_argument("--smoke-trees", type=int, default=10)
    p.add_argument("--smoke-updates", type=int, default=3)
    p.add_argument("--full-model", action="store_true", default=False,
                   help="smoke with the canonical architecture (the default uses a real-vocab tiny model)")
    p.add_argument("--no-smoke", action="store_true", default=False, help="asset checks only")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    assets = os.path.abspath(a.assets)
    vocab = a.vocab or os.path.join(assets, "vocab.txt")
    trees = a.trees
    if trees is None:
        hits = sorted(glob.glob(os.path.join(assets, "pruned-with-images*.json")))
        trees = hits[0] if hits else None
    # tree image paths (e.g. "images/img4.png") resolve from the asset root
    image_root = a.image_root or assets
    text_ckpt = a.text_ckpt or os.path.join(assets, "bert-base-uncased")
    image_ckpt = a.image_ckpt or os.path.join(assets, "vit-base-patch16-224")

    checks = {
        "vocab": check_vocab(vocab),
        "trees": check_trees(trees),
        "images": check_images(image_root, trees),
        "hf_text": check_hf_checkpoint(text_ckpt, "text"),
        "hf_image": check_hf_checkpoint(image_ckpt, "image"),
    }
    required_ok = checks["vocab"]["ok"] and checks["trees"]["ok"]
    if required_ok and not a.no_smoke:
        try:
            checks["smoke"] = run_smoke(trees, vocab, image_root if checks["images"]["ok"] else "", a.out,
                                        a.smoke_trees, a.smoke_updates, a.full_model, a.device)
        except Exception as e:  # the verdict names the failure; the exit code is 1
            checks["smoke"] = _check(False, f"smoke failed: {repr(e)[:400]}")
        required_ok = required_ok and checks["smoke"]["ok"]

    verdict = {
        "ok": required_ok,
        "checks": checks,
        "next": (
            "ready: run the parity recipe (experiments/hateful_discussions/run_train.sh with HF_INIT=1 once "
            "pretrained tower weights are in place)"
            if required_ok
            else "fix the failing required checks (vocab, trees, smoke)"
        ),
    }
    # one line, last on stdout (the smoke's logs precede it)
    print(json.dumps(verdict), flush=True)
    return 0 if required_ok else 1


if __name__ == "__main__":
    sys.exit(main())
