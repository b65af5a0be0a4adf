"""Does the graph path earn its keep? The port's copy of the JAX package's
``experiments/hateful_discussions/context_ablation.py``.

Train on a corpus where part of the label signal lives only in the
discussion tree, and ablate the tree away:

1. ``two_stage.generate_mini_corpus(label_mode="context_or")``: a comment
   is hate iff its OWN text or its PARENT's text carries a marker word
   (markers are independent coins per node, bodies are length-matched).
   The parent-only positives are undecidable from the comment alone, so a
   context-blind classifier has an F1 ceiling below 1;
2. FULL: the standard mDT trained with the node-prediction recipe -> F1;
3. CONTEXT-BLIND: the same architecture and recipe on the same labelled
   nodes, each re-packed as a single-node tree -> F1.

The full-vs-blind margin is the trained-model evidence that the fusion and
graph layers learn from tree context. ``rule="parent"`` keeps the strict
variant (label = parent marker only). ``contrastive_updates`` and
``pretrain_updates`` warm-start both arms from a contrastive stage and a
supervised marker stage (``label_mode="marker"``); weights pass between
stages as state dicts.

Run: ``python -m multimodaldiscussiontransformer_tpu_torch.experiments.\
hateful_discussions.context_ablation --out DIR`` (on the card; ``--device
cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.data.preprocess import GraphItem, preprocess_item
from multimodaldiscussiontransformer_tpu_torch.data.trees import tree_distance_pairs


def context_blind_items(ds, image_shape=(3, 32, 32)) -> List[GraphItem]:
    """Every graph copy re-packed as a single-node tree holding only its
    labelled node (same tokens, same label, no context)."""
    items = []
    for i in range(len(ds)):
        it = ds.get(i)
        assert it.y_mask is not None and it.y_mask.any()
        node = int(np.flatnonzero(it.y_mask)[0])
        items.append(
            preprocess_item(
                idx=it.idx,
                tokens={
                    "input_ids": it.input_ids[node : node + 1],
                    "token_type_ids": it.token_type_ids[node : node + 1],
                    "attention_mask": it.attention_mask[node : node + 1],
                },
                edge_index=np.zeros((2, 0), np.int64),
                distance_pairs=tree_distance_pairs(np.asarray([-1], np.int64)),
                x_images=np.zeros((0,) + tuple(image_shape), np.float32),
                x_image_index=np.zeros(1, bool),
                y=np.asarray(it.y).reshape(-1),
                y_mask=np.asarray([True]),
            )
        )
    return items


def _train_eval(ds, model_cfg, data_cfg, updates, seed, img_shape, lr: float = 1e-3, positive_weight: float = 1.0,
                constant_lr: bool = True, warm_params=None, return_state: bool = False, device: str = "cuda"):
    """Node-prediction training of ``updates`` updates (from ``warm_params``,
    a state dict, with the optimizer reset) and the test metrics."""
    from multimodaldiscussiontransformer_tpu_torch.core.config import OptimConfig, TaskConfig, TrainConfig
    from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(
        model=model_cfg,
        data=data_cfg,
        optim=OptimConfig(
            lr=lr, warmup_updates=10,
            # constant_lr holds the lr at its peak (end == peak): learning an
            # embedding from scratch needs full-size steps late in training
            end_learning_rate=lr if constant_lr else 3e-7,
            total_num_update=max(updates, 1), update_freq=1,
        ),
        task_cfg=TaskConfig(dataset_name="hateful_discussions", seed=seed),
        task="node_prediction",
        criterion="node_cross_entropy",
        # 1.0, not the recipe's 1.5: a capability probe, and up-weighting
        # positives deepens the all-positive basin
        positive_weight=positive_weight,
        log_interval=50,
        validate_interval_updates=0,
        dp_size=1,
        tp_size=1,
        fast_dropout_rng=False,
    )
    trainer = Trainer(cfg, image_shape=img_shape, device=device)
    state = None
    if warm_params is not None:
        # the reference's transfer (run_train.sh:57-63): both arms start
        # from the same weights with the optimizer reset
        state = trainer.load_params(trainer.init_state(), warm_params)
    state = trainer.fit(ds, state=state, max_epoch=100000, max_updates=updates)
    metrics = trainer.evaluate(state, ds, "test")
    if return_state:
        return metrics, state
    return metrics


def _host_params(state) -> Dict[str, "torch.Tensor"]:
    """A trained state's whole weights as CPU tensors (a state dict)."""
    return {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}


def _rounded(metrics: Dict[str, float]) -> str:
    return json.dumps({k: round(float(v), 4) for k, v in metrics.items()})


def run(
    out: str,
    n_trees: int = 300,
    seed: int = 0,
    updates: int = 3000,
    max_length: int = 24,
    min_margin: Optional[float] = None,
    lr: float = 1e-3,
    positive_weight: float = 1.0,
    constant_lr: bool = True,
    marker_repeats: int = 3,
    contrastive_updates: int = 0,
    pretrain_updates: int = 0,
    arms: str = "both",
    rule: str = "or",
    star: bool = True,
    device: str = "cuda",
) -> Dict[str, float]:
    """The ablation (module docstring) on ``device``: the result dict, also
    printed as one ``[context_ablation] RESULT {...}`` line.

    ``contrastive_updates``: a contrastive pre-training before both arms;
    ``pretrain_updates``: a supervised marker stage A (its own corpus, seed
    + 1, head kept); ``arms``: "both" or "full"; ``rule``: "or"
    (``label_mode="context_or"``) or "parent" ("context"); ``star``: 1-3
    comments under the submission (else 4-8-comment trees)."""
    import torch

    from multimodaldiscussiontransformer_tpu_torch.core import registry
    from multimodaldiscussiontransformer_tpu_torch.core.config import BertTowerConfig, DataConfig, tiny_model_config
    from multimodaldiscussiontransformer_tpu_torch.data.dataset import DiscussionDataset
    from multimodaldiscussiontransformer_tpu_torch.data.tokenizer import BertWordPieceTokenizer
    from multimodaldiscussiontransformer_tpu_torch.data_prep.splits import make_splits
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset import (
        create_hatespeech_dataset,
    )
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.ingest import process
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.two_stage import (
        _VocabEnv,
        generate_mini_corpus,
    )

    registry.populate()
    image_px = 32
    img_shape = (3, image_px, image_px)

    def ingest(corpus_dir: str, raw: str):
        split_dir = os.path.join(corpus_dir, "splits")
        make_splits(raw, split_dir, n_splits=1, seed=seed)
        root = os.path.join(corpus_dir, "data")
        n = process(raw, root, train_idx_file=os.path.join(split_dir, "train-idx.txt"),
                    test_idx_file=os.path.join(split_dir, "test-idx.txt"),
                    tokenizer_name="bert-base-uncased",  # the WordPiece over $MDT_BERT_VOCAB
                    image_root=corpus_dir, max_length=max_length, image_size=image_px, log_every=0)
        return root, n

    paths = generate_mini_corpus(out, n_trees=n_trees, seed=seed, image_px=image_px, image_prob=0.0,
                                 label_mode="context_or" if rule == "or" else "context",
                                 marker_repeats=marker_repeats, context_star=star)
    tv = dict(lr=lr, positive_weight=positive_weight, constant_lr=constant_lr, device=device)
    with _VocabEnv(paths["vocab"]):
        tokenizer = BertWordPieceTokenizer(paths["vocab"])
        data_root, n_copies = ingest(out, paths["raw"])
        print(f"[context_ablation] ingested {n_copies} labeled-node copies")
        ds = create_hatespeech_dataset(root=data_root, seed=seed)
        # the corpus is small: both arms train from items held in memory
        # (the blind arm's are built there), so that their input costs alike
        ds = DiscussionDataset(items=[ds.get(i) for i in range(len(ds))], train_idx=ds.train_idx,
                               valid_idx=ds.valid_idx, test_idx=ds.test_idx)
        blind = DiscussionDataset(items=context_blind_items(ds, img_shape), train_idx=ds.train_idx,
                                  valid_idx=ds.valid_idx, test_idx=ds.test_idx)
        # the capability probe's geometry: no image tower, unfrozen towers of
        # hidden 64 without dropout (no pretrained tower here), 4 fusion
        # layers (3 graph hops, two of them text-aware: with fewer, parent
        # text cannot reach a child's prediction), 4 bottleneck tokens,
        # graph stack 2
        model_cfg = tiny_model_config().replace(
            use_image_tower=False, freeze_initial_encoders=False, num_fusion_layers=4, num_bottleneck_tokens=4,
            num_graph_stack=2,
            text_tower=BertTowerConfig(
                vocab_size=tokenizer.vocab_size, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                intermediate_size=128, max_position_embeddings=max(64, max_length),
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            ),
        )
        data_cfg = DataConfig(batch_size=8, max_text_len=max_length, text_len_buckets=(max_length,),
                              node_buckets=(16,), node_capacity_buckets=(128,), image_capacity_buckets=(0,),
                              label_capacity_buckets=(64,))

        warm = None
        if contrastive_updates > 0:
            from multimodaldiscussiontransformer_tpu_torch.core.config import OptimConfig, TaskConfig, TrainConfig
            from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.two_stage import (
                build_contrastive_items,
            )
            from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import reset_classifier_head

            with open(paths["communities"]) as f:
                communities = json.load(f)
            contr_items = build_contrastive_items(paths["raw"], communities, tokenizer, max_length, out, image_px)
            contr_ds = DiscussionDataset.from_splits(contr_items, seed=seed)
            cfg1 = TrainConfig(
                model=model_cfg, data=data_cfg,
                optim=OptimConfig(lr=1e-3, warmup_updates=5, total_num_update=max(contrastive_updates, 1),
                                  update_freq=1),
                task_cfg=TaskConfig(dataset_name="hateful_discussions", seed=seed),
                task="contrastive_learning", criterion="contrastive_loss", log_interval=100,
                validate_interval_updates=0, dp_size=1, tp_size=1, fast_dropout_rng=False,
            )
            trainer1 = registry.TASKS.get("contrastive_learning")(cfg1).build_trainer(image_shape=img_shape,
                                                                                       device=device)
            state1 = trainer1.fit(contr_ds, max_epoch=100000, max_updates=contrastive_updates)
            warm = reset_classifier_head(_host_params(state1), torch.Generator().manual_seed(seed + 17))
            del state1
            print(f"[context_ablation] contrastive warm-start done ({contrastive_updates} updates)")

        pre = {}
        if pretrain_updates > 0:
            # stage A: supervised marker detection (label = OWN marker) on a
            # disjoint corpus with the same distributions and vocab; the head
            # is kept through the transfer
            pre_dir = os.path.join(out, "pretrain")
            pre_paths = generate_mini_corpus(pre_dir, n_trees=n_trees, seed=seed + 1, image_px=image_px,
                                             image_prob=0.0, label_mode="marker", marker_repeats=marker_repeats,
                                             context_star=star)
            pre_root, _ = ingest(pre_dir, pre_paths["raw"])
            pre_ds = create_hatespeech_dataset(root=pre_root, seed=seed)
            pre, pre_state = _train_eval(pre_ds, model_cfg, data_cfg, pretrain_updates, seed, img_shape,
                                         warm_params=warm, return_state=True, **tv)
            warm = _host_params(pre_state)
            del pre_state
            print(f"[context_ablation] STAGE-A marker pretrain ({pretrain_updates} updates) test " + _rounded(pre))

    full = _train_eval(ds, model_cfg, data_cfg, updates, seed, img_shape, warm_params=warm, **tv)
    print(f"[context_ablation] FULL  {_rounded(full)}")
    blind_m = {}
    if arms != "full":
        blind_m = _train_eval(blind, model_cfg, data_cfg, updates, seed, img_shape, warm_params=warm, **tv)
        print(f"[context_ablation] BLIND {_rounded(blind_m)}")

    result = {
        "n_trees": n_trees,
        "updates": updates,
        "f1_pretrain": round(float(pre.get("f1", 0.0)), 4),
        "f1_full": round(float(full.get("f1", 0.0)), 4),
        "f1_context_blind": round(float(blind_m.get("f1", 0.0)), 4),
        "accuracy_full": round(float(full.get("accuracy", 0.0)), 4),
        "accuracy_context_blind": round(float(blind_m.get("accuracy", 0.0)), 4),
        "margin": round(float(full.get("f1", 0.0)) - float(blind_m.get("f1", 0.0)), 4),
    }
    print("[context_ablation] RESULT " + json.dumps(result))
    if min_margin is not None and result["margin"] < min_margin:
        raise SystemExit(f"context margin {result['margin']} below required {min_margin}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="graph-context capability ablation")
    p.add_argument("--out", required=True)
    p.add_argument("--n-trees", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--updates", type=int, default=3000)
    p.add_argument("--max-length", type=int, default=24)
    p.add_argument("--min-margin", type=float, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--positive-weight", type=float, default=1.0)
    p.add_argument("--decay-lr", action="store_true", default=False)
    p.add_argument("--marker-repeats", type=int, default=3)
    p.add_argument("--contrastive-updates", type=int, default=0)
    p.add_argument("--pretrain-updates", type=int, default=0)
    p.add_argument("--arms", choices=("both", "full"), default="both")
    p.add_argument("--rule", choices=("or", "parent"), default="or")
    p.add_argument("--deep", action="store_true", default=False,
                   help="deep corpus (ancestor rule in 4-8-comment trees) instead of the default star corpus")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    run(a.out, n_trees=a.n_trees, seed=a.seed, updates=a.updates, max_length=a.max_length, min_margin=a.min_margin,
        lr=a.lr, positive_weight=a.positive_weight, constant_lr=not a.decay_lr, marker_repeats=a.marker_repeats,
        contrastive_updates=a.contrastive_updates, pretrain_updates=a.pretrain_updates, arms=a.arms, rule=a.rule,
        star=not a.deep, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
