"""Comment-only BERT baseline, per-comment text classification: the port's
copy of the JAX package's ``experiments/comment_only/text_bert.py``.

The reference's baseline runner (Comment-Only Experiments/src/text_bert.py
+ the HF Trainer) fine-tunes a whole BERT sequence classifier on
per-comment parquet splits. Recipe (text_bert.py:31-48,
exp_configs.py:18-29): lr 3e-5, batch 48, 5000 steps, 400 warmup, weight
decay 0.01, evaluation every 500 steps, the best accuracy kept, metrics
accuracy/precision/recall/F1/AUC (numpy math equal to the sklearn of
utils.py:10-23), predictions saved to ``predictions.parquet``.

As in JAX:
- AdamW is optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, weight decay on
  every parameter) over the schedule ``lr(count)``: linear warmup from 0,
  then linear decay to 0 at ``max_steps``, where ``count`` is the number of
  updates already applied (0 on the first, which therefore moves nothing);
- the batch order is ``np.random.RandomState(seed).permutation``, drawn
  anew when an epoch's remainder is shorter than a batch;
- ``predict_all`` pads the last batch with its last row and trims.
The dropout bits come from ``torch.Generator``s seeded with ``seed`` (JAX:
``jax.random``): the same rates, other masks. pandas and pyarrow serve only
the parquet helpers, and raise naming themselves where they are missing.
"""

from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodaldiscussiontransformer_tpu_torch.core.config import BertTowerConfig
from multimodaldiscussiontransformer_tpu_torch.models.bert import BertBottomTower, BertPooler, Dense
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import FastDropout, dropout_rngs
from multimodaldiscussiontransformer_tpu_torch.models.mdt import _lecun_normal
from multimodaldiscussiontransformer_tpu_torch.serve.incremental import resolve_device


@dataclass
class TextBertConfig:
    lr: float = 3e-5
    batch_size: int = 48
    max_steps: int = 5000
    warmup_steps: int = 400
    weight_decay: float = 0.01
    eval_steps: int = 500
    max_length: int = 100
    num_labels: int = 2
    seed: int = 0
    output_dir: str = "comment_only_out"
    tower: BertTowerConfig = None

    def __post_init__(self):
        if self.tower is None:
            self.tower = BertTowerConfig()


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BertTextClassifier(nn.Module):
    """The whole BERT tower (``bert``), its pooler (``pooler``), dropout on
    the pooled vector and a Dense ``classifier``: the JAX module's
    parameter tree (``params/bert/...``, ``pooler/dense``, ``classifier``),
    so that ``utils/flax_import.py::load_flax_params`` fills it from a JAX
    bundle. Random init from ``generator`` with Flax's initializers
    (Dense lecun-normal, Embed normal(1/sqrt(dim)), LayerNorm 1/0)."""

    def __init__(self, cfg: TextBertConfig, dtype: str = "float32", generator: Optional[torch.Generator] = None):
        super().__init__()
        t = cfg.tower
        d = _DTYPES[dtype]
        self.cfg = cfg
        self.bert = BertBottomTower(t, t.num_hidden_layers, d)
        self.pooler = BertPooler(t.hidden_size, d)
        self.dropout = FastDropout(t.hidden_dropout_prob)
        self.classifier = Dense(t.hidden_size, cfg.num_labels, d)
        self.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(cfg.seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                _lecun_normal(mod.weight, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5, generator=generator)

    def forward(self, input_ids, token_type_ids, attention_mask, deterministic: bool = True) -> torch.Tensor:
        """(B, num_labels) logits. A training forward (``deterministic``
        False) runs inside ``models/fast_dropout.py::dropout_rngs``."""
        h = self.bert(input_ids, token_type_ids, attention_mask, deterministic)
        pooled = self.dropout(self.pooler(h), deterministic)
        return self.classifier(pooled)

    def load_hf(self, bert_sd) -> Dict[str, torch.Tensor]:
        """This model's state dict with a whole HF
        ``BertForSequenceClassification`` state dict written in (through
        ``utils/hf_import.py``); the classifier only where ``bert_sd`` has
        one. Load it with ``load_state_dict``."""
        from multimodaldiscussiontransformer_tpu_torch.utils import hf_import as hfi

        sd = dict(self.state_dict())
        updates = {f"bert.embeddings.{k}": v for k, v in hfi.bert_embeddings_params(bert_sd, "bert.embeddings").items()}
        for i in range(self.cfg.tower.num_hidden_layers):
            updates.update({f"bert.layer_{i}.{k}": v
                            for k, v in hfi.bert_layer_params(bert_sd, f"bert.encoder.layer.{i}").items()})
        updates.update(hfi._modules(bert_sd, "bert", (("pooler.dense", "pooler.dense"),)))
        if "classifier.weight" in bert_sd:
            updates.update(hfi._modules(bert_sd, "", (("classifier", "classifier"),)))
        hfi.put(sd, updates)
        return sd


def compute_metrics(logits: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """accuracy / precision / recall / F1 (binary) / AUC: the numpy
    equivalent of the sklearn math in Comment-Only utils.py:10-23."""
    preds = logits.argmax(-1)
    labels = np.asarray(labels)
    tp = float(((preds == 1) & (labels == 1)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    acc = float((preds == labels).mean()) if len(labels) else 0.0
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    # AUC via the rank statistic over softmax probabilities (utils.py:17-21)
    x = np.exp(logits - logits.max(-1, keepdims=True))
    probas = (x / x.sum(-1, keepdims=True))[:, 1]
    pos = probas[labels == 1]
    neg = probas[labels == 0]
    if len(pos) and len(neg):
        order = np.argsort(np.concatenate([neg, pos]), kind="mergesort")
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(1, len(order) + 1)
        # average ranks for ties
        concat = np.concatenate([neg, pos])
        sorted_vals = concat[order]
        i = 0
        while i < len(sorted_vals):
            j = i
            while j + 1 < len(sorted_vals) and sorted_vals[j + 1] == sorted_vals[i]:
                j += 1
            if j > i:
                avg = ranks[order[i : j + 1]].mean()
                ranks[order[i : j + 1]] = avg
            i = j + 1
        auc = (ranks[len(neg):].sum() - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg))
    else:
        auc = 0.0
    return {"accuracy": acc, "precision": p, "recall": r, "f1": f1, "auc": float(auc)}


def _pandas(what: str):
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(f"{what} needs pandas and pyarrow (parquet), which are not installed") from e
    return pd


def load_parquet_split(data_dir: str, split: int) -> Tuple[Any, Any]:
    """The reference split layout (dataset_loader.py:9-15)."""
    pd = _pandas("load_parquet_split")
    train = pd.read_parquet(os.path.join(data_dir, f"HatefulDiscussions_dataset_train-split-{split}.parquet"))
    valid = pd.read_parquet(os.path.join(data_dir, f"HatefulDiscussions_dataset_test-split-{split}.parquet"))
    return train, valid


def tokenize_frame(df, tokenizer, max_length: int) -> Dict[str, np.ndarray]:
    """A frame's ``text`` and ``label`` columns as token arrays and int32
    labels (``df`` may be any mapping of those two columns)."""
    toks = tokenizer(list(df["text"]), max_length=max_length)
    return {
        "input_ids": toks["input_ids"],
        "token_type_ids": toks["token_type_ids"],
        "attention_mask": toks["attention_mask"],
        "label": np.asarray(df["label"], np.int32),
    }


def lr_at(cfg: TextBertConfig, count: int) -> float:
    """The lr of the update after ``count`` applied updates (optax's
    schedule count): linear warmup from 0, then linear decay to 0 at
    ``max_steps``."""
    if count < cfg.warmup_steps:
        return cfg.lr * min(count, cfg.warmup_steps) / cfg.warmup_steps
    frac = 1 - (count - cfg.warmup_steps) / max(cfg.max_steps - cfg.warmup_steps, 1)
    return cfg.lr * min(max(frac, 0.0), 1.0)


def train(
    cfg: TextBertConfig,
    train_data: Dict[str, np.ndarray],
    valid_data: Dict[str, np.ndarray],
    hf_state_dict=None,
    log_fn=print,
    device=None,
    timings: Optional[Dict[str, list]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, float], np.ndarray]:
    """Fine-tune on ``device`` (the card unless the caller passes another);
    (best params as a CPU state dict, best valid metrics, valid logits of
    the best params). ``timings``, when given, collects the seconds of each
    step (``"step"``, the card synchronized) and of each evaluation."""
    dev = resolve_device(device)
    model = BertTextClassifier(cfg, generator=torch.Generator().manual_seed(cfg.seed))
    if hf_state_dict is not None:
        model.load_state_dict(model.load_hf(hf_state_dict))
    model = model.to(dev)
    n = len(train_data["label"])
    bs = min(cfg.batch_size, n)

    def slice_batch(data, idx):
        return {k: torch.as_tensor(np.asarray(v)[idx]).to(dev) for k, v in data.items()}

    opt = torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    host_gen = torch.Generator().manual_seed(cfg.seed)
    dev_gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def step_fn(batch, count):
        with dropout_rngs(host_gen, dev_gen):
            logits = model(batch["input_ids"], batch["token_type_ids"], batch["attention_mask"], deterministic=False)
        loss = F.cross_entropy(logits.float(), batch["label"].long())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = lr_at(cfg, count)
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def predict_all(data):
        logits = []
        m = len(data["label"])
        for s in range(0, m, bs):
            idx = np.arange(s, min(s + bs, m))
            if len(idx) < bs:  # pad to the batch shape, then trim
                idx_p = np.concatenate([idx, np.full(bs - len(idx), idx[-1])])
            else:
                idx_p = idx
            b = slice_batch(data, idx_p)
            out = model(b["input_ids"], b["token_type_ids"], b["attention_mask"], deterministic=True)
            logits.append(out.float().cpu().numpy()[: len(idx)])
        return np.concatenate(logits)

    best = {"accuracy": -1.0}
    best_params = copy.deepcopy(model.state_dict())
    order_rng = np.random.RandomState(cfg.seed)
    perm = order_rng.permutation(n)
    pos = 0
    for step in range(1, cfg.max_steps + 1):
        if pos + bs > n:
            perm = order_rng.permutation(n)
            pos = 0
        idx = perm[pos : pos + bs]
        pos += bs
        t = time.perf_counter()
        loss = step_fn(slice_batch(train_data, idx), step - 1)
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings.setdefault("step", []).append(time.perf_counter() - t)
        if step % cfg.eval_steps == 0 or step == cfg.max_steps:
            t = time.perf_counter()
            model.eval()
            metrics = compute_metrics(predict_all(valid_data), valid_data["label"])
            model.train()
            if timings is not None:
                timings.setdefault("eval", []).append(time.perf_counter() - t)
            log_fn(f"step {step}: loss {float(loss):.4f} valid {metrics}")
            if metrics["accuracy"] > best["accuracy"]:
                best = metrics
                best_params = copy.deepcopy(model.state_dict())
    model.load_state_dict(best_params)
    final_logits = predict_all(valid_data)
    return {k: v.detach().cpu() for k, v in best_params.items()}, best, final_logits


def save_predictions(output_dir: str, logits: np.ndarray, labels: np.ndarray) -> None:
    """predictions.parquet with y_pred / y_true (text_bert.py:74-80)."""
    pd = _pandas("save_predictions")
    os.makedirs(output_dir, exist_ok=True)
    pd.DataFrame({"y_pred": list(logits), "y_true": list(np.asarray(labels))}).to_parquet(
        os.path.join(output_dir, "predictions.parquet"))
