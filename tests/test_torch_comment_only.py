"""The port's comment-only BERT baseline (``experiments/comment_only``)
against the JAX package's, on the CPU at a small tower (hidden 32, 2
layers):

- ``compute_metrics`` bit-equal on seeded logits with tied probabilities;
- the classifier's logits from the JAX module's Flax params carried across
  (``utils/flax_import.py::load_flax_params``) within 1e-5 in float32;
- three ``train`` steps with dropout 0 from the same weights (an HF-layout
  state dict through both ``load_hf``s): the same batch order (every
  ``RandomState.permutation`` drawn) and the params within rtol 1e-5
  (atol 1e-6), the best metrics and valid logits within 1e-5. The one
  exception is the attention key biases: softmax is invariant to a shift
  of a query's row, so their exact gradient is 0 and both packages move
  them by AdamW steps on rounding noise; they are held to the bound of two
  such walks, 2.05 x the summed lr;
- ``trainval.main`` on parquet splits in a temporary directory (its
  ``--hf-init``: ``tests/test_torch_hf_init.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core.config import BertTowerConfig as JTower
from multimodaldiscussiontransformer_tpu.experiments.comment_only import text_bert as jtb
from multimodaldiscussiontransformer_tpu_torch.core.config import BertTowerConfig as PTower
from multimodaldiscussiontransformer_tpu_torch.experiments.comment_only import text_bert as ptb
from multimodaldiscussiontransformer_tpu_torch.experiments.comment_only import trainval
from multimodaldiscussiontransformer_tpu_torch.utils import hf_import as hfi
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import load_flax_params, to_flax_params

torch.set_num_threads(2)
TOWER = dict(vocab_size=50, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=32, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
KEYS = ("input_ids", "token_type_ids", "attention_mask")


def _data(n, seed, length=12):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, length), np.int64)
    for i in range(n):
        mask[i, rng.randint(3, length + 1):] = 0
    return {"input_ids": rng.randint(4, 50, (n, length)) * mask, "token_type_ids": np.zeros((n, length), np.int64),
            "attention_mask": mask, "label": rng.randint(0, 2, n).astype(np.int32)}


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_metrics_bit_equal_with_ties(seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(200, 2).astype(np.float32)
    logits[::5] = logits[1::5][: len(logits[::5])]  # tied probabilities
    logits[7::11, 1] = logits[7::11, 0]  # p = 0.5 exactly
    labels = rng.randint(0, 2, 200)
    assert ptb.compute_metrics(logits, labels) == jtb.compute_metrics(logits, labels)
    assert ptb.compute_metrics(logits, np.zeros(200, np.int64)) == jtb.compute_metrics(logits, np.zeros(200, np.int64))


def test_classifier_logits_match_jax_flax_bundle():
    pm = ptb.BertTextClassifier(ptb.TextBertConfig(tower=PTower(**TOWER)), generator=torch.Generator().manual_seed(3))
    params = to_flax_params(pm)
    assert set(params["params"]) == {"bert", "pooler", "classifier"}
    jm = jtb.BertTextClassifier(jtb.TextBertConfig(tower=JTower(**TOWER)))
    b = _data(5, 0)
    want = np.asarray(jm.module.apply(params, *(jnp.asarray(b[k]) for k in KEYS)))
    other = ptb.BertTextClassifier(ptb.TextBertConfig(tower=PTower(**TOWER)), generator=torch.Generator().manual_seed(4))
    load_flax_params(other, params)
    with torch.no_grad():
        got = other(*(torch.as_tensor(b[k]) for k in KEYS)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _hf_state_dict(model):
    """The port model's weights in HF ``BertForSequenceClassification``
    naming (numpy), the input of both packages' ``load_hf``."""
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    out = {}
    for src, dst in hfi.BERT_EMBEDDINGS:
        for leaf in ("weight", "bias"):
            if f"bert.embeddings.{dst}.{leaf}" in sd:
                out[f"bert.embeddings.{src}.{leaf}"] = sd[f"bert.embeddings.{dst}.{leaf}"]
    for i in range(TOWER["num_hidden_layers"]):
        for src, dst in hfi.BERT_LAYER:
            for leaf in ("weight", "bias"):
                out[f"bert.encoder.layer.{i}.{src}.{leaf}"] = sd[f"bert.layer_{i}.{dst}.{leaf}"]
    for leaf in ("weight", "bias"):
        out[f"bert.pooler.dense.{leaf}"] = sd[f"pooler.dense.{leaf}"]
        out[f"classifier.{leaf}"] = sd[f"classifier.{leaf}"]
    return out


def test_three_train_steps_match_jax(monkeypatch):
    init = ptb.BertTextClassifier(ptb.TextBertConfig(tower=PTower(**TOWER)), generator=torch.Generator().manual_seed(7))
    hf_sd = _hf_state_dict(init)
    common = dict(lr=1e-3, batch_size=4, max_steps=3, warmup_steps=1, eval_steps=3, max_length=12, seed=5)
    train, valid = _data(10, 1), _data(7, 2)  # an epoch of 2 batches: the third draws a new permutation
    drawn = []
    real = np.random.RandomState

    class Recording(real):
        def permutation(self, x):
            out = super().permutation(x)
            drawn.append(out.tolist())
            return out

    monkeypatch.setattr(np.random, "RandomState", Recording)
    j_params, j_best, j_logits = jtb.train(jtb.TextBertConfig(tower=JTower(**TOWER), **common), train, valid,
                                           hf_state_dict=hf_sd, log_fn=lambda *_: None)
    j_order, drawn[:] = list(drawn), []
    p_params, p_best, p_logits = ptb.train(ptb.TextBertConfig(tower=PTower(**TOWER), **common), train, valid,
                                           hf_state_dict=hf_sd, log_fn=lambda *_: None, device="cpu")
    assert drawn == j_order and len(drawn) == 2
    want = ptb.BertTextClassifier(ptb.TextBertConfig(tower=PTower(**TOWER)))
    load_flax_params(want, jax.tree_util.tree_map(np.asarray, j_params))
    lr_sum = sum(ptb.lr_at(ptb.TextBertConfig(**common), c) for c in range(common["max_steps"]))
    moved, bad = 0, {}
    for k, w in want.state_dict().items():
        e = np.abs(p_params[k].numpy() - w.numpy())
        tol = 2.05 * lr_sum if k.endswith("attention.key.bias") else 1e-6 + 1e-5 * np.abs(w.numpy())
        if not (e <= tol).all():
            bad[k] = float(e.max())
        moved += int((w != init.state_dict()[k]).any())
    assert not bad, bad
    assert moved > 10
    assert p_best.keys() == j_best.keys()
    np.testing.assert_allclose([p_best[k] for k in sorted(p_best)], [j_best[k] for k in sorted(j_best)], atol=1e-5)
    np.testing.assert_allclose(p_logits, j_logits, rtol=1e-5, atol=1e-5)


def test_trainval_main_on_parquet_splits(tmp_path, monkeypatch):
    pd = pytest.importorskip("pandas")
    words = "the a post reply thanks point fair agree scum filth vermin".split()
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    rng = np.random.RandomState(0)
    for part, n in (("train", 12), ("test", 6)):
        labels = rng.randint(0, 2, n)
        texts = [" ".join(rng.choice(words[:8] if y == 0 else words[5:], 6)) for y in labels]
        pd.DataFrame({"text": texts, "label": labels}).to_parquet(
            tmp_path / f"HatefulDiscussions_dataset_{part}-split-0.parquet")
    monkeypatch.setenv("MDT_BERT_VOCAB", str(vocab))
    small = PTower(**{**TOWER, "vocab_size": 30522, "max_position_embeddings": 128})
    monkeypatch.setattr(ptb.TextBertConfig, "__post_init__", lambda self: setattr(self, "tower", self.tower or small))
    out = tmp_path / "out"
    rc = trainval.main(["-s", "0", "--data-dir", str(tmp_path), "--output-dir", str(out), "--max-steps", "3",
                        "--eval-steps", "2", "--batch-size", "4", "--warmup-steps", "1", "--device", "cpu"])
    assert rc == 0
    frame = pd.read_parquet(out / "predictions.parquet")
    assert len(frame) == 6 and list(frame.columns) == ["y_pred", "y_true"]
    assert np.isfinite(np.stack(frame["y_pred"].to_numpy())).all()


def test_parquet_helpers_name_pandas_where_it_is_missing(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pandas(name, *a, **k):
        if name == "pandas" or name.startswith("pandas."):
            raise ImportError("No module named 'pandas'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    with pytest.raises(ImportError, match="pandas and pyarrow"):
        ptb.load_parquet_split(os.getcwd(), 0)
