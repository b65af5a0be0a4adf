"""The port's checkpoints (``utils/checkpoints.py``) and the paths that use
them, on the CPU at the tiny config, held against the JAX package where it
has the same function:
- resume: 2 updates, save, a new ``Trainer``, restore and 2 more updates
  equal 4 uninterrupted updates bit for bit (params, AdamW state, both
  generators), and match the JAX ``Trainer`` after 4 scan updates; the
  mid-epoch skip against the JAX formula (``train/trainer.py:706-720``);
- averaging against the JAX ``average_checkpoints`` of Orbax stores of the
  same params; the head reset; ``Checkpointer``'s retention, best store
  and atomic saves;
- ``Trainer.predict`` against the JAX ``Trainer.predict``, the CSV
  written without pandas, and its bytes against the JAX pandas writer;
- ``DiscussionScorer.from_checkpoint`` against the in-memory model and the
  JAX ``DiscussionScorer``, and ``serve.server.main`` answering a POST;
- the launcher: SIGTERM, save and auto-resume in a subprocess, and the
  ``--eval-only``, ``--average-last``, ``--predict-output`` and
  ``--restore-file --reset-optimizer`` runs.

Tolerances: port vs JAX params after 4 updates rtol 2e-4, atol 2e-5 (as
``tests/test_torch_train.py``, float32 sums in other orders; Adam's eps is
raised to 1e-6 on both sides so that no gradient at the float32 noise
floor flips an update's sign); probabilities atol 1e-5 (as
``tests/test_torch_serve.py``)."""

import csv
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic_dataset
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu.parallel.mesh import make_mesh
from multimodaldiscussiontransformer_tpu.serve import incremental as jserve
from multimodaldiscussiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from multimodaldiscussiontransformer_tpu.utils import checkpoints as jckpt
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_dataset
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.serve import server as pserver
from multimodaldiscussiontransformer_tpu_torch.serve.incremental import Discussion, DiscussionScorer
from multimodaldiscussiontransformer_tpu_torch.tasks.node_prediction import NodePredictionTask
from multimodaldiscussiontransformer_tpu_torch.train import launch
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer, resume_position, write_predictions
from multimodaldiscussiontransformer_tpu_torch.utils import average_checkpoints as avg_cli
from multimodaldiscussiontransformer_tpu_torch.utils import checkpoints as ckpt
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict, to_flax_params

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = (3, 32, 32)
SYN = dict(seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8)
DATA = dict(batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(64,),
            image_capacity_buckets=(16,), label_capacity_buckets=(32,))


def train_cfg(mod, dropout=False, **kw):
    """The same TrainConfig in either package: tiny model, batch 4 x
    update_freq 3; every dropout at 0 unless ``dropout`` (then attention
    dropout 0.3, dropout 0.1 and the towers' own)."""
    if dropout:
        m = mod.tiny_model_config(attention_dropout=0.3, dropout=0.1, act_dropout=0.1)
    else:
        m = mod.tiny_model_config(dropout=0.0, attention_dropout=0.0, act_dropout=0.0)
        no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        m = m.replace(text_tower=dataclasses.replace(m.text_tower, **no_drop),
                      image_tower=dataclasses.replace(m.image_tower, **no_drop))
    base = dict(
        model=m, data=mod.DataConfig(**DATA),
        optim=mod.OptimConfig(lr=1e-3, warmup_updates=2, total_num_update=20, update_freq=3, adam_eps=1e-6),
        task_cfg=mod.TaskConfig(dataset_name="synthetic", seed=0), log_interval=100, validate_interval_updates=0,
    )
    base.update(kw)
    return mod.TrainConfig(**base)


def _quiet(msg):
    pass


def _assert_states_equal(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert torch.equal(a.host_rng.get_state(), b.host_rng.get_state())
    assert torch.equal(a.device_rng.get_state(), b.device_rng.get_state())
    assert (a.step, a.num_updates, a.epoch) == (b.step, b.num_updates, b.epoch)


# -- resume ------------------------------------------------------------------


@pytest.mark.parametrize("stop_at", [2, 4])
def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, stop_at):
    """Dropout on: 48 train graphs of batch 4 x 3 give 4 updates an epoch.
    Stopping at update 2 resumes mid-epoch (skipping 2 groups); stopping at
    4 resumes at the epoch boundary before the epoch was counted."""
    cfg = train_cfg(pconfig, dropout=True, save_dir=str(tmp_path / "m"))
    ds = synthetic_dataset(num_graphs=60, seed=1, **SYN)
    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    assert trainer.micro_per_epoch(ds) == 12
    whole = trainer.fit(ds, max_updates=6, log_fn=_quiet)

    saver = ckpt.Checkpointer(str(tmp_path / "ck"))
    first = Trainer(cfg, image_shape=IMG, device="cpu").fit(ds, max_updates=stop_at, checkpointer=saver, log_fn=_quiet)
    assert saver.latest_step() == stop_at and first.epoch == 0
    resumed_trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    state = resumed_trainer.init_state(seed=99)  # other weights and generators: all replaced
    state = ckpt.restore_params_into_state(resumed_trainer, state, saver.restore(state), reset_optimizer=False)
    resumed = resumed_trainer.fit(ds, state=state, max_updates=6, log_fn=_quiet)
    _assert_states_equal(resumed, whole)
    assert whole.num_updates == 6 and whole.epoch == 1


def test_resume_into_a_model_built_on_meta_is_bit_equal(tmp_path):
    """The launcher's auto-resume: ``init_state(params=...)`` builds the
    model on the meta device (no random init) before the restore."""
    cfg = train_cfg(pconfig, dropout=True, save_dir=str(tmp_path / "m"))
    ds = synthetic_dataset(num_graphs=60, seed=1, **SYN)
    whole = Trainer(cfg, image_shape=IMG, device="cpu").fit(ds, max_updates=4, log_fn=_quiet)

    saver = ckpt.Checkpointer(str(tmp_path / "ck"))
    Trainer(cfg, image_shape=IMG, device="cpu").fit(ds, max_updates=2, checkpointer=saver, log_fn=_quiet)
    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    restored = saver.restore()
    state = trainer.init_state(params=restored["params"])
    assert not any(t.is_meta for t in state.model.state_dict().values())
    state = ckpt.restore_params_into_state(trainer, state, restored, reset_optimizer=False)
    _assert_states_equal(trainer.fit(ds, state=state, max_updates=4, log_fn=_quiet), whole)


def jax_state_from(jtrainer, state_dict):
    """A JAX ``TrainState`` holding the port's weights, built as
    ``Trainer.init_state`` builds one (its eager Flax init takes ~25 s
    here), with every scalar placed replicated over the mesh as the JAX
    step returns it, so that the step compiles once."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from multimodaldiscussiontransformer_tpu.parallel.mesh import shard_params
    from multimodaldiscussiontransformer_tpu.train import optimizer as joptim
    from multimodaldiscussiontransformer_tpu.train.trainer import TrainState as JaxTrainState

    model = MDTModel(pconfig.tiny_model_config())
    model.load_state_dict(state_dict)
    params = shard_params(jtrainer.mesh, jax.tree.map(jnp.asarray, to_flax_params(model)))
    jtrainer.tx = joptim.make_optimizer(jtrainer.cfg.optim, params, wrap_multisteps=False)
    rep = NamedSharding(jtrainer.mesh, PartitionSpec())
    scalar = lambda v: jax.device_put(jnp.asarray(v, jnp.int32), rep)  # noqa: E731
    opt_state = jax.tree.map(lambda x: jax.device_put(x, rep) if x.ndim == 0 else x, jtrainer.tx.init(params))
    return JaxTrainState(step=scalar(0), params=params, opt_state=opt_state,
                         rng=jax.device_put(jax.random.PRNGKey(0), rep), epoch=scalar(0))


def test_resumed_run_matches_jax_trainer(tmp_path):
    """Dropout off, the same initial weights: the port's 2 + restore + 2
    updates against the JAX ``Trainer.fit``'s 4 scan updates. Both take
    the graph attention's plain path (``use_pallas_attention`` off: JAX's
    Pallas interpret mode costs minutes here; the kernels' own tests hold
    them)."""
    jcfg = train_cfg(jconfig, fast_dropout_rng=False, save_dir=str(tmp_path / "j"))
    jcfg = jcfg.replace(model=jcfg.model.replace(use_pallas_attention=False))
    pcfg = train_cfg(pconfig, save_dir=str(tmp_path / "p"))
    pcfg = pcfg.replace(model=pcfg.model.replace(use_pallas_attention=False))
    init = MDTModel(pcfg.model, generator=torch.Generator().manual_seed(3)).state_dict()
    jtrainer = JaxTrainer(jcfg, mesh=make_mesh(1, 1), image_shape=IMG)
    jstate = jtrainer.fit(jax_synthetic_dataset(num_graphs=60, seed=1, **SYN), state=jax_state_from(jtrainer, init),
                          max_updates=4, log_fn=_quiet)
    want = flax_to_state_dict(jax.device_get(jstate.params))

    ds = synthetic_dataset(num_graphs=60, seed=1, **SYN)
    saver = ckpt.Checkpointer(str(tmp_path / "ck"))
    trainer = Trainer(pcfg, image_shape=IMG, device="cpu")
    trainer.fit(ds, state=trainer.load_params(trainer.init_state(), init), max_updates=2, checkpointer=saver,
                log_fn=_quiet)
    trainer = Trainer(pcfg, image_shape=IMG, device="cpu")
    state = ckpt.restore_params_into_state(trainer, trainer.init_state(), saver.restore(), reset_optimizer=False)
    state = trainer.fit(ds, state=state, max_updates=4, log_fn=_quiet)
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-4, atol=2e-5, err_msg=k)


def _jax_skip(micro_steps, epoch, n_train, batch, k):
    """The JAX trainer's resume arithmetic as written at
    ``train/trainer.py:700-720`` (scan mode: ``update_freq > 1``)."""
    start_epoch = epoch + 1
    bpe = n_train // max(batch, 1)
    micro_per_epoch = ((bpe + k - 1) // k) * k if k > 1 and bpe > 0 else bpe
    skip_batches = 0
    if micro_per_epoch > 0:
        consumed = micro_steps - (start_epoch - 1) * micro_per_epoch
        if 0 < consumed < micro_per_epoch:
            skip_batches = consumed
    return start_epoch, skip_batches // k


@pytest.mark.parametrize(
    "n_train, batch, k, updates, epoch",
    [
        (48, 4, 3, 2, 0),  # mid-epoch
        (48, 4, 3, 0, 0),  # fresh
        (40, 4, 3, 1, 0),  # bpe 10 -> 12 microbatches an epoch
        (40, 4, 3, 0, 3),  # 3 completed epochs with a padded tail: no skip (a stride of 10 would skip 2)
        (40, 4, 3, 2, 1),  # mid-epoch 2 after a padded tail
        (47, 4, 3, 3, 0),  # 11 batches: the ragged tail dropped, 12 microbatches
        (48, 4, 1, 5, 0),  # update_freq 1
        (12, 4, 2, 1, 1),  # two groups an epoch, the second epoch half done
        (96, 12, 3, 2, 3),  # the canonical batch, epoch 4
    ],
)
def test_resume_skip_matches_jax_formula(n_train, batch, k, updates, epoch):
    bpe = n_train // batch
    mpe = -(-bpe // k) * k
    step = epoch * mpe + updates * k
    assert resume_position(step, epoch, mpe, k) == _jax_skip(step, epoch, n_train, batch, k)


def test_resume_at_an_uncounted_epoch_end_starts_the_next_epoch():
    """A state saved after an epoch's last group, before the epoch was
    counted: the JAX formula runs the epoch again; the port goes on with
    the next one, as the uninterrupted run does."""
    assert _jax_skip(12, 0, 48, 4, 3) == (1, 0)
    assert resume_position(12, 0, 12, 3) == (2, 0)
    assert resume_position(15, 0, 12, 3) == (2, 1)


# -- Checkpointer, averaging, head reset --------------------------------------


def _params(seed, extra_int=False):
    g = torch.Generator().manual_seed(seed)
    sd = {"a.weight": torch.randn(3, 4, generator=g), "b.bias": torch.randn(5, generator=g).to(torch.bfloat16)}
    if extra_int:
        sd["counter"] = torch.tensor([seed, seed + 1])
    return sd


def test_checkpointer_keeps_the_last_k_and_the_best(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path), keep=2)
    assert c.latest_step() is None and c.best_step() is None and c.restore() is None
    for step in (1, 2, 3):
        c.save({"params": _params(step)}, step, best=step == 1)
    assert c.all_steps() == [2, 3] and c.latest_step() == 3 and c.best_step() == 1
    assert (tmp_path / "best_step.txt").read_text() == "1"
    assert torch.equal(c.restore(best=True)["params"]["a.weight"], _params(1)["a.weight"])
    assert torch.equal(c.restore()["params"]["a.weight"], _params(3)["a.weight"])
    assert torch.equal(c.restore(step=2)["params"]["a.weight"], _params(2)["a.weight"])
    with pytest.raises(FileNotFoundError):
        c.restore(step=1)
    c.save({"params": _params(4)}, 4, best=True)
    c.wait()  # saves are asynchronous: the files are there once wait returns
    assert os.listdir(tmp_path / "best") == ["4"] and c.best_step() == 4


def test_best_falls_back_to_latest(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path))
    c.save({"params": _params(7)}, 7)
    assert c.best_step() == 7
    assert torch.equal(c.restore(best=True)["params"]["a.weight"], _params(7)["a.weight"])
    assert torch.equal(c.restore(best=True)["params"]["a.weight"], _params(7)["a.weight"])


def test_same_step_save_overwrites(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path))
    c.save({"params": _params(1)}, 5, best=True)
    c.save({"params": _params(2)}, 5)
    assert c.all_steps() == [5]
    assert torch.equal(c.restore()["params"]["a.weight"], _params(2)["a.weight"])
    # the best store holds its own link to the first save's bytes
    assert torch.equal(c.restore(best=True)["params"]["a.weight"], _params(1)["a.weight"])
    assert sorted(os.listdir(tmp_path)) == ["5", "best", "best_step.txt"]


def test_leftovers_of_a_killed_save_are_ignored(tmp_path):
    """A save killed before its ``os.replace`` leaves a temporary directory
    (or a step directory without its file): neither is a step."""
    c = ckpt.Checkpointer(str(tmp_path))
    c.save({"params": _params(1)}, 3)
    (tmp_path / ".tmp-9").mkdir()
    (tmp_path / ".tmp-9" / "state.pt").write_bytes(b"partial")
    (tmp_path / "8").mkdir()
    assert c.all_steps() == [3] and c.latest_step() == 3
    c.save({"params": _params(2)}, 9)  # the leftover is cleared, the save lands
    assert c.all_steps() == [3, 9] and not (tmp_path / ".tmp-9").exists()


def test_train_state_round_trips_byte_exact(tmp_path):
    """Everything a state holds comes back equal, through ``weights_only``
    loading (no pickled objects in the file)."""
    cfg = train_cfg(pconfig, dropout=True, save_dir=str(tmp_path / "m"))
    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    state = trainer.fit(synthetic_dataset(num_graphs=40, seed=2, **SYN), max_updates=2, log_fn=_quiet)
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    c.save(state, state.num_updates)
    restored = c.restore(state)
    assert set(restored) == {"params", "optimizer", "step", "num_updates", "epoch", "host_rng", "device_rng"}
    other = ckpt.restore_params_into_state(trainer, trainer.init_state(seed=5), restored, reset_optimizer=False)
    _assert_states_equal(other, state)
    with pytest.raises(ValueError, match="params-only"):
        ckpt.restore_params_into_state(trainer, other, {"params": restored["params"]}, reset_optimizer=False)
    with pytest.raises(ValueError, match="does not fit"):
        c.save({"params": _params(0)}, 3)
        c.restore(state)


@pytest.mark.parametrize("select", [{}, {"steps": [1, 3]}, {"last_k": 2}])
def test_average_matches_jax(tmp_path, select):
    """Three params trees saved by the JAX ``save_params`` (Orbax) and the
    same trees by the port's: the two averages are equal."""
    rng = np.random.default_rng(0)
    trees = [{"params": {"node_classifier": {"kernel": rng.standard_normal((6, 2)).astype(np.float32),
                                             "bias": rng.standard_normal(2).astype(np.float32)},
                         "LayerNorm_0": {"scale": rng.standard_normal(6).astype(np.float32)}}}
             for _ in range(3)]
    for step, tree in enumerate(trees, start=1):
        jckpt.save_params(str(tmp_path / "jax"), tree, step=step)
        ckpt.save_params(str(tmp_path / "port"), flax_to_state_dict(tree), step=step)
    want = flax_to_state_dict(jckpt.average_checkpoints(str(tmp_path / "jax"), **select))
    got = ckpt.average_checkpoints(str(tmp_path / "port"), **select)
    assert set(got) == set(want) == {"node_classifier.weight", "node_classifier.bias", "LayerNorm_0.weight"}
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def test_average_keeps_dtypes_and_takes_integers_from_the_newest(tmp_path):
    for step in (1, 2, 3):
        ckpt.save_params(str(tmp_path), _params(step, extra_int=True), step=step)
    got = ckpt.average_checkpoints(str(tmp_path), last_k=2)
    torch.testing.assert_close(got["a.weight"], (_params(2)["a.weight"].double() + _params(3)["a.weight"].double()).div(2).float(),
                               rtol=0, atol=0)
    assert got["b.bias"].dtype == torch.bfloat16
    assert torch.equal(got["counter"], torch.tensor([3, 4]))


@pytest.mark.parametrize("bad", [{"steps": [1, 5]}, {"last_k": 0}, "empty"])
def test_average_rejects_missing_steps(tmp_path, bad):
    if bad == "empty":
        with pytest.raises(FileNotFoundError):
            ckpt.average_checkpoints(str(tmp_path))
        return
    for step in (1, 2):
        ckpt.save_params(str(tmp_path), _params(step), step=step)
    with pytest.raises(ValueError):
        ckpt.average_checkpoints(str(tmp_path), **bad)


def test_average_cli(tmp_path, capsys):
    for step in (1, 2, 3):
        ckpt.save_params(str(tmp_path / "in"), _params(step), step=step)
    assert avg_cli.main(["--inputs", str(tmp_path / "in"), "--output", str(tmp_path / "out"), "--steps", "1,2"]) == 0
    out = ckpt.Checkpointer(str(tmp_path / "out"))
    assert out.all_steps() == [0]
    torch.testing.assert_close(out.restore()["params"]["a.weight"],
                               ckpt.average_checkpoints(str(tmp_path / "in"), steps=[1, 2])["a.weight"], rtol=0, atol=0)


def test_reset_classifier_head():
    """Only the head changes: a truncated LeCun-normal weight (std
    1/sqrt(fan_in), within two of the untruncated std) and a zero bias; the
    input dict is untouched; the same generator seed draws the same head."""
    sd = {"node_classifier.weight": torch.zeros(64, 1024), "node_classifier.bias": torch.ones(64),
          "text_pooler.dense.weight": torch.ones(3, 3)}
    snapshot = {k: v.clone() for k, v in sd.items()}
    out = ckpt.reset_classifier_head(sd, torch.Generator().manual_seed(0))
    for k, v in sd.items():
        assert torch.equal(v, snapshot[k]), k
    assert out["text_pooler.dense.weight"] is sd["text_pooler.dense.weight"]
    w = out["node_classifier.weight"]
    assert abs(w.std().item() * 1024 ** 0.5 - 1.0) < 0.02
    assert w.abs().max().item() <= 2 * 1024 ** -0.5 / 0.87962566103423978
    assert not out["node_classifier.bias"].any()
    assert torch.equal(ckpt.reset_classifier_head(sd, torch.Generator().manual_seed(0))["node_classifier.weight"], w)
    # the JAX reset draws from another PRNG: the same law, not the same bits
    jout = jckpt.reset_classifier_head({"params": {"node_classifier": {"kernel": np.zeros((1024, 64), np.float32),
                                                                        "bias": np.ones(64, np.float32)}}},
                                       jax.random.PRNGKey(0))
    jw = np.asarray(jout["params"]["node_classifier"]["kernel"])
    assert abs(jw.std() / w.std().item() - 1.0) < 0.03


def test_task_transfer_resets_the_head():
    model = MDTModel(pconfig.tiny_model_config(), generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    out = NodePredictionTask(train_cfg(pconfig)).transfer_from_contrastive(sd, seed=3)
    changed = sorted(k for k in sd if not torch.equal(sd[k], out[k]))
    assert changed == ["node_classifier.bias", "node_classifier.weight"] or changed == ["node_classifier.weight"]
    assert not out["node_classifier.bias"].any()


# -- predictions and serving --------------------------------------------------


@pytest.fixture(scope="module")
def jax_model():
    """A JAX Trainer's state at the tiny config and the port model with the
    same weights."""
    jcfg = train_cfg(jconfig, fast_dropout_rng=False)
    jcfg = jcfg.replace(model=jcfg.model.replace(use_pallas_attention=False))  # as in the resume test: one compile
    jtrainer = JaxTrainer(jcfg, mesh=make_mesh(1, 1), image_shape=IMG)
    jds = jax_synthetic_dataset(num_graphs=40, seed=4, **SYN)
    trainer = Trainer(train_cfg(pconfig), image_shape=IMG, device="cpu")
    state = trainer.init_state(seed=4)
    jstate = jax_state_from(jtrainer, state.model.state_dict())
    return jtrainer, jstate, jds, trainer, state


def test_predict_matches_jax(jax_model):
    jtrainer, jstate, jds, trainer, state = jax_model
    want = jtrainer.predict(jstate, jds, "valid")
    got = trainer.predict(state, synthetic_dataset(num_graphs=40, seed=4, **SYN), "valid")
    assert set(got) == set(want) == {"graph_idx", "node", "label", "labeled", "pred", "logit_0", "logit_1",
                                     "prob_0", "prob_1"}
    assert len(got["graph_idx"]) > 0
    for k in ("graph_idx", "node", "label", "labeled"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("prob_0", "prob_1"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["prob_0"] + got["prob_1"], 1.0, atol=1e-6)


def test_write_predictions_without_pandas(tmp_path, monkeypatch, capsys):
    cols = {"graph_idx": np.array([3, 3, 7]), "node": np.array([0, 1, 0], np.int32),
            "labeled": np.array([True, False, True]), "prob_0": np.array([0.25, 0.5, 0.125], np.float32)}
    monkeypatch.setitem(sys.modules, "pandas", None)  # import pandas raises ImportError
    path = write_predictions(str(tmp_path / "predictions-test.parquet"), cols)
    assert path == str(tmp_path / "predictions-test.csv")
    assert "warning: parquet engine unavailable" in capsys.readouterr().err
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows == [["graph_idx", "node", "labeled", "prob_0"], ["3", "0", "True", "0.25"], ["3", "1", "False", "0.5"],
                    ["7", "0", "True", "0.125"]]
    assert write_predictions(str(tmp_path / "p.csv"), cols) == str(tmp_path / "p.csv")


@pytest.mark.parametrize("route", ["csv_path", "parquet_fails"])
def test_prediction_csv_is_byte_equal_to_jax(tmp_path, monkeypatch, capsys, route):
    """The CSV holds the bytes of the JAX package's pandas writer: float32
    columns in their shortest repr (0.7, -1.3, a tiny exponent), NaN as an
    empty field, inf and -inf, ints and bools, ``\\n`` line ends; for a
    ``.csv`` path and for the fallback when parquet fails."""
    import pandas as pd

    from multimodaldiscussiontransformer_tpu.train.trainer import write_predictions as jax_write_predictions

    cols = {"graph_idx": np.array([3, 3, 7, 9, 11], np.int64), "node": np.array([0, 1, 0, 2, 4], np.int32),
            "labeled": np.array([True, False, True, True, False]),
            "logit_0": np.array([0.7, -1.3, np.nan, np.inf, -np.inf], np.float32),
            "prob_0": np.array([1e-40, 0.1, 3e38, -0.0, 0.5], np.float32),
            "pred": np.array([1, 0, 1, 1, 0], np.int64)}
    if route == "parquet_fails":
        def refuse(*a, **k):
            raise ValueError("no parquet engine")

        monkeypatch.setattr(pd.DataFrame, "to_parquet", refuse)
        names = ("p.parquet", "j.parquet")
    else:
        names = ("p.csv", "j.csv")
    got = write_predictions(str(tmp_path / names[0]), cols)
    want = jax_write_predictions(str(tmp_path / names[1]), cols)
    assert got.endswith(".csv") and want.endswith(".csv")
    if route == "parquet_fails":
        assert capsys.readouterr().err.count("warning: parquet engine unavailable") == 2
    with open(got, "rb") as f, open(want, "rb") as g:
        data = f.read()
        assert data == g.read()
    assert b"0.7," in data and b"-1.3," in data and b"\r" not in data and b",inf," in data and b"1e-40" in data


def _discussions(rng, n):
    out = []
    for _ in range(n):
        d = Discussion()
        for i in range(int(rng.integers(2, 7))):
            image = rng.standard_normal(IMG).astype(np.float32) if i == 1 else None
            d.add_node(-1 if i == 0 else int(rng.integers(0, i)), rng.integers(1, 120, 16).astype(np.int32), image=image)
        out.append(d)
    return out


SERVE_KW = dict(data_cfg=pconfig.DataConfig(batch_size=1, node_buckets=(8,), node_capacity_buckets=(32,),
                                            image_capacity_buckets=(0, 8), label_capacity_buckets=(8,)),
                image_shape=IMG)


def test_from_checkpoint_scores_like_the_model_and_jax(tmp_path, jax_model):
    jtrainer, jstate, _, trainer, state = jax_model
    c = ckpt.Checkpointer(str(tmp_path))
    c.save(state, 2, best=True)
    other = trainer.init_state(seed=8)
    c.save(other, 3)
    c.wait()
    cfg = pconfig.tiny_model_config()
    items = [d.to_item(i) for i, d in enumerate(_discussions(np.random.default_rng(0), 3))]
    want = DiscussionScorer(state.model, device="cpu", **SERVE_KW).score_items(items)
    best = DiscussionScorer.from_checkpoint(str(tmp_path), model_cfg=cfg, device="cpu", **SERVE_KW)
    assert best.device == torch.device("cpu")
    for a, b in zip(best.score_items(items), want):
        np.testing.assert_array_equal(a, b)
    jscorer = jserve.DiscussionScorer(JaxMDTModel(jtrainer.cfg.model), jax.device_get(jstate.params),
                                      jconfig.DataConfig(**dataclasses.asdict(SERVE_KW["data_cfg"])), image_shape=IMG)
    for a, b in zip(best.score_items(items), jscorer.score_items(items)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    latest = DiscussionScorer.from_checkpoint(str(tmp_path), model_cfg=cfg, best=False, device="cpu", **SERVE_KW)
    by_step = DiscussionScorer.from_checkpoint(str(tmp_path), model_cfg=cfg, step=3, device="cpu", **SERVE_KW)
    other_want = DiscussionScorer(other.model, device="cpu", **SERVE_KW).score_items(items)
    for scorer in (latest, by_step):
        for a, b in zip(scorer.score_items(items), other_want):
            np.testing.assert_array_equal(a, b)


def test_from_checkpoint_refuses_what_it_cannot_serve(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        DiscussionScorer.from_checkpoint(str(tmp_path / "none"), model_cfg=pconfig.tiny_model_config(), device="cpu")
    ckpt.save_params(str(tmp_path / "scan"), {"graph_encoder.scan_pairs.layer.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="does not fit the model"):
        DiscussionScorer.from_checkpoint(str(tmp_path / "scan"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiscussionScorer.from_checkpoint(str(tmp_path / "scan"))


def test_server_main_answers_a_post(tmp_path, jax_model, monkeypatch):
    """``serve.server.main --checkpoint ... --port 0 --device cpu``; the
    tiny model config and image shape reach ``from_checkpoint`` through a
    wrapper (the CLI builds ``ModelConfig()``, as the JAX CLI does)."""
    _, _, _, _, state = jax_model
    c = ckpt.Checkpointer(str(tmp_path))
    c.save(state, 1)
    c.wait()
    orig = DiscussionScorer.from_checkpoint.__func__
    seen = {}
    monkeypatch.setattr(DiscussionScorer, "from_checkpoint", classmethod(
        lambda cls, d, **kw: seen.update(kw) or orig(cls, d, model_cfg=pconfig.tiny_model_config(), **SERVE_KW, **kw)))
    servers = []

    class Recorded(pserver.ScoreServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(pserver, "ScoreServer", Recorded)
    rc = []
    t = threading.Thread(target=lambda: rc.append(pserver.main(
        ["--checkpoint", str(tmp_path), "--host", "127.0.0.1", "--port", "0", "--device", "cpu", "--latest"])))
    t.start()
    try:
        deadline = time.time() + 60
        while not servers and time.time() < deadline:
            time.sleep(0.05)
        port = servers[0].server_address[1]
        d = _discussions(np.random.default_rng(1), 1)[0]
        body = json.dumps({"discussions": [{"parents": d.parents, "input_ids": np.stack(d.input_ids).tolist(),
                                            "images": {str(k): v.tolist() for k, v in d.images.items()}}]}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/score", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            probs = np.asarray(json.loads(resp.read())["probs"][0])
    finally:
        if servers:
            servers[0].shutdown()
        t.join(timeout=30)
    assert not t.is_alive() and rc == [0]
    assert seen == {"best": False, "device": "cpu", "batch_buckets": "pow2"}
    want = DiscussionScorer(state.model, device="cpu", **SERVE_KW).score(d)
    np.testing.assert_allclose(probs, want, atol=1e-6)


# -- the launcher --------------------------------------------------------------


def _launch_cmd(save_dir, max_updates):
    return [sys.executable, "-m", "multimodaldiscussiontransformer_tpu_torch.train.launch", "--synthetic", "--tiny",
            "--device", "cpu", "--batch-size", "4", "--update-freq", "1", "--synthetic-graphs", "64",
            "--max-updates", str(max_updates), "--log-interval", "1", "--validate-interval-updates", "0",
            "--save-dir", str(save_dir)]


def _run_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONUNBUFFERED"] = "1"
    env["OMP_NUM_THREADS"] = "2"  # as this process's torch threads: the suite runs beside other workers
    return env


def test_sigterm_saves_and_the_relaunch_resumes(tmp_path):
    """As ``tests/test_preemption.py`` for the JAX launcher: SIGTERM after
    the first update; exit 0 with a checkpoint; the relaunch auto-resumes
    from it and ends at its ``--max-updates``."""
    save_dir = tmp_path / "ck"
    log = tmp_path / "run1.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(_launch_cmd(save_dir, 500), cwd=REPO, env=_run_env(), stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 120
            while "update 1:" not in log.read_text():
                assert proc.poll() is None and time.time() < deadline, log.read_text()
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
    text = log.read_text()
    assert rc == 0, text
    saved = int(re.search(r"preempted: checkpoint saved at step (\d+)", text).group(1))
    assert 1 <= saved < 500 and ckpt.Checkpointer(str(save_dir)).latest_step() == saved

    proc = subprocess.run(_launch_cmd(save_dir, saved + 2), cwd=REPO, env=_run_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"auto-resumed from step {saved}" in proc.stdout
    assert f"update {saved + 1}:" in proc.stdout and f"update {saved}:" not in proc.stdout
    assert ckpt.Checkpointer(str(save_dir)).latest_step() == saved + 2


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    """A tiny CPU launch that saves at updates 2, 4 and 5, with a best
    step from each validation."""
    d = tmp_path_factory.mktemp("trained")
    argv = ["--synthetic", "--tiny", "--device", "cpu", "--batch-size", "4", "--max-updates", "5",
            "--save-interval-updates", "2", "--validate-interval-updates", "2", "--log-interval", "1",
            "--save-dir", str(d)]
    assert launch.main(argv) == 0
    assert ckpt.Checkpointer(str(d)).all_steps() == [2, 4, 5]
    return d


@pytest.mark.parametrize(
    "flags, expect",
    [
        (["--eval-only"], "evaluating latest checkpoint"),
        (["--eval-only", "--load-best"], "evaluating best checkpoint"),
        (["--eval-only", "--average-last", "2", "--valid-subset", "test"], "evaluating average of last 2"),
        (["--eval-only", "--predict-output", "PRED"], "per-node rows"),
        (["--restore-file", "SAVED", "--reset-optimizer", "--max-updates", "1"], "restored from"),
    ],
)
def test_launch_checkpoint_flags(trained_dir, tmp_path, capsys, flags, expect):
    flags = [str(tmp_path / "pred") if f == "PRED" else str(trained_dir) if f == "SAVED" else f for f in flags]
    save_dir = str(tmp_path / "new") if "--restore-file" in flags else str(trained_dir)
    argv = ["--synthetic", "--tiny", "--device", "cpu", "--batch-size", "4", "--save-dir", save_dir] + flags
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert expect in out, out
    if "--predict-output" in flags:
        for split in ("valid", "test"):
            rows = int(re.search(rf"wrote (\d+) per-node rows -> .*predictions-{split}", out).group(1))
            assert rows > 0 and os.path.exists(tmp_path / "pred" / f"predictions-{split}.parquet")
    if "--restore-file" in flags:
        # fine-tuning from the restored params: the head drawn afresh, one update, a new save dir
        assert ckpt.Checkpointer(save_dir).all_steps() == [1]


def test_launch_eval_only_without_a_checkpoint(tmp_path, capsys):
    argv = ["--synthetic", "--tiny", "--device", "cpu", "--batch-size", "4", "--eval-only", "--save-dir", str(tmp_path)]
    assert launch.main(argv) == 1
    assert "no checkpoint under" in capsys.readouterr().err
