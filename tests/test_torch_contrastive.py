"""The port's contrastive pre-training stage against the JAX package, on the
CPU at the tiny config: the contrastive loss and its metric reduction, the
synthetic contrastive items and their collated batches, one scan update of
the contrastive task against the JAX ``Trainer`` (weights carried across
with ``utils/flax_import.py``), its evaluation, and the two-stage recipe
through the launcher (contrastive checkpoint -> ``--restore-file
--reset-optimizer`` node task).

Tolerances: the loss within float32 rtol 1e-6 and every count exact; the
gradient with respect to the embeddings rtol 1e-5 (atol 1e-7: entries that
cancel to ~0); the update's gradients and parameters two-tier as
``tests/test_torch_train.py`` (rtol 2e-4 for gradients, atol the larger of
1e-6 and 1e-5 of the tensor's max |g|: the scale of 20 and the sum over B²
pairs make these gradients ~20x the node loss's, and float32 sums in
another order leave an absolute error in proportion; e.g. the graph token's
gradient reaches 1.17); evaluation metrics rtol 1e-5."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.data import collator as jcollator
from multimodaldiscussiontransformer_tpu.data import synthetic as jsyn
from multimodaldiscussiontransformer_tpu.data.loader import stack_microbatches as jax_stack
from multimodaldiscussiontransformer_tpu.parallel.mesh import make_mesh, shard_stacked_batch
from multimodaldiscussiontransformer_tpu.tasks.contrastive import ContrastiveLearningTask as JaxContrastiveTask
from multimodaldiscussiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.core import registry
from multimodaldiscussiontransformer_tpu_torch.data import collator as pcollator
from multimodaldiscussiontransformer_tpu_torch.data import synthetic as psyn
from multimodaldiscussiontransformer_tpu_torch.data.loader import stack_microbatches
from multimodaldiscussiontransformer_tpu_torch.losses import contrastive_loss as ploss
from multimodaldiscussiontransformer_tpu_torch.tasks.contrastive import ContrastiveLearningTask
from multimodaldiscussiontransformer_tpu_torch.train import launch
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer
from multimodaldiscussiontransformer_tpu_torch.utils import checkpoints as ckpt
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import to_flax_params

# the JAX package's ``losses`` exports the function, which shadows the module
jloss = importlib.import_module("multimodaldiscussiontransformer_tpu.losses.contrastive_loss")
torch.set_num_threads(2)
IMG = (3, 32, 32)
SYN = dict(seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8)


def _loss_inputs(seed, b=6, d=16, pads=0):
    """Embeddings, communities and hard communities with ``hard_y == y`` on
    some rows, and the valid mask with ``pads`` pad graphs at the end."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, d)).astype(np.float32)
    y = rng.integers(0, 3, b).astype(np.float32)
    hard_y = rng.integers(0, 3, b).astype(np.float32)
    hard_y[:2] = y[:2]
    valid = np.arange(b) < b - pads
    return emb, y, hard_y, valid


@pytest.mark.parametrize("pads", [0, 2])
@pytest.mark.parametrize("weights", [dict(), dict(soft_negative_weight=0.5, adaptive_soft_negative_weight=False)])
def test_contrastive_loss_matches_jax(pads, weights):
    emb, y, hard_y, valid = _loss_inputs(3 + pads, pads=pads)
    valid_arg = valid if pads else None

    def jfn(e):
        return jloss.contrastive_loss(e, jnp.asarray(y), jnp.asarray(hard_y), **weights,
                                      valid=None if valid_arg is None else jnp.asarray(valid_arg))

    want = jax.jit(jfn)(jnp.asarray(emb))  # jitted: eagerly each op compiles on its own
    want_grad = jax.jit(jax.grad(lambda e: jfn(e)[0]))(jnp.asarray(emb))
    e = torch.from_numpy(emb.copy()).requires_grad_(True)
    got = ploss.contrastive_loss(e, torch.from_numpy(y), torch.from_numpy(hard_y), **weights,
                                 valid=None if valid_arg is None else torch.from_numpy(valid_arg))
    got[0].backward()
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-6)
    assert int(got[1]) == int(want[1]) == int(valid.sum()) ** 2
    for k, v in want[2].items():
        if k == "loss":
            np.testing.assert_allclose(float(got[2][k]), float(v), rtol=1e-6)
        else:
            assert int(got[2][k]) == int(v), k
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)
    if pads:  # pad graphs add nothing: their gradient is 0
        assert not e.grad[-pads:].any()


def test_reduce_contrastive_metrics_matches_jax():
    agg = {"loss": 31.5, "sample_size": 36.0, "ncorrect": 20.0, "positive_correct": 3.0, "total_positive": 2.0,
           "pred_positive": 7.0, "nsentences": 36.0}
    assert ploss.reduce_contrastive_metrics(agg) == jloss.reduce_contrastive_metrics(agg)
    zero = dict.fromkeys(agg, 0.0)
    assert ploss.reduce_contrastive_metrics(zero) == jloss.reduce_contrastive_metrics(zero)


def test_criterion_is_registered_and_checks_its_weights():
    registry.populate()
    assert registry.CRITERIONS.get("contrastive_loss") is ploss.ContrastiveCriterion
    assert registry.TASKS.get("contrastive_learning") is ContrastiveLearningTask
    with pytest.raises(ValueError, match="mutually exclusive"):
        ploss.ContrastiveCriterion(soft_negative_weight=0.5)
    ploss.ContrastiveCriterion(soft_negative_weight=0.5, adaptive_soft_negative_weight=False)


def test_synthetic_contrastive_items_equal_jax():
    kw = dict(seed=5, min_nodes=3, max_nodes=9, seq_len=12, vocab_size=100, image_shape=(3, 8, 8), image_prob=0.4)
    got = psyn.synthetic_batch_items(10, contrastive=True, **kw)
    want = jsyn.synthetic_batch_items(10, contrastive=True, **kw)
    for a, b in zip(got, want):
        assert a.y_mask is None and b.y_mask is None
        for name in ("input_ids", "attention_mask", "spatial_pos", "distance", "in_degree", "x_images",
                     "x_image_index", "y", "hard_y"):
            x, w = getattr(a, name), getattr(b, name)
            assert x.dtype == w.dtype, name
            np.testing.assert_array_equal(x, w, err_msg=name)


@pytest.mark.parametrize("pad_to_graphs", [None, 6])
def test_contrastive_collate_and_all_pad_like_equal_jax(pad_to_graphs):
    items = psyn.synthetic_batch_items(4, seed=2, contrastive=True, **SYN)
    jitems = jsyn.synthetic_batch_items(4, seed=2, contrastive=True, **SYN)
    kw = dict(pad_to_graphs=pad_to_graphs, image_shape=IMG, node_buckets=(8,), node_capacity_buckets=(64,),
              image_capacity_buckets=(0, 16))
    got = pcollator.collate(items, contrastive=True, **kw).asdict()
    want = jcollator.collate(jitems, contrastive=True, **kw).asdict()
    assert got.keys() == want.keys()
    b = pad_to_graphs or 4
    assert got["y"].shape == (b,) and got["y"].dtype == np.float32 and got["hard_y"].shape == (b,)
    assert got["y_node"].shape == (0,) and got["y_slot_mask"].shape == (0,)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pad, jpad = pcollator.all_pad_like(got), jcollator.all_pad_like(want)
    for k in jpad:
        assert pad[k].dtype == jpad[k].dtype and pad[k].shape == got[k].shape, k
        np.testing.assert_array_equal(pad[k], jpad[k], err_msg=k)
    assert (pad["idx"] == -1).all() and not pad["grid_mask"].any() and pad["y_node"].shape == (0,)


def contrastive_cfg(mod, **kw):
    """The same contrastive TrainConfig in either package: tiny model with
    every dropout at 0, batch 4 x update_freq 2, single-entry ladders."""
    m = mod.tiny_model_config(dropout=0.0, attention_dropout=0.0, act_dropout=0.0)
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    m = m.replace(text_tower=dataclasses.replace(m.text_tower, **no_drop),
                  image_tower=dataclasses.replace(m.image_tower, **no_drop))
    base = dict(
        model=m, task="contrastive_learning", criterion="contrastive_loss",
        data=mod.DataConfig(batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(64,),
                            image_capacity_buckets=(16,), label_capacity_buckets=(32,)),
        optim=mod.OptimConfig(lr=1e-3, warmup_updates=2, total_num_update=20, update_freq=2),
        task_cfg=mod.TaskConfig(dataset_name="synthetic", seed=0), log_interval=100, validate_interval_updates=0,
    )
    base.update(kw)
    return mod.TrainConfig(**base)


def jax_state(jtrainer, params):
    """The JAX ``TrainState`` that ``jtrainer.init_state`` would build, from
    a Flax params tree (e.g. ``to_flax_params`` of the port's model) instead
    of the JAX model's own eager init (~20 s on the CPU), with every scalar
    placed replicated over the mesh as the JAX step returns it, so that the
    step compiles once."""
    from jax.sharding import NamedSharding, PartitionSpec

    from multimodaldiscussiontransformer_tpu.parallel.mesh import shard_params
    from multimodaldiscussiontransformer_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from multimodaldiscussiontransformer_tpu.train.trainer import TrainState as JaxTrainState

    cfg = jtrainer.cfg
    params = shard_params(jtrainer.mesh, jax.tree.map(jnp.asarray, params))
    jtrainer.tx = jax_make_optimizer(cfg.optim, params, freeze_initial_encoders=cfg.model.freeze_initial_encoders,
                                     wrap_multisteps=not cfg.optim.scan_microbatches)
    rep = NamedSharding(jtrainer.mesh, PartitionSpec())
    scalar = lambda v: jax.device_put(jnp.asarray(v, jnp.int32), rep)  # noqa: E731
    opt_state = jax.tree.map(lambda x: jax.device_put(x, rep) if x.ndim == 0 else x, jtrainer.tx.init(params))
    return JaxTrainState(step=scalar(0), params=params, opt_state=opt_state,
                         rng=jax.device_put(jax.random.PRNGKey(cfg.seed), rep), epoch=scalar(0))


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_contrastive_update_and_evaluation_match_jax(tmp_path):
    """One scan update of 2 microbatches: the normalized accumulated
    gradients against JAX ``_make_train_step_scan(return_grads=True)`` (the
    last graph stack now trains: it feeds the global embedding), the
    parameters after AdamW two-tier, then the reduced evaluation metrics
    over a split whose last batch is padded with pad graphs."""
    jcfg = JaxContrastiveTask(contrastive_cfg(jconfig, fast_dropout_rng=False, save_dir=str(tmp_path))).cfg
    jtrainer = JaxTrainer(jcfg, mesh=make_mesh(1, 1), image_shape=IMG)
    assert jtrainer.contrastive
    jds = jsyn.synthetic_dataset(num_graphs=50, seed=0, contrastive=True, **SYN)
    jbatches = list(jtrainer.train_batches(jds, epoch=1))[:2]

    ptrainer = ContrastiveLearningTask(contrastive_cfg(pconfig, save_dir=str(tmp_path))).build_trainer(
        image_shape=IMG, device="cpu")
    assert ptrainer.contrastive and isinstance(ptrainer.criterion, ploss.ContrastiveCriterion)
    pstate = ptrainer.init_state()
    jstate = jax_state(jtrainer, to_flax_params(pstate.model))
    pds = psyn.synthetic_dataset(num_graphs=50, seed=0, contrastive=True, **SYN)
    pbatches = list(ptrainer.train_batches(pds, epoch=1))[:2]
    for a, b in zip(pbatches, jbatches):
        for k, v in b.asdict().items():
            np.testing.assert_array_equal(a.asdict()[k], v, err_msg=k)

    step = jtrainer._make_train_step_scan(return_grads=True)
    with jtrainer.mesh:
        jstate, jlogs = step(jstate, shard_stacked_batch(jtrainer.mesh, next(iter(jax_stack(iter(jbatches), 2)))))
    jlogs = jax.device_get(jlogs)
    plogs = ptrainer.train_step(pstate, next(iter(stack_microbatches(iter(pbatches), 2))), return_grads=True)

    jgrads = _flat(jlogs["grads"]["params"])
    pgrads = _flat(to_flax_params(pstate.model, plogs["grads"])["params"])
    last = [k for k in pgrads if k.startswith(f"graph_encoder/graph_stack_{ptrainer.cfg.model.num_fusion_stacks}/")]
    assert last and any(np.abs(pgrads[k]).max() > 0 for k in last), "the last graph stack gets a gradient"
    assert not np.abs(pgrads["node_classifier/kernel"]).any(), "the head is not read by the contrastive loss"
    for k, g in pgrads.items():
        atol = max(1e-6, 1e-5 * float(np.abs(jgrads[k]).max()))
        np.testing.assert_allclose(g, jgrads[k], rtol=2e-4, atol=atol, err_msg=k)
    for k in ("sample_size", "ncorrect", "positive_correct", "total_positive", "pred_positive"):
        assert int(plogs[k]) == int(jlogs[k]), k
    np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(plogs["gnorm"]), float(jlogs["gnorm"]), rtol=1e-5)

    lr0 = ptrainer.lr_schedule()(0)
    jparams = _flat(jax.device_get(jstate.params)["params"])
    for k, p in _flat(to_flax_params(pstate.model)["params"]).items():
        if k not in pgrads:  # frozen: never moves
            np.testing.assert_array_equal(p, jparams[k], err_msg=k)
            continue
        big = np.abs(pgrads[k]) > 1e-4
        np.testing.assert_allclose(p[big], jparams[k][big], rtol=2e-4, atol=2e-5, err_msg=k)
        assert (np.abs(p[~big] - jparams[k][~big]) <= 2.05 * lr0 + 1e-7).all(), k

    assert len(pds.valid_idx) % 4  # a ragged last batch: pad graphs in it
    want = jtrainer.evaluate(jstate, jds, "valid")
    got = ptrainer.evaluate(pstate, pds, "valid")
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="per-graph targets"):
        ptrainer.predict(pstate, pds, "valid")


def test_two_stage_transfer_through_the_launcher(tmp_path, monkeypatch, capsys):
    """Contrastive pre-training saves a checkpoint; the node task restores
    it with ``--reset-optimizer``. Before its first update every parameter
    but the new head equals the checkpoint's, bit for bit; the head is drawn
    afresh; the node task then trains from there."""
    pre = tmp_path / "pre"
    argv = ["--synthetic", "--tiny", "--device", "cpu", "--batch-size", "4", "--log-interval", "1"]
    assert launch.main(argv + ["--task", "contrastive_learning", "--max-updates", "2", "--save-dir", str(pre)]) == 0
    assert "'precision'" in capsys.readouterr().out
    saved = ckpt.Checkpointer(str(pre)).restore()["params"]

    first = {}
    orig = Trainer.train_step

    def record(trainer, state, group, **kw):
        if not first:
            first.update({k: v.detach().clone() for k, v in state.model.state_dict().items()})
        return orig(trainer, state, group, **kw)

    monkeypatch.setattr(Trainer, "train_step", record)
    assert launch.main(argv + ["--restore-file", str(pre), "--reset-optimizer", "--max-updates", "1",
                               "--save-dir", str(tmp_path / "node")]) == 0
    assert f"restored from {pre}" in capsys.readouterr().out
    head = {k for k in saved if k.startswith("node_classifier.")}
    assert head == {"node_classifier.weight", "node_classifier.bias"}
    for k, v in saved.items():
        if k in head:
            assert not torch.equal(first[k], v) or k.endswith("bias"), k
        else:
            assert torch.equal(first[k], v), k
    assert not first["node_classifier.bias"].any()


def test_launch_contrastive_eval_only_refuses_predictions(tmp_path, capsys):
    argv = ["--synthetic", "--tiny", "--device", "cpu", "--batch-size", "4", "--task", "contrastive_learning",
            "--save-dir", str(tmp_path)]
    assert launch.main(argv + ["--max-updates", "1"]) == 0
    capsys.readouterr()
    assert launch.main(argv + ["--eval-only", "--predict-output", str(tmp_path / "pred")]) == 1
    captured = capsys.readouterr()
    assert "valid:" in captured.out
    assert "--predict-output needs the node task" in captured.err
