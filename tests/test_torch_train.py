"""The port's training path against the JAX package, on the CPU in float32:
loss and metric reduction, the lr schedule, the AdamW update with frozen
leaves, the scan-semantics train step at the tiny config (weights carried
across with ``utils/flax_import.py``), ``Trainer.fit``/``evaluate``, the
launcher, and the analytic FLOPs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.data.loader import stack_microbatches as jax_stack
from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic_dataset
from multimodaldiscussiontransformer_tpu.losses import node_cross_entropy as jloss
from multimodaldiscussiontransformer_tpu.parallel.mesh import make_mesh, shard_stacked_batch
from multimodaldiscussiontransformer_tpu.train import optimizer as joptim
from multimodaldiscussiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from multimodaldiscussiontransformer_tpu.utils import flops as jflops
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.loader import stack_microbatches
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_dataset
from multimodaldiscussiontransformer_tpu_torch.losses import node_cross_entropy as ploss
from multimodaldiscussiontransformer_tpu_torch.train import launch
from multimodaldiscussiontransformer_tpu_torch.train import optimizer as poptim
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer
from multimodaldiscussiontransformer_tpu_torch.utils import flops as pflops
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict, to_flax_params

torch.set_num_threads(2)
IMG = (3, 32, 32)
SYN = dict(seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8)


def train_cfg(mod, **kw):
    """The same TrainConfig in either package: tiny model with every
    dropout at 0, batch 4 x update_freq 3, single-entry ladders."""
    m = mod.tiny_model_config(dropout=0.0, attention_dropout=0.0, act_dropout=0.0)
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    m = m.replace(
        text_tower=dataclasses.replace(m.text_tower, **no_drop), image_tower=dataclasses.replace(m.image_tower, **no_drop)
    )
    base = dict(
        model=m,
        data=mod.DataConfig(
            batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(64,),
            image_capacity_buckets=(16,), label_capacity_buckets=(32,),
        ),
        optim=mod.OptimConfig(lr=1e-3, warmup_updates=2, total_num_update=20, update_freq=3),
        task_cfg=mod.TaskConfig(dataset_name="synthetic", seed=0),
        log_interval=100,
        validate_interval_updates=0,
    )
    base.update(kw)
    return mod.TrainConfig(**base)


def test_loss_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((12, 2)).astype(np.float32)
    y = rng.integers(0, 2, 8).astype(np.int32)
    y_node = np.concatenate([rng.integers(0, 12, 5), [12, 12, 12]]).astype(np.int32)  # pad -> C
    mask = np.arange(8) < 5
    want = jloss.node_cross_entropy_loss(*(jnp.asarray(a) for a in (logits, y, y_node, mask)), 1.5, 1.0)
    got = ploss.node_cross_entropy_loss(*(torch.from_numpy(a) for a in (logits, y, y_node, mask)), 1.5, 1.0)
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-6)
    assert int(got[1]) == int(want[1]) == 5
    for k, v in want[2].items():
        np.testing.assert_allclose(float(got[2][k]), float(v), rtol=1e-6, err_msg=k)
    agg = {k: float(v) for k, v in want[2].items()}
    assert ploss.reduce_node_metrics(agg) == jloss.reduce_node_metrics(agg)
    zero = dict.fromkeys(agg, 0.0)
    assert ploss.reduce_node_metrics(zero) == jloss.reduce_node_metrics(zero)


def test_schedule_matches_jax():
    args = (3e-5, 3e-7, 5, 20, 1.0)
    want = jax.jit(jax.vmap(joptim.polynomial_decay_schedule(*args)))(jnp.arange(25))
    got = [poptim.polynomial_decay_schedule(*args)(n) for n in range(25)]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_adamw_update_matches_optax_with_frozen_leaves():
    """Three updates of the same params and grads: the port's AdamW with the
    schedule's lr against ``make_optimizer``'s optax chain; decay reaches
    every trainable leaf, biases included; frozen leaves do not move."""
    rng = np.random.default_rng(1)
    shapes = {"graph_encoder.text_model.w": (3, 4), "head.w": (4, 2), "head.b": (2,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    cfg_j = jconfig.OptimConfig(lr=1e-2, warmup_updates=2, total_num_update=10, weight_decay=0.1)
    cfg_p = pconfig.OptimConfig(**dataclasses.asdict(cfg_j))

    def nest(flat):
        return {"graph_encoder": {"text_model": {"w": flat["graph_encoder.text_model.w"]}},
                "head": {"w": flat["head.w"], "b": flat["head.b"]}}

    params = jax.tree.map(jnp.asarray, nest(init))
    tx = joptim.make_optimizer(cfg_j, params, freeze_initial_encoders=True, wrap_multisteps=False)
    labels = joptim.trainable_mask(params, True)
    st = tx.init(params)
    for g in grads:
        updates, st = tx.update(jax.tree.map(jnp.asarray, nest(g)), st, params)
        params = joptim.apply_updates_trainable(params, updates, labels)

    root = nn.Module()
    root.graph_encoder = nn.Module()
    root.graph_encoder.text_model = nn.Module()
    root.head = nn.Module()
    for k, v in init.items():
        owner = root.get_submodule(k.rsplit(".", 1)[0])
        setattr(owner, k.rsplit(".", 1)[1], nn.Parameter(torch.from_numpy(v.copy())))
    trainable = poptim.apply_freeze(root, True)
    assert len(trainable) == 2
    opt = poptim.make_optimizer(cfg_p, trainable)
    sched = poptim.polynomial_decay_schedule(cfg_p.lr, cfg_p.end_learning_rate, cfg_p.warmup_updates, cfg_p.total_num_update)
    named = dict(root.named_parameters())
    for n, g in enumerate(grads):
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k]) if p.requires_grad else None
        for group in opt.param_groups:
            group["lr"] = sched(n)
        opt.step()
    want = {"graph_encoder.text_model.w": params["graph_encoder"]["text_model"]["w"],
            "head.w": params["head"]["w"], "head.b": params["head"]["b"]}
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(named["graph_encoder.text_model.w"].detach().numpy(), init["graph_encoder.text_model.w"])


def test_scan_step_matches_jax():
    """One update over the same 3 microbatches: the port's accumulated,
    normalized gradients against JAX ``_make_train_step_scan(return_grads=
    True)`` (rtol 2e-4, atol 1e-6: float32 sums in other orders), then the
    parameters after AdamW, two-tier as ``tests/test_scan_microbatches.py``
    compares them (Adam's first step is lr * g / (|g| + eps): where |g| is
    at the noise floor the sign may flip, so there the gap is only bounded
    by 2 lr)."""
    assert_scan_step_matches_jax(train_cfg(jconfig, fast_dropout_rng=False), train_cfg(pconfig))


def assert_scan_step_matches_jax(jcfg, pcfg):
    """The body of ``test_scan_step_matches_jax`` for any pair of equal
    TrainConfigs (both with every dropout at 0)."""
    jtrainer = JaxTrainer(jcfg, mesh=make_mesh(1, 1), image_shape=IMG)
    jbatches = list(jtrainer.train_batches(jax_synthetic_dataset(num_graphs=40, seed=0, **SYN), epoch=1))[:3]
    jstate = jtrainer.init_state(jbatches[0].asdict())
    params = jax.device_get(jstate.params)

    ptrainer = Trainer(pcfg, image_shape=IMG, device="cpu")
    pstate = ptrainer.load_params(ptrainer.init_state(), flax_to_state_dict(params))
    pbatches = list(ptrainer.train_batches(synthetic_dataset(num_graphs=40, seed=0, **SYN), epoch=1))[:3]
    for a, b in zip(pbatches, jbatches):
        for k, v in b.asdict().items():
            np.testing.assert_array_equal(a.asdict()[k], v, err_msg=k)

    step = jtrainer._make_train_step_scan(return_grads=True)
    with jtrainer.mesh:
        jstate, jlogs = step(jstate, shard_stacked_batch(jtrainer.mesh, next(iter(jax_stack(iter(jbatches), 3)))))
    jlogs = jax.device_get(jlogs)
    plogs = ptrainer.train_step(pstate, next(iter(stack_microbatches(iter(pbatches), 3))), return_grads=True)

    flat = lambda tree: {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)  # noqa: E731
                         for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    jgrads = flat(jlogs["grads"]["params"])
    pgrads = flat(to_flax_params(pstate.model, plogs["grads"])["params"])
    assert len(pgrads) > 50 and not any("text_model" in k or "vit_model" in k for k in pgrads)
    for k, g in pgrads.items():
        np.testing.assert_allclose(g, jgrads[k], rtol=2e-4, atol=1e-6, err_msg=k)
    for k in ("loss", "sample_size", "ncorrect", "gnorm"):
        np.testing.assert_allclose(float(plogs[k]), float(jlogs[k]), rtol=1e-5, err_msg=k)

    lr0 = ptrainer.lr_schedule()(0)
    jparams = flat(jax.device_get(jstate.params)["params"])
    for k, p in flat(to_flax_params(pstate.model)["params"]).items():
        if k not in pgrads:  # frozen: never moves
            np.testing.assert_array_equal(p, jparams[k], err_msg=k)
            continue
        big = np.abs(pgrads[k]) > 1e-4
        np.testing.assert_allclose(p[big], jparams[k][big], rtol=2e-4, atol=2e-5, err_msg=k)
        assert (np.abs(p[~big] - jparams[k][~big]) <= 2.05 * lr0 + 1e-7).all(), k


def test_train_record_logs_each_updates_gradient_norm(tmp_path):
    """With log_interval 1 each train record of metrics.jsonl carries its
    update's gnorm, as FairSeq's train log does: the first equals
    ``train_step``'s on the same first group from the same init."""
    import json

    cfg = train_cfg(pconfig, save_dir=str(tmp_path), log_interval=1)
    ds = synthetic_dataset(num_graphs=40, seed=4, **SYN)
    Trainer(cfg, image_shape=IMG, device="cpu").fit(ds, max_updates=2, log_fn=lambda s: None)
    records = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    gnorms = [r["gnorm"] for r in records if r["split"] == "train"]
    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    logs = trainer.train_step(trainer.init_state(), next(iter(stack_microbatches(trainer.train_batches(ds, 1), 3))))
    assert len(gnorms) == 2 and all(np.isfinite(gnorms))
    assert gnorms[0] == float(logs["gnorm"])


def test_pad_tail_group_gives_the_short_groups_update():
    """All-pad microbatches add exactly nothing: the update of a ragged
    group padded to k equals the short group's, bit for bit."""
    trainer = Trainer(train_cfg(pconfig), image_shape=IMG, device="cpu")
    batches = list(trainer.train_batches(synthetic_dataset(num_graphs=40, seed=4, **SYN), epoch=1))[:2]
    short = next(iter(stack_microbatches(iter(batches), 3)))
    padded = next(iter(stack_microbatches(iter(batches), 3, pad_tail=True)))
    assert short["idx"].shape[0] == 2 and padded["idx"].shape[0] == 3
    results = []
    for group in (short, padded):
        state = trainer.init_state()
        logs = trainer.train_step(state, group, return_grads=True)
        results.append((logs, {k: v.detach().clone() for k, v in state.model.state_dict().items()}))
    (ls, ps), (lp, pp) = results
    for k in ps:
        assert torch.equal(ps[k], pp[k]), k
    for k in ls["grads"]:
        assert torch.equal(ls["grads"][k], lp["grads"][k]), k
    assert float(ls["loss"]) == float(lp["loss"]) and int(ls["sample_size"]) == int(lp["sample_size"])


def test_fit_and_evaluate(tmp_path):
    """Three updates with dropout on (the tiny preset's towers drop at 0.1,
    the graph attention at 0.3): finite, the step counters advance, and
    ``evaluate`` returns the JAX package's metric keys."""
    m = pconfig.tiny_model_config(attention_dropout=0.3, dropout=0.1)
    cfg = train_cfg(pconfig, model=m, save_dir=str(tmp_path), log_interval=1)
    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    ds = synthetic_dataset(num_graphs=60, seed=1, **SYN)
    lines = []
    state = trainer.fit(ds, max_updates=3, log_fn=lines.append)
    assert state.num_updates == 3 and state.step == 9 and len(lines) == 3
    assert all(np.isfinite(float(ln.split("'loss': ")[1].split(",")[0])) for ln in lines)
    metrics = trainer.evaluate(state, ds, "valid")
    keys = set(jloss.reduce_node_metrics(dict.fromkeys(["loss", "sample_size", "num_positive_correct",
                                                        "total_positive", "num_pred_positive", "ncorrect"], 1.0)))
    assert set(metrics) == keys | {"steps_in_window"}
    assert np.isfinite(metrics["loss"])
    assert (tmp_path / "metrics.jsonl").read_text().count('"split": "train"') == 3


@pytest.mark.parametrize(
    "override",
    [dict(sp_size=2), dict(sp_size=2, dp_size=2), dict(sp_size=4, fsdp=True)],
)
def test_unsupported_trainer_settings_raise(override):
    """Sequence parallelism runs across ranks
    (tests/test_torch_sequence_parallel.py); one process with sp_size > 1
    raises ValueError, for too few ranks (fsdp: for no process group), and
    so does an sp axis without a sequence-parallel model."""
    cfg = train_cfg(pconfig, **override)
    with pytest.raises(ValueError, match="sequence_parallel=True"):
        Trainer(cfg, image_shape=IMG, device="cpu")
    cfg = cfg.replace(model=cfg.model.replace(sequence_parallel=True))
    with pytest.raises(ValueError, match="needs|not divisible|process group"):
        Trainer(cfg, image_shape=IMG, device="cpu")


def test_launch_main_tiny_on_cpu(tmp_path):
    argv = ["--synthetic", "--tiny", "--max-updates", "2", "--batch-size", "4", "--no-save",
            "--device", "cpu", "--save-dir", str(tmp_path), "--log-interval", "1"]
    assert launch.main(argv) == 0
    assert (tmp_path / "metrics.jsonl").read_text().count('"split": "train"') == 2


@pytest.mark.parametrize(
    "flags",
    [["--hf-init"], ["--sp-size", "2"]],
)
def test_launch_rejects_unported_flags(flags, capsys, tmp_path, monkeypatch):
    """No flag is refused as unported any more: ``--hf-init`` is ported
    and, as in JAX, ignored under ``--tiny`` (a run of one update, no HF
    checkpoint anywhere); ``--sp-size 2`` is ported, and one process is
    too few ranks for it (ValueError)."""
    argv = ["--synthetic", "--tiny", "--device", "cpu", "--no-save"] + flags
    if flags[0] == "--sp-size":
        with pytest.raises(ValueError, match="not divisible by tp=1 x sp=2"):
            launch.main(argv)
        return
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    assert launch.main(argv + ["--batch-size", "4", "--max-updates", "1", "--save-dir", str(tmp_path)]) == 0
    out = capsys.readouterr()
    assert "not ported yet" not in out.err and "initialized towers" not in out.out


def test_launch_config_matches_jax():
    """The canonical flags, the contrastive stage's, the optimizer
    settings' and the training runtime's flags resolve to the same
    TrainConfig in both launchers."""
    from multimodaldiscussiontransformer_tpu.train import launch as jlaunch

    canonical = ["--synthetic", "--freeze-initial-encoders", "--batch-size", "12", "--update-freq", "3", "--no-save"]
    for argv in (
        canonical,
        canonical + ["--task", "contrastive_learning", "--criterion", "contrastive_loss",
                     "--soft-negative-weight", "0.25", "--multiplication-scale", "10"],
        canonical + ["--no-scan-microbatches", "--bf16-adam-state"],
        canonical + ["--remat", "--remat-policy", "names_heavy", "--scan-layers", "--num-workers", "4",
                     "--profile-trace", "t", "--profile-steps", "3", "--tensorboard-logdir", "tb"],
        ["--synthetic", "--tiny", "--remat", "--remat-policy", "dots"],
    ):
        want = dataclasses.asdict(jlaunch.config_from_args(jlaunch.build_parser().parse_args(argv)))
        got = dataclasses.asdict(launch.config_from_args(launch.build_parser().parse_args(argv)))
        for section in ("model", "data", "optim", "task_cfg"):
            assert got[section] == want[section], (argv, section)
        for key in ("criterion", "task", "seed", "positive_weight", "negative_weight", "log_interval",
                    "soft_negative_weight", "adaptive_soft_negative_weight", "multiplication_scale",
                    "profile_trace_dir", "profile_trace_steps", "profile_trace_start"):
            assert got[key] == want[key], (argv, key)


@pytest.mark.parametrize("tiny", [False, True])
def test_flops_match_jax(tiny):
    jc = jconfig.tiny_model_config() if tiny else jconfig.ModelConfig()
    pc = pconfig.tiny_model_config() if tiny else pconfig.ModelConfig()
    for kw in (dict(batch=12, node_capacity=256, image_capacity=64, seq_len=100, max_nodes=32),
               dict(batch=2, node_capacity=32, image_capacity=0, seq_len=16, max_nodes=8)):
        assert pflops.train_step_flops(pc, **kw) == jflops.train_step_flops(jc, **kw)
        assert pflops.train_step_flops(pc.replace(remat=True, freeze_initial_encoders=False), **kw) == \
            jflops.train_step_flops(jc.replace(remat=True, freeze_initial_encoders=False), **kw)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    """clip_norm > 0: optax ``clip_by_global_norm`` semantics over the
    trainable gradients (scaled only where the norm reaches max_norm)."""
    import optax

    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    params = [nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    poptim.clip_by_global_norm_(params, max_norm)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)
