"""JAX Orbax checkpoints into the port, on the CPU at the tiny config: a JAX
``Trainer`` run is saved by the JAX ``Checkpointer``, converted by
``tools/orbax_to_npz.py`` and restored by the port (``utils/checkpoints.py``:
``--restore-file X.npz``, ``DiscussionScorer.from_checkpoint``).

The JAX state is built from the port's weights (as
``tests/test_torch_contrastive.py::jax_state`` builds it), not by Flax init.
Tolerances: the forward within 1e-5 (float32; the graph attention's plain
path on both sides); the restored params and AdamW moments bit for bit; the
next update after the restore against JAX's next update rtol 2e-4, atol
2e-5 (as ``tests/test_torch_checkpoints.py::test_resumed_run_matches_jax_trainer``:
float32 sums in other orders, Adam's eps raised to 1e-6 on both sides)."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.data.collator import collate as jax_collate
from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_batch_items as jax_items
from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic_dataset
from multimodaldiscussiontransformer_tpu.parallel.mesh import make_mesh, shard_params
from multimodaldiscussiontransformer_tpu.train import optimizer as joptim
from multimodaldiscussiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from multimodaldiscussiontransformer_tpu.train.trainer import TrainState as JaxTrainState
from multimodaldiscussiontransformer_tpu.utils import checkpoints as jckpt
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import collate, to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_batch_items, synthetic_dataset
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.serve.incremental import DiscussionScorer
from multimodaldiscussiontransformer_tpu_torch.train import launch
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer
from multimodaldiscussiontransformer_tpu_torch.utils import checkpoints as ckpt
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict, to_flax_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("orbax_to_npz", os.path.join(ROOT, "tools", "orbax_to_npz.py"))
orbax_to_npz = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(orbax_to_npz)

IMG = (3, 32, 32)
SYN = dict(seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8)
DATA = dict(batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(64,),
            image_capacity_buckets=(16,), label_capacity_buckets=(32,))


def train_cfg(mod, **kw):
    """The same TrainConfig in either package: tiny model with every dropout
    at 0 and the graph attention's plain path, batch 4 x update_freq 3."""
    m = mod.tiny_model_config(dropout=0.0, attention_dropout=0.0, act_dropout=0.0, use_pallas_attention=False)
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


def jax_state(jtrainer, model):
    """A fresh JAX ``TrainState`` holding the port model's weights."""
    from jax.sharding import NamedSharding, PartitionSpec

    params = shard_params(jtrainer.mesh, jax.tree.map(jnp.asarray, to_flax_params(model)))
    jtrainer.tx = joptim.make_optimizer(jtrainer.cfg.optim, params, freeze_initial_encoders=True, wrap_multisteps=False)
    rep = NamedSharding(jtrainer.mesh, PartitionSpec())
    scalar = lambda v: jax.device_put(jnp.asarray(v, jnp.int32), rep)  # noqa: E731
    opt_state = jax.tree.map(lambda x: jax.device_put(x, rep) if x.ndim == 0 else x, jtrainer.tx.init(params))
    return JaxTrainState(step=scalar(0), params=params, opt_state=opt_state,
                         rng=jax.device_put(jax.random.PRNGKey(0), rep), epoch=scalar(0))


def _quiet(msg):
    pass


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run of 2 updates saved by the JAX ``Checkpointer`` at step 2
    and converted; the same run's third update; the port's config and data."""
    tmp = tmp_path_factory.mktemp("orbax")
    jcfg = train_cfg(jconfig, fast_dropout_rng=False, save_dir=str(tmp / "j"))
    pcfg = train_cfg(pconfig, save_dir=str(tmp / "p"))
    init = MDTModel(pcfg.model, generator=torch.Generator().manual_seed(3))
    jtrainer = JaxTrainer(jcfg, mesh=make_mesh(1, 1), image_shape=IMG)
    jds = jax_synthetic_dataset(num_graphs=60, seed=1, **SYN)
    two = jtrainer.fit(jds, state=jax_state(jtrainer, init), max_updates=2, log_fn=_quiet)
    saver = jckpt.Checkpointer(str(tmp / "orbax"), async_save=False)
    saver.save(two, 2)
    saver.close()
    npz = str(tmp / "step2.npz")
    assert orbax_to_npz.convert(str(tmp / "orbax"), npz) == 2
    two_host = jax.device_get(two)  # the next fit donates two's buffers
    three = jtrainer.fit(jds, state=two, max_updates=3, log_fn=_quiet)
    return dict(jtrainer=jtrainer, two=two_host, three=jax.device_get(three), npz=npz, pcfg=pcfg,
                ds=synthetic_dataset(num_graphs=60, seed=1, **SYN), tmp=tmp)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _arrays_only(tree):
    """``tree`` without optax's ``MaskedNode`` leaves (the frozen params')."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _arrays_only(v)
            if v:
                out[k] = v
        elif hasattr(v, "shape"):
            out[k] = v
    return out


def test_converted_step_holds_params_moments_and_counters(jax_run):
    """The file's layout, and the port's reading of it: params and both
    moments equal the JAX state bit for bit (frozen towers have no
    moments), with the counters."""
    two = jax_run["two"]
    with np.load(jax_run["npz"]) as z:
        files = set(z.files)
        assert int(z["step"]) == 6 and int(z["num_updates"]) == 2 and int(z["opt/count"]) == 2
        assert int(z["epoch"]) == 0 and z["__bf16__"].size == 0 and "best_step" not in files
    assert {k[len("params/"):] for k in files if k.startswith("params/")} == set(_flat(two.params["params"]))
    mu = {k for k in files if k.startswith("opt/mu/")}
    assert mu and not any("text_model" in k or "vit_model" in k for k in mu)

    restored = ckpt.load_flax_npz(jax_run["npz"])
    want = flax_to_state_dict(two.params)
    assert set(restored["params"]) == set(want)
    for k, v in want.items():
        assert torch.equal(restored["params"][k], v), k
    adam = jax.tree_util.tree_leaves(two.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    adam = next(a for a in adam if hasattr(a, "mu"))
    for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        ref = flax_to_state_dict(_arrays_only(tree["params"]))
        got = restored["adam"][name]
        assert set(got) == {k for k in ref if not k.startswith(("graph_encoder.text_model", "graph_encoder.vit_model"))}
        for k in got:
            assert torch.equal(got[k], ref[k]), (name, k)


def test_forward_from_the_converted_step_matches_jax(jax_run):
    """``DiscussionScorer.from_checkpoint`` of the ``.npz`` against the JAX
    model's forward with the same params, within 1e-5."""
    jtrainer, two = jax_run["jtrainer"], jax_run["two"]
    kw = dict(spatial_pos_max=5, image_shape=IMG)
    jb = jax_collate(jax_items(3, seed=7, image_prob=0.5, **SYN), **kw)
    pb = collate(synthetic_batch_items(3, seed=7, image_prob=0.5, **SYN), **kw)
    forward = jax.jit(lambda p, b: jtrainer.model.apply(p, b, deterministic=True))
    want = forward(two.params, {k: jnp.asarray(v) for k, v in jb.asdict().items()})
    scorer = DiscussionScorer.from_checkpoint(jax_run["npz"], model_cfg=jax_run["pcfg"].model, device="cpu")
    with torch.no_grad():
        got = scorer.model(to_tensors(pb, "cpu"))
    mask = pb.node_mask
    np.testing.assert_allclose(got.logits.numpy()[mask], np.asarray(want.logits)[mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.global_embedding.numpy(), np.asarray(want.global_embedding), rtol=1e-5, atol=1e-5)


def test_next_update_after_restore_matches_jax(jax_run):
    """``--restore-file X.npz`` without ``--reset-optimizer``: the port
    resumes at update 2 with JAX's moments and takes update 3 as the JAX
    run does."""
    pcfg, ds = jax_run["pcfg"], jax_run["ds"]
    trainer = Trainer(pcfg, image_shape=IMG, device="cpu")
    state = trainer.init_state(seed=99)  # other weights: all replaced
    state = ckpt.restore_params_into_state(trainer, state, ckpt.restore_file(jax_run["npz"], state), reset_optimizer=False)
    assert (state.step, state.num_updates, state.epoch) == (6, 2, 0)
    assert isinstance(state.optimizer, torch.optim.AdamW)
    state = trainer.fit(ds, state=state, max_updates=3, log_fn=_quiet)
    assert state.num_updates == 3
    got = state.model.state_dict()
    want = flax_to_state_dict(jax_run["three"].params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("reset_optimizer", [False, True])
def test_launcher_restores_the_converted_step(jax_run, tmp_path, capsys, reset_optimizer):
    """The launcher's ``--restore-file X.npz``: resumed, it runs from update
    2 to 3; with ``--reset-optimizer`` it starts its counters afresh (and
    the node task's transfer resets the head) and runs 3 updates."""
    argv = ["--synthetic", "--tiny", "--device", "cpu", "--batch-size", "4", "--update-freq", "1",
            "--freeze-initial-encoders", "--log-interval", "1", "--restore-file", jax_run["npz"], "--max-updates", "3",
            "--save-dir", str(tmp_path)]
    assert launch.main(argv + (["--reset-optimizer"] if reset_optimizer else [])) == 0
    out = capsys.readouterr().out
    assert f"restored from {jax_run['npz']}" in out
    assert (" update 1:" in out) == reset_optimizer and " update 3:" in out
    restored = ckpt.Checkpointer(str(tmp_path)).restore()
    assert restored["num_updates"] == 3 and restored["optimizer"]["state"][0]["step"].item() == 3


def test_bf16_params_round_trip_bit_for_bit(tmp_path):
    """A bf16-param JAX state (``param_dtype="bfloat16"``) saved by Orbax and
    converted: its leaves are stored as uint16 bits and listed, and the port
    reads every param and moment back bit for bit; the port's own writer
    (``save_flax_npz``) writes the same file for the same state."""
    jcfg = train_cfg(jconfig, fast_dropout_rng=False)
    jcfg = jcfg.replace(model=jcfg.model.replace(param_dtype="bfloat16"))
    pcfg = train_cfg(pconfig)
    pcfg = pcfg.replace(model=pcfg.model.replace(param_dtype="bfloat16"))
    ptrainer = Trainer(pcfg, image_shape=IMG, device="cpu")
    pstate = ptrainer.init_state()
    assert all(p.dtype == torch.bfloat16 for p in pstate.model.parameters())
    jtrainer = JaxTrainer(jcfg, mesh=make_mesh(1, 1), image_shape=IMG)
    jstate = jax_state(jtrainer, pstate.model)
    saver = jckpt.Checkpointer(str(tmp_path / "orbax"), async_save=False)
    saver.save(jstate, 0)
    saver.close()
    npz = str(tmp_path / "bf16.npz")
    orbax_to_npz.convert(str(tmp_path / "orbax"), npz)
    with np.load(npz) as z:
        bf16 = set(z["__bf16__"].tolist())
        assert bf16 and all(z[k].dtype == np.uint16 for k in bf16)
        assert bf16 == {k for k in z.files if k.startswith(("params/", "opt/mu/", "opt/nu/"))}
    restored = ckpt.load_flax_npz(npz)
    own = pstate.model.state_dict()
    assert set(restored["params"]) == set(own)
    for k, v in own.items():
        assert restored["params"][k].dtype == torch.bfloat16 and torch.equal(restored["params"][k], v), k
    for moments in (restored["adam"]["exp_avg"], restored["adam"]["exp_avg_sq"]):
        assert moments and all(m.dtype == torch.bfloat16 and not m.any() for m in moments.values())

    mine = str(tmp_path / "port.npz")
    ckpt.save_flax_npz(mine, pstate)
    with np.load(npz) as a, np.load(mine) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
