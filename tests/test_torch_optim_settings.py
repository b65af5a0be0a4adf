"""The trainer, optimizer and model settings that the port took over from
the JAX package in one slice, held against it on the CPU at the tiny
config:
- MultiSteps (``update_freq > 1`` with ``scan_microbatches`` off): updates
  against the JAX ``Trainer.fit`` with its optax ``MultiSteps`` optimizer,
  an epoch tail carried into the next epoch, a stop between two
  microbatches of one update resumed bit-equal;
- ``bf16_adam_state``: the moments and parameters of three steps against
  JAX ``scale_by_adam_bf16_state``, a launcher run, a bit-exact checkpoint
  round trip;
- ``param_dtype="bfloat16"``: the JAX model's bf16 params carried across
  bit for bit both ways, the forward, one AdamW update.

Tolerances are stated at each test."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from torch import nn

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.data.loader import stack_microbatches as jax_stack
from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic_dataset
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu.parallel.mesh import make_mesh, shard_stacked_batch
from multimodaldiscussiontransformer_tpu.train import optimizer as joptim
from multimodaldiscussiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.loader import stack_microbatches
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_dataset
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.train import launch
from multimodaldiscussiontransformer_tpu_torch.train import optimizer as poptim
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer
from multimodaldiscussiontransformer_tpu_torch.utils import checkpoints as ckpt
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict, to_flax_params
from test_torch_contrastive import jax_state

torch.set_num_threads(2)
IMG = (3, 32, 32)
SYN = dict(seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8)


def train_cfg(mod, **kw):
    """The same node-task TrainConfig in either package: tiny model with
    every dropout at 0 and the graph attention's plain path (JAX's Pallas
    interpret mode would cost minutes per step here), batch 4 x
    update_freq 3, single-entry ladders, Adam's eps at 1e-6 so that no
    gradient at the float32 noise floor flips the sign of an update."""
    m = mod.tiny_model_config(dropout=0.0, attention_dropout=0.0, act_dropout=0.0, use_pallas_attention=False)
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    m = m.replace(text_tower=dataclasses.replace(m.text_tower, **no_drop),
                  image_tower=dataclasses.replace(m.image_tower, **no_drop))
    optim = dict(lr=1e-3, warmup_updates=2, total_num_update=20, update_freq=3, adam_eps=1e-6)
    optim.update(kw.pop("optim", {}))
    base = dict(
        model=m,
        data=mod.DataConfig(batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(64,),
                            image_capacity_buckets=(16,), label_capacity_buckets=(32,)),
        optim=mod.OptimConfig(**optim),
        task_cfg=mod.TaskConfig(dataset_name="synthetic", seed=0), log_interval=100, validate_interval_updates=0,
    )
    base.update(kw)
    return mod.TrainConfig(**base)


def _quiet(msg):
    pass


# -- MultiSteps ------------------------------------------------------------------


def test_multisteps_updates_match_jax_and_carry_across_the_epoch(tmp_path):
    """25 graphs: 20 train graphs, 5 batches of 4 an epoch, k = 3. Update 1
    takes batches 1-3 of epoch 1; update 2 takes batches 4-5 of epoch 1
    and batch 1 of epoch 2 (the partial mean carries over, no pad). The
    microbatches hold unequal numbers of labelled nodes, so the MultiSteps
    mean of per-microbatch normalized gradients is not the scan update's
    one division by the total: the two differ. Against the JAX
    ``Trainer.fit`` with optax ``MultiSteps``: parameters after each update
    rtol 2e-4, atol 2e-5 (float32 sums in other orders, as
    ``tests/test_torch_checkpoints.py``); each microbatch's ``gnorm`` rtol
    1e-5 on update 1's microbatches (the same weights, as the scan test)
    and 1e-4 after it (the weights then differ within the tolerance
    above); each logged update's lr and loss rtol 1e-6 and 1e-5."""
    pcfg = train_cfg(pconfig, optim=dict(scan_microbatches=False), save_dir=str(tmp_path / "p"), log_interval=1)
    jcfg = train_cfg(jconfig, optim=dict(scan_microbatches=False), save_dir=str(tmp_path / "j"), log_interval=1,
                     fast_dropout_rng=False)
    ptrainer = Trainer(pcfg, image_shape=IMG, device="cpu")
    pnorms, jnorms, plines, jlines = [], [], [], []

    def port_microstep(state, batch, _inner=ptrainer.train_microstep):
        logs = _inner(state, batch)
        pnorms.append(float(logs["gnorm"]))
        return logs

    ptrainer.train_microstep = port_microstep
    assert ptrainer.multi_steps
    ds = synthetic_dataset(num_graphs=25, seed=1, **SYN)
    assert len(ds.train_idx) == 20 and ptrainer.micro_per_epoch(ds) == 5
    sizes = [int(b.y_slot_mask.sum()) for b in list(ptrainer.train_batches(ds, 1))[:3]]
    assert len(set(sizes)) > 1, sizes
    init = ptrainer.init_state()
    start = {k: v.clone() for k, v in init.model.state_dict().items()}

    jtrainer = JaxTrainer(jcfg, mesh=make_mesh(1, 1), image_shape=IMG)
    jstate = jax_state(jtrainer, to_flax_params(init.model))
    jds = jax_synthetic_dataset(num_graphs=25, seed=1, **SYN)
    jax_step = jtrainer._make_train_step()

    def jax_microstep(state, batch):
        state, logs = jax_step(state, batch)
        jnorms.append(float(logs["gnorm"]))
        return state, logs

    jtrainer._train_step = jax_microstep
    # fit sets the epoch at an epoch's end as an unplaced scalar; placed as
    # the state's other scalars, the step is not compiled a second time
    rep = jax.sharding.NamedSharding(jtrainer.mesh, jax.sharding.PartitionSpec())
    jtrainer._rep_scalar = lambda v, dtype=jnp.int32: jax.device_put(jnp.asarray(v, dtype), rep)
    state = init
    for n in (1, 2):
        jstate = jtrainer.fit(jds, state=jstate, max_updates=n, log_fn=jlines.append)
        state = ptrainer.fit(ds, state=state, max_updates=n, log_fn=plines.append)
        assert (state.num_updates, state.step, state.mini_step) == (n, 3 * n, 0)
        assert int(jstate.step) == 3 * n
        want = flax_to_state_dict(jax.device_get(jstate.params))
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=2e-4, atol=2e-5, err_msg=f"update {n}: {k}")
    assert state.epoch == 1  # update 2 ended in epoch 2, which is not complete
    assert len(pnorms) == len(jnorms) == 6
    np.testing.assert_allclose(pnorms[:3], jnorms[:3], rtol=1e-5)
    np.testing.assert_allclose(pnorms[3:], jnorms[3:], rtol=1e-4)
    assert len(plines) == len(jlines) == 2

    def logged(line):
        return {k: float(v) for k, v in re.findall(r"'(lr|loss)': ([-0-9.e]+)", line)}

    for a, b in zip(plines, jlines):
        a, b = logged(a), logged(b)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)

    # the scan update over the same first 3 microbatches from the same weights differs
    scan = Trainer(train_cfg(pconfig, save_dir=str(tmp_path / "s")), image_shape=IMG, device="cpu")
    sstate = scan.load_params(scan.init_state(), start)
    scan.train_step(sstate, next(iter(stack_microbatches(scan.train_batches(ds, 1), 3))))
    one = Trainer(pcfg, image_shape=IMG, device="cpu")
    mstate = one.fit(ds, state=one.load_params(one.init_state(), start), max_updates=1, log_fn=_quiet)
    gap = max(float((sstate.model.state_dict()[k] - v).abs().max()) for k, v in mstate.model.state_dict().items())
    assert gap > 1e-4, gap


def test_multisteps_stop_mid_update_resumes_bit_equal(tmp_path):
    """A stop request after microbatch 4 (one into update 2) saves the
    partial mean (``acc_grads``, ``mini_step`` 1); a new trainer restores it
    and runs to update 3, bit-equal to the uninterrupted run, generators,
    moments and accumulator included. The checkpoint round-trips bit for
    bit."""
    cfg = train_cfg(pconfig, optim=dict(scan_microbatches=False), save_dir=str(tmp_path / "m"))
    ds = synthetic_dataset(num_graphs=25, seed=1, **SYN)
    whole = Trainer(cfg, image_shape=IMG, device="cpu").fit(ds, max_updates=3, log_fn=_quiet)

    saver = ckpt.Checkpointer(str(tmp_path / "ck"))
    calls = []
    first = Trainer(cfg, image_shape=IMG, device="cpu").fit(
        ds, max_updates=3, checkpointer=saver, log_fn=_quiet, should_stop=lambda: len(calls.append(1) or calls) >= 4)
    assert (first.step, first.num_updates, first.mini_step) == (4, 1, 1)
    saved = saver.restore()
    assert saved["mini_step"] == 1 and all(a.any() for a in saved["acc_grads"][:3])
    written = ckpt.state_dict_of(first)
    for a, b in zip(saved["acc_grads"], written["acc_grads"]):
        assert a.dtype == b.dtype and torch.equal(a, b)

    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    state = trainer.init_state(seed=99)
    state = ckpt.restore_params_into_state(trainer, state, saver.restore(state), reset_optimizer=False)
    assert state.mini_step == 1
    resumed = trainer.fit(ds, state=state, max_updates=3, log_fn=_quiet)
    assert (resumed.step, resumed.num_updates, resumed.mini_step) == (whole.step, whole.num_updates, 0) == (9, 3, 0)
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for a, b in zip(resumed.acc_grads, whole.acc_grads):
        assert torch.equal(a, b)
    sa, sb = resumed.optimizer.state_dict()["state"], whole.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    assert torch.equal(resumed.host_rng.get_state(), whole.host_rng.get_state())

    # --reset-optimizer starts the accumulation afresh
    trainer.load_params(state, whole.model.state_dict())
    assert state.mini_step == 0 and not any(a.any() for a in state.acc_grads)


# -- bf16 Adam state -------------------------------------------------------------


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """One bf16 step (unit in the last place) at each value of ``x``."""
    x = np.abs(x.astype(np.float32))
    return np.where(x > 0, 2.0 ** (np.floor(np.log2(np.where(x > 0, x, 1.0))) - 7), 2.0**-133)


def _tiny_tree(rng):
    shapes = {"graph_encoder.text_model.w": (3, 4), "head.w": (4, 2), "head.b": (2,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    return init, grads


def _nest(flat):
    return {"graph_encoder": {"text_model": {"w": flat["graph_encoder.text_model.w"]}},
            "head": {"w": flat["head.w"], "b": flat["head.b"]}}


def _module(init):
    root = nn.Module()
    root.graph_encoder = nn.Module()
    root.graph_encoder.text_model = nn.Module()
    root.head = nn.Module()
    for k, v in init.items():
        owner = root.get_submodule(k.rsplit(".", 1)[0])
        setattr(owner, k.rsplit(".", 1)[1], nn.Parameter(torch.from_numpy(v.copy())))
    return root


def test_bf16_adam_state_matches_jax():
    """Three steps of the same params and gradients, frozen leaves
    included: the port's bf16-moment AdamW against ``make_optimizer``'s
    chain with ``scale_by_adam_bf16_state``. Moments are bf16 and within one
    bf16 step of JAX's (XLA may fuse the f32 recurrences into FMAs, so the
    rounding into bf16 can land one step apart); parameters within rtol
    1e-6, atol 3 lr 2^-8 (each step's update is lr m_hat / sqrt(v_hat) at
    most lr in size, and a moment one bf16 step apart moves it by at most
    2^-8 of that)."""
    rng = np.random.default_rng(1)
    init, grads = _tiny_tree(rng)
    cfg_j = jconfig.OptimConfig(lr=1e-2, warmup_updates=2, total_num_update=10, weight_decay=0.1, bf16_adam_state=True)
    cfg_p = pconfig.OptimConfig(**dataclasses.asdict(cfg_j))
    params = jax.tree.map(jnp.asarray, _nest(init))
    tx = joptim.make_optimizer(cfg_j, params, freeze_initial_encoders=True, wrap_multisteps=False)
    labels = joptim.trainable_mask(params, True)
    st = tx.init(params)
    for g in grads:
        updates, st = tx.update(jax.tree.map(jnp.asarray, _nest(g)), st, params)
        params = joptim.apply_updates_trainable(params, updates, labels)
    mu, nu = optax.tree_utils.tree_get(st, "mu"), optax.tree_utils.tree_get(st, "nu")

    root = _module(init)
    trainable = poptim.apply_freeze(root, True)
    opt = poptim.make_optimizer(cfg_p, trainable)
    assert isinstance(opt, poptim.OptaxAdamW)
    sched = poptim.polynomial_decay_schedule(cfg_p.lr, cfg_p.end_learning_rate, cfg_p.warmup_updates,
                                             cfg_p.total_num_update)
    named = dict(root.named_parameters())
    for n, g in enumerate(grads):
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k]) if p.requires_grad else None
        for group in opt.param_groups:
            group["lr"] = sched(n)
        opt.step()
    want = {"graph_encoder.text_model.w": params["graph_encoder"]["text_model"]["w"],
            "head.w": params["head"]["w"], "head.b": params["head"]["b"]}
    for k in ("head.w", "head.b"):
        st_p = opt.state[named[k]]
        assert st_p["exp_avg"].dtype == st_p["exp_avg_sq"].dtype == torch.bfloat16 and st_p["step"] == 3
        leaf = k.split(".")[1]
        for got, ref in ((st_p["exp_avg"], mu["head"][leaf]), (st_p["exp_avg_sq"], nu["head"][leaf])):
            ref = np.asarray(ref).astype(np.float32)
            assert np.asarray(ref).dtype == np.float32 and mu["head"][leaf].dtype == jnp.bfloat16
            assert (np.abs(got.float().numpy() - ref) <= _bf16_step(ref)).all(), k
        np.testing.assert_allclose(named[k].detach().numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=3 * cfg_p.lr * 2**-8, err_msg=k)
    np.testing.assert_array_equal(named["graph_encoder.text_model.w"].detach().numpy(), init["graph_encoder.text_model.w"])


def test_bf16_adam_state_through_the_launcher(tmp_path):
    """``--bf16-adam-state`` trains the tiny model on the CPU; its
    checkpoint holds bf16 moments and restores bit for bit."""
    argv = ["--synthetic", "--tiny", "--device", "cpu", "--batch-size", "4", "--max-updates", "1",
            "--bf16-adam-state", "--save-dir", str(tmp_path)]
    assert launch.main(argv) == 0
    saved = ckpt.Checkpointer(str(tmp_path)).restore()
    moments = [v for st in saved["optimizer"]["state"].values() for key, v in st.items() if key != "step"]
    assert moments and all(m.dtype == torch.bfloat16 for m in moments)
    assert any(m.any() for m in moments)

    cfg = launch.config_from_args(launch.build_parser().parse_args(argv))
    trainer = Trainer(cfg, image_shape=(3, 32, 32), device="cpu")
    state = ckpt.restore_params_into_state(trainer, trainer.init_state(seed=5), saved, reset_optimizer=False)
    again = ckpt.state_dict_of(state)["optimizer"]
    for i, st in saved["optimizer"]["state"].items():
        for key, v in st.items():
            w = again["state"][i][key]
            assert (v == w) if key == "step" else (w.dtype == v.dtype and torch.equal(w, v)), (i, key)


# -- bf16 params -----------------------------------------------------------------


def test_bf16_params_carry_across_and_train_like_jax():
    """``param_dtype="bfloat16"`` in both packages (compute in float32):
    - the port's bf16 params have the JAX model's tree, leaf for leaf in
      shape and dtype (``jax.eval_shape`` of its init: bf16 everywhere),
      and cross to JAX arrays and back with the same bits;
    - the forward's per-node logits within 1e-2 of max |ref| (the bf16
      tolerance used across the port);
    - one scan update with AdamW on bf16 params, moments and arithmetic in
      bf16 on both sides, two-tier as the float32 scan test: bf16 gradients
      summed in other orders differ by far more than float32 ones, and
      Adam's first step is ~lr sign(g). Where JAX's gradient exceeds 1e-4
      and both gradients have one sign (at least 3/4 of the elements),
      within two bf16 steps of the parameter plus 2^-7 lr (the update's own
      bf16 rounding on each side; XLA may also keep bf16 intermediates in
      f32 inside a fusion where the port rounds after every op); elsewhere
      within 2.05 lr plus two bf16 steps."""
    jcfg = train_cfg(jconfig, fast_dropout_rng=False)
    jcfg = jcfg.replace(model=jcfg.model.replace(param_dtype="bfloat16"))
    pcfg = train_cfg(pconfig)
    pcfg = pcfg.replace(model=pcfg.model.replace(param_dtype="bfloat16"))
    jtrainer = JaxTrainer(jcfg, mesh=make_mesh(1, 1), image_shape=IMG)
    jbatches = list(jtrainer.train_batches(jax_synthetic_dataset(num_graphs=40, seed=0, **SYN), epoch=1))[:3]
    model = JaxMDTModel(jcfg.model, dtype=jnp.float32, param_dtype=jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in jbatches[0].asdict().items()}
    shapes = jax.eval_shape(lambda r, b: model.init(r, b, deterministic=True), jax.random.PRNGKey(0), jb)
    want = {path: (v.shape, v.dtype) for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {d for _, d in want.values()} == {np.dtype(ml_dtypes.bfloat16)}

    pmodel = MDTModel(pcfg.model)
    assert all(p.dtype == torch.bfloat16 for p in pmodel.parameters())
    sd = {k: v.clone() for k, v in pmodel.state_dict().items()}
    tree = to_flax_params(pmodel)
    got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert {path: (v.shape, v.dtype) for path, v in got.items()} == want
    jparams = jax.device_get(jax.tree.map(jnp.asarray, tree))  # through JAX arrays and back
    back = flax_to_state_dict(jparams)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k].view(torch.int16), v.view(torch.int16)), k

    want = np.asarray(jax.jit(lambda p, b: model.apply(p, b, deterministic=True).logits)(jparams, jb))
    with torch.no_grad():
        got = pmodel(to_tensors(jbatches[0].asdict(), "cpu")).logits.float().numpy()
    real = jbatches[0].node_mask
    assert np.abs(got[real] - want[real]).max() <= 1e-2 * np.abs(want[real]).max()

    ptrainer = Trainer(pcfg, image_shape=IMG, device="cpu")
    pstate = ptrainer.load_params(ptrainer.init_state(), sd)
    assert isinstance(pstate.optimizer, poptim.OptaxAdamW)
    jstate = jax_state(jtrainer, jparams)
    step = jtrainer._make_train_step_scan(return_grads=True)
    with jtrainer.mesh:
        jstate, jlogs = step(jstate, shard_stacked_batch(jtrainer.mesh, next(iter(jax_stack(iter(jbatches), 3)))))
    plogs = ptrainer.train_step(pstate, next(iter(stack_microbatches(iter(ptrainer.train_batches(
        synthetic_dataset(num_graphs=40, seed=0, **SYN), 1)), 3))), return_grads=True)
    np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), rtol=1e-2)
    after = flax_to_state_dict(jax.device_get(jstate.params))
    jgrads = flax_to_state_dict(jax.device_get(jlogs["grads"]))
    lr = ptrainer.lr_schedule()(0)
    moved, tier1, trained = 0, 0, 0
    for k, v in pstate.model.state_dict().items():
        ref, got = after[k].float().numpy(), v.float().numpy()
        assert v.dtype == torch.bfloat16
        moved += int((v != sd[k]).sum())
        if k not in plogs["grads"]:  # frozen
            assert torch.equal(v, sd[k]), k
            continue
        gp, gj = plogs["grads"][k].float().numpy(), jgrads[k].float().numpy()
        clear = (np.abs(gj) > 1e-4) & (np.sign(gp) == np.sign(gj))
        err = np.abs(got - ref)
        assert (err[clear] <= 2 * _bf16_step(ref[clear]) + 2**-7 * lr).all(), k
        assert (err[~clear] <= 2.05 * lr + 2 * _bf16_step(ref[~clear])).all(), k
        tier1, trained = tier1 + int(clear.sum()), trained + clear.size
    assert moved > 0 and tier1 >= 0.75 * trained, (tier1, trained)
    st = next(iter(pstate.optimizer.state.values()))
    assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16
