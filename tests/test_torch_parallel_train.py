"""Training across 2 ranks over gloo on the CPU, against one process and
against the JAX package (tiny config, float32, dropout 0 unless the case is
about dropout).

One 2-rank group runs per module: ``tests/torch_parallel_worker.py`` runs
every scenario (dp=2, fsdp=2, tp=2, num_slices=2 with fsdp (HSDP),
MultiSteps at dp=2, the contrastive loss at dp=2, evaluation and
prediction, a checkpoint across world sizes, a stop request on one rank,
dropout masks) and writes what each returned; the cases below compare
those results. Each rank and the join have a time limit of their own, so
that a deadlock fails instead of hanging.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as w
from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.data.loader import stack_microbatches as jax_stack
from multimodaldiscussiontransformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic_dataset
from multimodaldiscussiontransformer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodaldiscussiontransformer_tpu.parallel.mesh import shard_stacked_batch
from multimodaldiscussiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import fast_dropout
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer, write_predictions
from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import Checkpointer, _full_optimizer_state
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict, to_flax_params

torch.set_num_threads(2)


def _one_update(cfg, k=3, contrastive=False):
    trainer = Trainer(cfg, image_shape=w.IMG, device="cpu")
    state = trainer.init_state()
    logs = trainer.train_step(state, w.first_group(trainer, w.dataset(contrastive), k))
    return {"logs": w.scalars(logs), "params": w.full_params(state), "state": state, "trainer": trainer}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(rank 0's results, rank 1's results, the one-process results, the
    results directory)."""
    out = str(tmp_path_factory.mktemp("ranks"))
    one = {"node8": _one_update(w.train_cfg(pconfig, batch_size=8)),
           "node4": _one_update(w.train_cfg(pconfig, batch_size=4))}
    # the one-process checkpoint the fsdp ranks restore
    saver = Checkpointer(os.path.join(out, "one"), async_save=False)
    saver.save(one["node8"]["state"], one["node8"]["state"].num_updates)
    saver.close()
    ranks = w.spawn(2, out)
    return ranks[0], ranks[1], one, out


def _init_params(cfg):
    return w.full_params(Trainer(cfg, image_shape=w.IMG, device="cpu").init_state())


@pytest.mark.parametrize("scenario, baseline", [("dp", "node8"), ("fsdp", "node8"), ("tp", "node4"),
                                                ("slices", "node8")])
def test_update_matches_one_process(run, scenario, baseline):
    """One update at dp=2, fsdp=2, tp=2 and num_slices=2 (HSDP): both ranks
    hold the same whole params, which equal the one-process update on the
    same global batch (the rank's slices sum to the global batch's loss,
    its gradients to the global gradient)."""
    r0, r1, one, _ = run
    want = one[baseline]
    mesh = {"dp": {"dp": 2, "tp": 1}, "fsdp": {"dp": 2, "tp": 1}, "tp": {"dp": 1, "tp": 2},
            "slices": {"dcn": 2, "dp": 1, "tp": 1}}[scenario]
    assert r0[scenario]["mesh"] == r1[scenario]["mesh"] == mesh
    for k, v in r0[scenario]["params"].items():
        torch.testing.assert_close(v, r1[scenario]["params"][k], rtol=0, atol=0, msg=k)
    for key in ("loss", "sample_size", "ncorrect", "gnorm"):
        np.testing.assert_allclose(r0[scenario]["logs"][key], want["logs"][key], rtol=1e-5, err_msg=key)
    init = _init_params(w.train_cfg(pconfig))
    lr0 = 1e-3 / 2
    for k, p in want["params"].items():
        got, ref, start = r0[scenario]["params"][k].numpy(), p.numpy(), init[k].numpy()
        step = np.abs(ref - start)
        big = step > 0.5 * lr0  # a full Adam step: its sign is not noise
        np.testing.assert_allclose(got[big], ref[big], rtol=2e-4, atol=2e-5, err_msg=k)
        assert (np.abs(got - ref) <= 2.05 * lr0 + 1e-7).all(), k


def test_dp_update_matches_jax_on_a_dp2_mesh(run):
    """The port's dp=2 update against the JAX ``Trainer`` on a
    ``make_mesh(dp_size=2)`` mesh of the virtual CPU devices, from the same
    weights, on the same global batches."""
    from test_torch_contrastive import jax_state

    r0, _, one, _ = run
    jcfg = w.train_cfg(jconfig, fast_dropout_rng=False)
    jtrainer = JaxTrainer(jcfg, mesh=jax_make_mesh(dp_size=2, devices=jax.devices()[:2]), image_shape=w.IMG)
    assert jtrainer.global_batch_size == 8
    init = _init_params(w.train_cfg(pconfig))
    model = one["node8"]["state"].model
    jstate = jax_state(jtrainer, to_flax_params(model, init))
    jbatches = list(jtrainer.train_batches(jax_synthetic_dataset(num_graphs=w.NUM_GRAPHS, seed=0, **w.SYN), epoch=1))[:3]
    step = jtrainer._make_train_step_scan()
    with jtrainer.mesh:
        jstate, jlogs = step(jstate, shard_stacked_batch(jtrainer.mesh, next(iter(jax_stack(iter(jbatches), 3)))))
    jlogs = jax.device_get(jlogs)
    for key in ("loss", "sample_size", "ncorrect", "gnorm"):
        np.testing.assert_allclose(r0["dp"]["logs"][key], float(jlogs[key]), rtol=1e-5, err_msg=key)
    jparams = flax_to_state_dict(jax.device_get(jstate.params))
    lr0 = 1e-3 / 2
    for k, ref in jparams.items():
        got, ref, start = r0["dp"]["params"][k].numpy(), ref.float().numpy(), init[k].numpy()
        big = np.abs(ref - start) > 0.5 * lr0
        np.testing.assert_allclose(got[big], ref[big], rtol=2e-4, atol=2e-5, err_msg=k)
        assert (np.abs(got - ref) <= 2.05 * lr0 + 1e-7).all(), k


def test_multisteps_at_dp2_matches_one_process(run):
    """MultiSteps (update_freq 3, one microbatch per step) at dp=2: each
    microbatch's logs (global sample size, gnorm of the global gradient)
    and the params after the update equal one process's."""
    r0, r1, _, _ = run
    cfg = w.train_cfg(pconfig, batch_size=8)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, scan_microbatches=False))
    trainer = Trainer(cfg, image_shape=w.IMG, device="cpu")
    state = trainer.init_state()
    logs = [w.scalars(trainer.train_microstep(state, b.asdict()))
            for b in list(trainer.train_batches(w.dataset(), epoch=1))[:3]]
    assert r0["multisteps"]["num_updates"] == r1["multisteps"]["num_updates"] == state.num_updates == 1
    for got, want in zip(r0["multisteps"]["logs"], logs):
        for key in ("loss", "sample_size", "gnorm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    for k, v in w.full_params(state).items():
        torch.testing.assert_close(r0["multisteps"]["params"][k], r1["multisteps"]["params"][k], rtol=0, atol=0)
        torch.testing.assert_close(r0["multisteps"]["params"][k], v, rtol=2e-4, atol=1.05e-3, msg=k)


def test_contrastive_loss_at_dp2_is_the_global_batch_loss(run):
    """The contrastive update at dp=2: the (8, 8) matrix over the global
    batch, as in one process (a per-rank (4, 4) matrix would be another
    loss)."""
    r0, r1, _, _ = run
    want = _one_update(w.contrastive_cfg(pconfig, batch_size=8), k=2, contrastive=True)
    for key in ("loss", "sample_size", "ncorrect", "positive_correct", "total_positive", "pred_positive", "gnorm"):
        np.testing.assert_allclose(r0["contrastive"]["logs"][key], want["logs"][key], rtol=1e-5, err_msg=key)
        assert r0["contrastive"]["logs"][key] == r1["contrastive"]["logs"][key]
    assert want["logs"]["sample_size"] > 32  # more pairs than two (4, 4) matrices hold
    for k, v in want["params"].items():
        torch.testing.assert_close(r0["contrastive"]["params"][k], v, rtol=2e-4, atol=1.05e-3, msg=k)


def test_eval_and_predict_at_dp2_match_one_process(run):
    """The summed evaluation metrics (node and contrastive, a ragged tail
    padded so that rank 1's last slice is all pad) and the prediction CSV's
    bytes at dp=2 equal one process's."""
    r0, r1, _, out = run
    trainer = Trainer(w.train_cfg(pconfig, batch_size=8), image_shape=w.IMG, device="cpu")
    state = trainer.init_state()
    ds = w.dataset()
    assert len(ds.test_idx) % 8 and len(ds.test_idx) <= 4  # the tail leaves rank 1 nothing
    for split in ("valid", "test"):
        want = trainer.evaluate(state, ds, split)
        assert r0["eval"][split] == r1["eval"][split]
        for key, v in want.items():
            np.testing.assert_allclose(r0["eval"][split][key], v, rtol=1e-6, err_msg=(split, key))
    ctrainer = Trainer(w.contrastive_cfg(pconfig, batch_size=8), image_shape=w.IMG, device="cpu")
    cwant = ctrainer.evaluate(ctrainer.init_state(), w.dataset(True), "valid")
    for key, v in cwant.items():
        np.testing.assert_allclose(r0["eval"]["contrastive_valid"][key], v, rtol=1e-6, err_msg=key)
    cols = trainer.predict(state, ds, "test")
    assert r0["eval"]["rows"] == r1["eval"]["rows"] == len(cols["graph_idx"]) > 0
    path = write_predictions(os.path.join(out, "pred_one.csv"), cols)
    with open(path, "rb") as a, open(os.path.join(out, "pred_dp2.csv"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("direction", ["one_to_fsdp2", "fsdp2_to_one"])
def test_checkpoint_restores_across_world_sizes(run, direction):
    """A one-process checkpoint restores bit-equal under fsdp=2 (params and
    AdamW moments), and the fsdp=2 ranks' checkpoint (rank 0 writes the
    whole tensors) restores bit-equal in one process."""
    r0, r1, one, out = run
    if direction == "one_to_fsdp2":
        src = one["node8"]["state"]
        for k, v in w.full_params(src).items():
            assert torch.equal(r0["checkpoint"]["restored"][k], v), k
            assert torch.equal(r1["checkpoint"]["restored"][k], v), k
        want = _full_optimizer_state(src)["state"]
        for i, st in want.items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(r0["checkpoint"]["restored_opt"][i][key], st[key]), (i, key)
        return
    assert r0["checkpoint"]["step"] == r1["checkpoint"]["step"] == 2
    saved = Checkpointer(os.path.join(out, "fsdp")).restore()
    trainer = Trainer(w.train_cfg(pconfig, batch_size=8), image_shape=w.IMG, device="cpu")
    state = trainer.init_state(params=saved["params"])
    from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import restore_params_into_state

    state = restore_params_into_state(trainer, state, saved, False)
    assert state.num_updates == 2
    for k, v in w.full_params(state).items():
        assert torch.equal(v, r0["checkpoint"]["after"][k]), k
    assert len(saved["data_rank_rngs"]) == 2


def test_stop_request_on_one_rank_stops_both_at_the_same_update(run):
    r0, r1, _, out = run
    assert r0["stop"] == r1["stop"] == {"num_updates": 1, "stopped": True}
    assert Checkpointer(os.path.join(out, "stop")).latest_step() == 1


@pytest.mark.parametrize("case", ["dp_ranks_differ", "tp_replicated_equal", "tp_sharded_block", "tp_heads_differ"])
def test_dropout_masks_across_ranks(run, case):
    """FastDropout and the kernel seeds across ranks: masks differ across
    data-parallel ranks; on a tp=2 mesh a replicated activation's mask is
    the same on both ranks, a sharded one's is the rank's block of the
    one-device mask, and the tree attention's heads get distinct masks."""
    r0, r1, _, _ = run
    a, b = r0["dropout"], r1["dropout"]
    if case == "dp_ranks_differ":
        assert not torch.equal(a["dp_mask"], b["dp_mask"]) and a["dp_seed"] != b["dp_seed"]
    elif case == "tp_replicated_equal":
        assert torch.equal(a["replicated"], b["replicated"])
    elif case == "tp_sharded_block":
        gen = torch.Generator()
        gen.set_state(a["sharded_state"])
        whole = fast_dropout(torch.ones(2, 4, 4, 4), 0.5, gen)
        assert torch.equal(a["sharded_block"], whole[:, :2]) and torch.equal(b["sharded_block"], whole[:, 2:])
    else:
        heads = a["heads"]  # (1, 4, 9, 8): rank 0's 2 heads, then rank 1's, on equal inputs
        assert torch.equal(heads, b["heads"])
        assert not torch.allclose(heads[:, :2], heads[:, 2:])
        assert ta.LUT_SIZE == 32
