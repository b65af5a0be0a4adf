"""The port's asynchronous checkpoints, profile traces, metric sinks and
launcher flags on the CPU:
- an async save holds what a synchronous one holds, taken at the moment of
  the call, and a resume from it is bit-equal to an uninterrupted run; the
  watchdog downgrades a wedged writer to synchronous saves (as the JAX
  package's ``tests/test_async_checkpoint.py``), and a writer's exception
  reaches the training thread;
- ``--profile-trace`` writes a trace and leaves training unchanged; the
  TensorBoard sink writes an events file and a missing ``wandb`` drops its
  sink with a warning; ``WANDB_PROJECT`` in the environment no longer stops
  the launcher;
- every runtime flag runs the launcher to its end."""

import dataclasses
import json
import os
import sys
import threading

import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_dataset
from multimodaldiscussiontransformer_tpu_torch.train import launch
from multimodaldiscussiontransformer_tpu_torch.train.metrics import MetricsWriter
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer
from multimodaldiscussiontransformer_tpu_torch.utils import checkpoints as ckpt
from multimodaldiscussiontransformer_tpu_torch.utils import profiling

torch.set_num_threads(2)
IMG = (3, 32, 32)
SYN = dict(seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8)


def train_cfg(**kw):
    m = pconfig.tiny_model_config(attention_dropout=0.3, dropout=0.1, act_dropout=0.1)
    base = dict(
        model=m,
        data=pconfig.DataConfig(batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(64,),
                                image_capacity_buckets=(16,), label_capacity_buckets=(32,)),
        optim=pconfig.OptimConfig(lr=1e-3, warmup_updates=2, total_num_update=20, update_freq=3),
        task_cfg=pconfig.TaskConfig(dataset_name="synthetic", seed=0), log_interval=100, validate_interval_updates=0,
    )
    base.update(kw)
    return pconfig.TrainConfig(**base)


def quiet(msg):
    pass


def assert_states_equal(a, b):
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i, st in sa.items():
        for k, v in st.items():
            assert torch.equal(v, sb[i][k]), (i, k)
    assert torch.equal(a.host_rng.get_state(), b.host_rng.get_state())
    assert torch.equal(a.device_rng.get_state(), b.device_rng.get_state())
    assert (a.step, a.num_updates, a.epoch) == (b.step, b.num_updates, b.epoch)


def test_async_save_equals_sync_and_resumes_bit_equal(tmp_path):
    """``fit`` with an async checkpointer saves at updates 1 and 2 and waits
    for them before it returns; step 2 equals a synchronous save of the
    same state, and a run resumed from it ends bit-equal to the
    uninterrupted one."""
    cfg = train_cfg(save_interval_updates=1)
    ds = synthetic_dataset(num_graphs=60, seed=1, **SYN)
    whole = Trainer(cfg, image_shape=IMG, device="cpu").fit(ds, max_updates=4, log_fn=quiet)

    saver = ckpt.Checkpointer(str(tmp_path / "async"))
    assert saver._async
    two = Trainer(cfg, image_shape=IMG, device="cpu").fit(ds, max_updates=2, checkpointer=saver, log_fn=quiet)
    assert saver._pending is None  # fit waited for the last write
    ckpt.Checkpointer(str(tmp_path / "sync"), async_save=False).save(two, 2)
    assert saver.all_steps() == [1, 2]
    a = torch.load(str(tmp_path / "async" / "2" / ckpt.STATE_FILE), weights_only=True)
    b = torch.load(str(tmp_path / "sync" / "2" / ckpt.STATE_FILE), weights_only=True)
    assert a.keys() == b.keys()
    for part in ("params", "host_rng", "device_rng", "step", "num_updates", "epoch"):
        want = b[part]
        got = a[part]
        if isinstance(want, dict):
            for k, v in want.items():
                assert torch.equal(got[k], v), k
        else:
            assert torch.equal(got, want) if isinstance(want, torch.Tensor) else got == want, part

    resumed_trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    state = ckpt.restore_params_into_state(resumed_trainer, resumed_trainer.init_state(seed=9),
                                           saver.restore(step=2), reset_optimizer=False)
    assert_states_equal(resumed_trainer.fit(ds, state=state, max_updates=4, log_fn=quiet), whole)


def test_async_save_is_a_snapshot_at_the_call(tmp_path, monkeypatch):
    """The writer runs after the next update has changed the params in
    place: the step still holds the values of the moment ``save`` was
    called."""
    gate = threading.Event()
    write = ckpt.Checkpointer._write

    def late(self, payload, step, best):
        gate.wait(30)
        write(self, payload, step, best)

    monkeypatch.setattr(ckpt.Checkpointer, "_write", late)
    state = Trainer(train_cfg(), image_shape=IMG, device="cpu").init_state()
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    saver = ckpt.Checkpointer(str(tmp_path))
    saver.save(state, 1)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    gate.set()
    saver.wait()
    got = saver.restore(step=1)["params"]
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_watchdog_downgrades_a_wedged_writer(tmp_path, capsys, monkeypatch):
    """A write that outlasts ``async_timeout_sec``: the wait returns in
    bounded time with the warning, the step is listed as suspect, and the
    next saves are synchronous and restorable."""
    release = threading.Event()
    write = ckpt.Checkpointer._write

    def wedged(self, payload, step, best):
        if step == 1:
            release.wait(60)
        write(self, payload, step, best)

    monkeypatch.setattr(ckpt.Checkpointer, "_write", wedged)
    saver = ckpt.Checkpointer(str(tmp_path), async_timeout_sec=0.5)
    saver.save({"params": {"w": torch.arange(4.0)}}, 1)
    saver.wait()
    err = capsys.readouterr().err
    assert "did not finish" in err and "downgrading to synchronous" in err
    assert not saver._async
    assert (tmp_path / "suspect_steps.txt").read_text().split() == ["1"]
    saver.save({"params": {"w": torch.arange(4.0) * 2}}, 2)
    assert saver.latest_step() == 2 and saver._pending is None
    assert torch.equal(saver.restore()["params"]["w"], torch.arange(4.0) * 2)
    release.set()


def test_writer_exception_reaches_the_training_thread(tmp_path, monkeypatch):
    def broken(self, payload, step, best):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.Checkpointer, "_write", broken)
    saver = ckpt.Checkpointer(str(tmp_path))
    saver.save({"params": {"w": torch.zeros(2)}}, 1)  # returns: the write fails later
    with pytest.raises(OSError, match="disk full"):
        saver.wait()


def test_profile_trace_leaves_training_unchanged(tmp_path):
    """The trace window (start after 2 updates, 1 update long) writes a
    Chrome trace with the step's work and its named ranges in it; the
    parameters equal a run without it."""
    ds = synthetic_dataset(num_graphs=60, seed=1, **SYN)
    logs = []
    traced = Trainer(train_cfg(profile_trace_dir=str(tmp_path / "t"), profile_trace_steps=1), image_shape=IMG,
                     device="cpu").fit(ds, max_updates=4, log_fn=logs.append)
    plain = Trainer(train_cfg(), image_shape=IMG, device="cpu").fit(ds, max_updates=4, log_fn=quiet)
    assert logs == [f"profile trace written to {tmp_path / 't'}"]
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.loads((tmp_path / "t" / files[0]).read_text())["traceEvents"]
    assert any("addmm" in e.get("name", "") for e in events)
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert ranges.count("microbatch") == 3 and ranges.count("optimizer") == 1, ranges  # one update of 3
    for (k, a), b in zip(traced.model.state_dict().items(), plain.model.state_dict().values()):
        assert torch.equal(a, b), k
    with profiling.trace(str(tmp_path / "block")), profiling.named_scope("step"):
        torch.ones(3).sum()
    (block,) = os.listdir(tmp_path / "block")
    assert "step" in [e.get("name") for e in json.loads((tmp_path / "block" / block).read_text())["traceEvents"]]
    assert profiling.memory_stats() is None  # no card here


def test_metric_sinks(tmp_path, monkeypatch, capsys):
    """TensorBoard writes an events file; without ``wandb`` its sink is
    dropped with one warning line and the JSONL sink still writes."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb -> ImportError
    w = MetricsWriter(str(tmp_path), wandb_project="p", tensorboard_logdir=str(tmp_path / "tb"))
    w.write("train", 1, {"loss": 0.5, "note": "text"})
    w.close()
    err = capsys.readouterr().err
    assert err.count("warning: the wandb metrics sink is off") == 1
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "tb"))
    assert json.loads((tmp_path / "metrics.jsonl").read_text()) == {"split": "train", "step": 1, "loss": 0.5,
                                                                   "note": "text"}


def test_wandb_project_in_the_environment_trains(tmp_path, monkeypatch, capsys):
    """The fault: ``--wandb-project`` defaults to ``$WANDB_PROJECT``, which
    the launcher used to reject with exit 2. Now it trains, and the sink
    degrades without ``wandb``."""
    monkeypatch.setenv("WANDB_PROJECT", "x")
    monkeypatch.setitem(sys.modules, "wandb", None)
    argv = ["--synthetic", "--tiny", "--max-updates", "1", "--batch-size", "4", "--no-save", "--device", "cpu",
            "--save-dir", str(tmp_path)]
    assert launch.main(argv) == 0
    assert "the wandb metrics sink is off" in capsys.readouterr().err


@pytest.mark.parametrize(
    "flags",
    [["--remat", "--remat-policy", p] for p in ("full", "dots", "dots_saveable", "names", "names_heavy")]
    + [["--scan-layers"], ["--num-workers", "2"], ["--profile-trace", "{d}/trace", "--profile-steps", "1"],
       ["--tensorboard-logdir", "{d}/tb"], ["--wandb-project", "x"]],
)
def test_runtime_flags_run_to_the_end(flags, tmp_path):
    argv = ["--synthetic", "--tiny", "--max-updates", "3", "--batch-size", "4", "--device", "cpu",
            "--save-dir", str(tmp_path / "ck"), "--log-interval", "1"] + [f.format(d=tmp_path) for f in flags]
    assert launch.main(argv) == 0
    assert (tmp_path / "ck" / "metrics.jsonl").read_text().count('"split": "train"') == 3
    if "--scan-layers" in flags:
        saved = ckpt.Checkpointer(str(tmp_path / "ck")).restore()["params"]
        assert any(k.startswith("graph_encoder.scan_pairs.") for k in saved)
    if "--profile-trace" in flags:
        assert os.listdir(tmp_path / "trace")


def test_launch_resolves_the_runtime_flags():
    cfg = launch.config_from_args(launch.build_parser().parse_args(
        ["--synthetic", "--tiny", "--remat", "--remat-policy", "names", "--scan-layers", "--num-workers", "3",
         "--profile-trace", "t", "--profile-steps", "2"]))
    assert (cfg.model.remat, cfg.model.remat_policy, cfg.model.scan_layers) == (True, "names", True)
    assert (cfg.data.num_workers, cfg.profile_trace_dir, cfg.profile_trace_steps) == (3, "t", 2)
    assert dataclasses.asdict(cfg)  # the wandb config is the whole TrainConfig
