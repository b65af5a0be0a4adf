"""One rank of the gloo groups behind ``tests/test_torch_parallel_train.py``,
``tests/test_torch_parallel_four.py`` and
``tests/test_torch_sequence_parallel.py``.

Run as ``python tests/torch_parallel_worker.py RANK WORLD PORT OUT_DIR
[SUITE]``: starts a gloo process group on 127.0.0.1:PORT, runs every
scenario of ``SCENARIOS`` (WORLD 2), of ``SP_SCENARIOS`` (WORLD 2, SUITE
``sp``) or every layout of ``FOUR_RANK_LAYOUTS`` and the 4-rank ring
(WORLD 4) in order (each over a mesh of its own) and writes what each
returned (or the error it raised) to ``OUT_DIR/rank<RANK>.pt``. The test
process compares those results with one-process runs and with the JAX
package. Imports torch and the port only.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.data.loader import stack_microbatches  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import (  # noqa: E402
    draw_seed,
    dropout_rngs,
    fast_dropout,
)
from multimodaldiscussiontransformer_tpu_torch.ops import ring_attention as ra  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.parallel import comm  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.parallel.comm import gather_dim, ring_shift  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.parallel.mesh import TPInfo, make_mesh  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.serve.incremental import DiscussionScorer  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer, write_predictions  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import (  # noqa: E402
    Checkpointer,
    _full_optimizer_state,
    restore_params_into_state,
)

IMG = (3, 32, 32)
SYN = dict(seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8)
NUM_GRAPHS = 40


def train_cfg(mod, batch_size: int = 4, **kw):
    """The same TrainConfig in either package: tiny model with every dropout
    at 0, ``batch_size`` per replica x update_freq 3, single-entry ladders
    that every rank's half of a global batch of 8 fits."""
    m = mod.tiny_model_config(dropout=0.0, attention_dropout=0.0, act_dropout=0.0)
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    m = m.replace(text_tower=dataclasses.replace(m.text_tower, **no_drop),
                  image_tower=dataclasses.replace(m.image_tower, **no_drop))
    base = dict(
        model=m,
        data=mod.DataConfig(batch_size=batch_size, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(128,),
                            image_capacity_buckets=(64,), label_capacity_buckets=(64,)),
        optim=mod.OptimConfig(lr=1e-3, warmup_updates=2, total_num_update=20, update_freq=3),
        task_cfg=mod.TaskConfig(dataset_name="synthetic", seed=0),
        log_interval=100,
        validate_interval_updates=0,
    )
    base.update(kw)
    return mod.TrainConfig(**base)


def sp_cfg(cfg):
    """``cfg`` with the model's ``sequence_parallel`` on (what ``--sp-size``
    does in the launcher)."""
    return cfg.replace(model=cfg.model.replace(sequence_parallel=True))


def contrastive_cfg(mod, batch_size: int = 4, **kw):
    return train_cfg(mod, batch_size, task="contrastive_learning", criterion="contrastive_loss",
                     optim=mod.OptimConfig(lr=1e-3, warmup_updates=2, total_num_update=20, update_freq=2), **kw)


def dataset(contrastive: bool = False):
    return synthetic_dataset(num_graphs=NUM_GRAPHS, seed=0, contrastive=contrastive, **SYN)


def first_group(trainer: Trainer, ds, k: int):
    return next(iter(stack_microbatches(trainer.train_batches(ds, epoch=1), k)))


def full_params(state):
    sd = state.model.state_dict() if state.layout is None else state.layout.full_state_dict(state.model)
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def scalars(logs):
    return {k: float(v) for k, v in logs.items() if k != "grads"}


def one_update(cfg, k: int = 3, contrastive: bool = False):
    """Logs and whole params after one update on the first group."""
    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    state = trainer.init_state()
    logs = trainer.train_step(state, first_group(trainer, dataset(contrastive), k))
    return {"logs": scalars(logs), "params": full_params(state), "mesh": dict(trainer.mesh.shape)}


def scenario_dp(out):
    return one_update(train_cfg(pconfig, dp_size=2))


def scenario_fsdp(out):
    return one_update(train_cfg(pconfig, dp_size=2, fsdp=True))


def scenario_tp(out):
    return one_update(train_cfg(pconfig, tp_size=2))


def scenario_slices(out):
    return one_update(train_cfg(pconfig, num_slices=2, fsdp=True))


def scenario_multisteps(out):
    cfg = train_cfg(pconfig, dp_size=2)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, scan_microbatches=False))
    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    state = trainer.init_state()
    logs = [scalars(trainer.train_microstep(state, b.asdict()))
            for b in list(trainer.train_batches(dataset(), epoch=1))[:3]]
    return {"logs": logs, "params": full_params(state), "num_updates": state.num_updates}


def scenario_contrastive(out):
    return one_update(contrastive_cfg(pconfig, dp_size=2), k=2, contrastive=True)


def scenario_eval(out):
    trainer = Trainer(train_cfg(pconfig, dp_size=2), image_shape=IMG, device="cpu")
    state = trainer.init_state()
    ds = dataset()
    res = {split: trainer.evaluate(state, ds, split) for split in ("valid", "test")}
    cols = trainer.predict(state, ds, "test")
    if dist.get_rank() == 0:
        write_predictions(os.path.join(out, "pred_dp2.csv"), cols)
    ctrainer = Trainer(contrastive_cfg(pconfig, dp_size=2), image_shape=IMG, device="cpu")
    res["contrastive_valid"] = ctrainer.evaluate(ctrainer.init_state(), dataset(True), "valid")
    res["rows"] = len(cols["graph_idx"])
    return res


def scenario_checkpoint(out):
    """fsdp=2: restore the one-process checkpoint under ``out/one``, take
    one update, save it under ``out/fsdp``."""
    cfg = train_cfg(pconfig, dp_size=2, fsdp=True)
    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    ck = Checkpointer(os.path.join(out, "one"), writer=False)
    restored = ck.restore()
    state = restore_params_into_state(trainer, trainer.init_state(params=restored["params"]), restored, False)
    before = full_params(state)
    opt = _full_optimizer_state(state)["state"]
    trainer.train_step(state, first_group(trainer, dataset(), 3))
    saver = Checkpointer(os.path.join(out, "fsdp"), writer=dist.get_rank() == 0, async_save=True)
    saver.save(state, state.num_updates)
    saver.close()
    return {"restored": before, "restored_opt": opt, "after": full_params(state), "step": state.num_updates}


def scenario_stop(out):
    """A stop request on rank 1 alone, after its first update."""
    cfg = train_cfg(pconfig, dp_size=2, save_dir=os.path.join(out, "stop"))
    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    saver = Checkpointer(cfg.save_dir, writer=dist.get_rank() == 0)
    box = {}

    def should_stop():
        return dist.get_rank() == 1 and box["state"].num_updates >= 1

    box["state"] = state = trainer.init_state()
    state = trainer.fit(dataset(), state=state, max_updates=5, checkpointer=saver, should_stop=should_stop,
                        log_fn=lambda s: None)
    saver.close()
    return {"num_updates": state.num_updates, "stopped": trainer.stopped}


def scenario_dropout(out):
    """The masks across ranks: FastDropout bits per data-parallel rank; on a
    tp=2 mesh a replicated site's mask, a sharded site's block and the tree
    kernel's heads."""
    res = {}
    trainer = Trainer(train_cfg(pconfig, dp_size=2), image_shape=IMG, device="cpu")
    state = trainer.init_state()
    with dropout_rngs(state.host_rng, state.device_rng):
        res["dp_mask"] = fast_dropout(torch.ones(64), 0.5, state.device_rng)
        res["dp_seed"] = draw_seed()
    mesh = make_mesh(tp_size=2)
    tp = TPInfo(mesh.tp_group, mesh.tp_rank, mesh.tp_size)
    gen = torch.Generator().manual_seed(7)
    host = torch.Generator().manual_seed(11)
    res["replicated"] = fast_dropout(torch.ones(3, 8), 0.5, gen)
    state_before = gen.get_state()
    res["sharded_block"] = fast_dropout(torch.ones(2, 2, 4, 4), 0.5, gen, shard=(1, tp))
    res["sharded_state"] = state_before
    # the tree attention on equal inputs, its seed folded with the tp rank
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 9, 8, generator=g) for _ in range(3))
    template = torch.zeros(1, 9, 9)
    ids = torch.zeros(1, 9, 9, dtype=torch.int32)
    lut = torch.zeros(ta.LUT_SIZE, 2)
    with dropout_rngs(host, gen):
        seed = draw_seed(tp.rank)
    ctx = ta.tree_attention(q, k, v, template, ids, lut, rate=0.5, seed=seed)
    res["heads"] = gather_dim(ctx, 1, mesh.tp_group)
    return res


# -- sequence parallelism (2 ranks, one sp group) ------------------------------


def ring_inputs(s: int = 13, b: int = 2, h: int = 3, dh: int = 8):
    """Seeded compact-bias inputs of one (B, H, S, dh) attention, a
    cotangent, and S's padded size for 2 and 4 ranks: real keys up to
    column 10 (column 0 open), one fully masked row."""
    g = torch.Generator().manual_seed(5)
    q, k, v, cot = (torch.randn(b, h, s, dh, generator=g) for _ in range(4))
    template = torch.zeros(b, s, s)
    template[:, :, 10:] = float("-inf")
    template[1, 4, :] = float("-inf")
    ids = torch.randint(0, ta.LUT_SIZE, (b, s, s), generator=g, dtype=torch.int32)
    lut = torch.randn(ta.LUT_SIZE, h, generator=g)
    return q, k, v, template, ids, lut, cot


def distributed_ring(group=None, rate: float = 0.0):
    """This rank's strip of the ring over ``group`` on ``ring_inputs``
    padded to a multiple of the group size: the output and the gradients of
    q, k, v (its strip) and of the LUT (its tiles' sum), and the whole
    output of ``ring_tree_attention_dispatch``."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    q, k, v, template, ids, lut, cot = ring_inputs()
    qp, kp, vp, tpl, idp = ra.pad_compact(q, k, v, template, ids, n)
    cp = torch.nn.functional.pad(cot, (0, 0, 0, qp.shape[2] - q.shape[2]))
    c = qp.shape[2] // n
    rows = slice(rank * c, (rank + 1) * c)
    leaves = [x[:, :, rows].clone().requires_grad_(True) for x in (qp, kp, vp)]
    lut_leaf = lut.clone().requires_grad_(True)
    seed = 77 if rate else None
    out = ra.ring_tree_attention_local(*leaves, tpl[:, rows], idp[:, rows], lut_leaf, group, rate=rate, seed=seed,
                                       shard=1)
    out.backward(cp[:, :, rows])
    whole = ra.ring_tree_attention_dispatch(q, k, v, template, ids, lut, group, rate=rate, seed=seed, shard=1)
    return {"out": out.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad, "dv": leaves[2].grad,
            "dlut": lut_leaf.grad, "whole": whole}


def scenario_sp_ring(out):
    res = {f"rate{r}": distributed_ring(rate=r) for r in (0.0, 0.3)}
    # both forms of the shift: the point-to-point pair and the all-reduce
    # (gloo's form for CUDA tensors)
    t = torch.full((2, 3), float(dist.get_rank()))
    res["shift"] = ring_shift(t, None)
    p2p, comm.shift_by_all_reduce = comm.shift_by_all_reduce, lambda group, t: True
    try:
        res["shift_all_reduce"] = ring_shift(t, None)
    finally:
        comm.shift_by_all_reduce = p2p
    return res


def sp_train_cfg(batch_size: int = 8, **kw):
    return sp_cfg(train_cfg(pconfig, batch_size, sp_size=2, **kw))


def scenario_sp_forward(out):
    """The tiny model's deterministic forward on the first batch at sp=2:
    this rank's logits (its block of the node slots) and the global
    embedding; the ring's calls."""
    trainer = Trainer(sp_train_cfg(), image_shape=IMG, device="cpu")
    state = trainer.init_state()
    host = next(iter(trainer.train_batches(dataset(), epoch=1))).asdict()
    before = ra.ring_tree_attention_local.calls
    with torch.no_grad():
        from multimodaldiscussiontransformer_tpu_torch.data.collator import to_tensors

        o = state.model(to_tensors(trainer.local(host), "cpu"), deterministic=True)
    return {"logits": o.logits, "global_embedding": o.global_embedding,
            "ring_calls": ra.ring_tree_attention_local.calls - before, "mesh": dict(trainer.mesh.shape)}


def scenario_sp_update(out):
    res = one_update(sp_train_cfg())
    res["ring_calls"] = ra.ring_tree_attention_local.calls
    return res


def scenario_sp_fit(out):
    """``Trainer.fit`` for 2 updates at sp=2 (the prefetch thread stages
    each rank's share)."""
    trainer = Trainer(sp_train_cfg(), image_shape=IMG, device="cpu")
    state = trainer.fit(dataset(), max_updates=2, log_fn=lambda s: None,
                        writer=type("W", (), {"write": lambda *a: None, "close": lambda *a: None})())
    return {"params": full_params(state), "num_updates": state.num_updates}


def scenario_sp_remat(out):
    """One update at sp=2 with every stack rematerialised (the ring's
    collectives rerun in the backward)."""
    cfg = sp_train_cfg()
    return one_update(cfg.replace(model=cfg.model.replace(remat=True, remat_policy="full")))


def scenario_sp_contrastive(out):
    return one_update(sp_cfg(contrastive_cfg(pconfig, batch_size=8, sp_size=2)), k=2, contrastive=True)


def scenario_sp_eval(out):
    trainer = Trainer(sp_train_cfg(), image_shape=IMG, device="cpu")
    state = trainer.init_state()
    ds = dataset()
    res = {split: trainer.evaluate(state, ds, split) for split in ("valid", "test")}
    cols = trainer.predict(state, ds, "test")
    if dist.get_rank() == 0:
        write_predictions(os.path.join(out, "pred_sp2.csv"), cols)
    ctrainer = Trainer(sp_cfg(contrastive_cfg(pconfig, batch_size=8, sp_size=2)), image_shape=IMG, device="cpu")
    res["contrastive_valid"] = ctrainer.evaluate(ctrainer.init_state(), dataset(True), "valid")
    return res


def scenario_sp_scorer(out):
    """The scorer over an sp=2 mesh on the one-process init's weights: the
    probabilities of 3 test discussions, on every rank."""
    from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel

    cfg = sp_train_cfg()
    model = MDTModel(cfg.model, generator=torch.Generator().manual_seed(cfg.seed))
    scorer = DiscussionScorer(model, device="cpu", data_cfg=cfg.data, task_cfg=cfg.task_cfg, image_shape=IMG,
                              mesh=make_mesh(sp_size=2))
    ds = dataset()
    return {"probs": scorer.score_items([ds.get(int(i)) for i in ds.test_idx[:3]])}


SP_SCENARIOS = [
    ("ring", scenario_sp_ring), ("forward", scenario_sp_forward), ("update", scenario_sp_update),
    ("fit", scenario_sp_fit), ("remat", scenario_sp_remat), ("contrastive", scenario_sp_contrastive),
    ("eval", scenario_sp_eval), ("scorer", scenario_sp_scorer),
]

SCENARIOS = [
    ("dp", scenario_dp), ("fsdp", scenario_fsdp), ("tp", scenario_tp), ("slices", scenario_slices),
    ("multisteps", scenario_multisteps), ("contrastive", scenario_contrastive), ("eval", scenario_eval),
    ("checkpoint", scenario_checkpoint), ("stop", scenario_stop), ("dropout", scenario_dropout),
]

# on 4 ranks: every layout of a global batch of 8 (per-rank capacities
# from ladders that a quarter of it fits)
FOUR_RANK_LAYOUTS = {
    "dp4": dict(batch_size=2, dp_size=4), "fsdp4": dict(batch_size=2, dp_size=4, fsdp=True),
    "tp2_dp2": dict(batch_size=4, dp_size=2, tp_size=2), "slices2_dp2": dict(batch_size=2, num_slices=2, fsdp=True),
    "slices2_tp2": dict(batch_size=4, num_slices=2, dp_size=1, tp_size=2, fsdp=True),
    "dp2_sp2": dict(batch_size=4, dp_size=2, sp_size=2), "tp2_sp2": dict(batch_size=8, tp_size=2, sp_size=2),
    "fsdp2_sp2": dict(batch_size=4, dp_size=2, sp_size=2, fsdp=True),
}
FOUR_RANK_LADDERS = dict(node_capacity_buckets=(256,), image_capacity_buckets=(128,), label_capacity_buckets=(128,))


def four_rank_cfg(batch_size: int = 8, **kw):
    cfg = train_cfg(pconfig, batch_size, **kw)
    if cfg.sp_size > 1:
        cfg = sp_cfg(cfg)
    return cfg.replace(data=dataclasses.replace(cfg.data, **FOUR_RANK_LADDERS))


def spawn(world: int, out: str, timeout: float = 120.0, suite: str = "") -> list:
    """Run ``world`` ranks of this script on a free port and return each
    rank's results. A rank that fails, exits non-zero or outlives
    ``timeout`` seconds (a deadlock) raises ``AssertionError``; every rank
    is killed before this returns."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), out, suite],
                              env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    deadline = time.monotonic() + timeout  # one limit for the whole group
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-3000:] if r < len(logs) else ''}"
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    for r, res in enumerate(ranks):
        for name, v in res.items():
            assert not (isinstance(v, dict) and "error" in v), f"rank {r}, scenario {name}:\n{v['error']}"
    return ranks


def main(rank: int, world: int, port: int, out: str, suite: str = "") -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    results = {}
    if suite == "sp":
        scenarios = SP_SCENARIOS
    elif world == 2:
        scenarios = SCENARIOS
    else:
        scenarios = [(name, lambda out, kw=kw: one_update(four_rank_cfg(**kw)))
                     for name, kw in FOUR_RANK_LAYOUTS.items()]
        scenarios.append(("ring4", lambda out: {f"rate{r}": distributed_ring(rate=r) for r in (0.0, 0.3)}))
    for name, fn in scenarios:
        try:
            results[name] = fn(out)
        except Exception:  # noqa: BLE001 - reported to the test, which fails on it
            results[name] = {"error": traceback.format_exc()}
            break  # the other rank may be inside a collective: stop here
        dist.barrier()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5] if len(sys.argv) > 5 else "")
