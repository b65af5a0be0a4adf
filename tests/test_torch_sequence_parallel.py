"""Sequence parallelism across 2 ranks over gloo on the CPU (one sp group),
against the plain ring, one process and the JAX package (tiny config,
float32, dropout 0 unless the case is about dropout).

One 2-rank group runs for the module (``tests/torch_parallel_worker.py``
with the ``sp`` suite): the distributed ring on padded S with and without
dropout, the model's forward at sp=2, one update (and one under remat),
``Trainer.fit`` for 2 updates, the contrastive update, evaluation and
prediction, and the scorer on an sp mesh; the cases below compare what
each rank returned."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as w
from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import to_tensors
from multimodaldiscussiontransformer_tpu_torch.ops import ring_attention as ra
from multimodaldiscussiontransformer_tpu_torch.serve.incremental import DiscussionScorer
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer, write_predictions
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import to_flax_params

torch.set_num_threads(2)
LR0 = 1e-3 / 2  # the first update's lr (warmup 2)


def _one_update(cfg, k=3, contrastive=False):
    trainer = Trainer(cfg, image_shape=w.IMG, device="cpu")
    state = trainer.init_state()
    logs = trainer.train_step(state, w.first_group(trainer, w.dataset(contrastive), k), return_grads=True)
    return {"logs": w.scalars(logs), "params": w.full_params(state), "grads": logs["grads"]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(rank 0's results, rank 1's results, the results directory)."""
    out = str(tmp_path_factory.mktemp("sp"))
    ranks = w.spawn(2, out, suite="sp")
    return ranks[0], ranks[1], out


@pytest.fixture(scope="module")
def one():
    """The one-process trainer, its initial state and its first batch."""
    trainer = Trainer(w.train_cfg(pconfig, 8), image_shape=w.IMG, device="cpu")
    state = trainer.init_state()
    host = next(iter(trainer.train_batches(w.dataset(), epoch=1))).asdict()
    return trainer, state, host


def _assert_two_tier(got, want, init, grads, msg):
    """Params after AdamW: within rtol 2e-4 where the step is a full Adam
    step of a gradient clear of summation noise (|g| > 1e-6: a key bias,
    whose true gradient is 0, takes a full step of either sign), else
    within 2.05 lr."""
    for k, p in want.items():
        g, ref, start = got[k].numpy(), p.numpy(), init[k].numpy()
        clear = np.abs(grads[k].numpy()) > 1e-6 if k in grads else np.zeros(g.shape, bool)
        big = (np.abs(ref - start) > 0.5 * LR0) & clear
        np.testing.assert_allclose(g[big], ref[big], rtol=2e-4, atol=2e-5, err_msg=f"{msg}: {k}")
        assert (np.abs(g - ref) <= 2.05 * LR0 + 1e-7).all(), f"{msg}: {k}"


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_distributed_ring_matches_the_plain_ring(run, rate):
    """Each rank's strip of the output and of dq, dk, dv, and the sum of the
    ranks' dLUT, equal the plain ring on the padded inputs (S = 13 on 2
    ranks: one padded row) within 1e-5, dropout included (the same
    per-tile masks); the dispatch's whole output equals it unpadded."""
    r0, r1, _ = run
    q, k, v, template, ids, lut, cot = w.ring_inputs()
    qp, kp, vp, tpl, idp = ra.pad_compact(q, k, v, template, ids, 2)
    leaves = [x.clone().requires_grad_(True) for x in (qp, kp, vp, lut)]
    seed = 77 if rate else 0
    ref = ra.ring_tree_attention_reference(*leaves[:3], tpl, idp, leaves[3], 2, seed=seed, rate=rate, shard=1)
    ref.backward(torch.nn.functional.pad(cot, (0, 0, 0, 1)))
    a, b = r0["ring"][f"rate{rate}"], r1["ring"][f"rate{rate}"]
    got = {name: torch.cat([a[name], b[name]], dim=2) for name in ("out", "dq", "dk", "dv")}
    for name, want in zip(("out", "dq", "dk", "dv"), (ref, *(x.grad for x in leaves[:3]))):
        np.testing.assert_allclose(got[name].numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose((a["dlut"] + b["dlut"]).numpy(), leaves[3].grad.numpy(), rtol=1e-5, atol=1e-5)
    for r in (a, b):
        np.testing.assert_allclose(r["whole"].numpy(), ref[:, :, :13].detach().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["shift", "shift_all_reduce"])
def test_ring_shift_passes_each_tensor_to_the_next_rank(run, form):
    """Rank r receives rank r - 1's tensor, by the point-to-point pair and
    by the all-reduce that gloo takes for CUDA tensors."""
    r0, r1, _ = run
    assert torch.equal(r0["ring"][form], torch.full((2, 3), 1.0))
    assert torch.equal(r1["ring"][form], torch.full((2, 3), 0.0))


def test_model_at_sp2_matches_one_process_and_jax(run, one):
    """The tiny model's logits (rank 0's block of the node slots, then rank
    1's) and global embedding at sp=2 equal one process's and the JAX
    ``MDTModel``'s (same weights, the XLA reference attention) within 1e-5;
    the three graph layers went through the ring."""
    r0, r1, _ = run
    trainer, state, host = one
    with torch.no_grad():
        want = state.model(to_tensors(host, "cpu"), deterministic=True)
    logits = torch.cat([r0["forward"]["logits"], r1["forward"]["logits"]])
    mask = host["node_mask"]
    np.testing.assert_allclose(logits.numpy()[mask], want.logits.numpy()[mask], rtol=1e-5, atol=1e-5)
    for r in (r0, r1):
        np.testing.assert_allclose(r["forward"]["global_embedding"].numpy(), want.global_embedding.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert r["forward"]["mesh"] == {"dp": 1, "tp": 1, "sp": 2}
        assert r["forward"]["ring_calls"] == 3
    jcfg = w.train_cfg(jconfig, 8).model
    params = jax.tree.map(jnp.asarray, to_flax_params(state.model))
    jout = jax.jit(lambda p, b: JaxMDTModel(jcfg).apply(p, b, deterministic=True))(
        params, {k: jnp.asarray(v) for k, v in host.items()})
    np.testing.assert_allclose(logits.numpy()[mask], np.asarray(jout.logits)[mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r0["forward"]["global_embedding"].numpy(), np.asarray(jout.global_embedding),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scenario", ["update", "remat"])
def test_update_at_sp2_matches_one_process(run, scenario):
    """One update at sp=2 (and with every stack rematerialised, whose
    recompute reruns the ring): both ranks hold the same whole params; the
    loss, sample size, ncorrect and gnorm equal one process's (rtol 1e-5)
    and the params pass the two-tier check."""
    r0, r1, _ = run
    want = _one_update(w.train_cfg(pconfig, 8))
    assert r0[scenario]["mesh"] == {"dp": 1, "tp": 1, "sp": 2}
    for k, v in r0[scenario]["params"].items():
        torch.testing.assert_close(v, r1[scenario]["params"][k], rtol=0, atol=0, msg=k)
    for key in ("loss", "sample_size", "ncorrect", "gnorm"):
        np.testing.assert_allclose(r0[scenario]["logs"][key], want["logs"][key], rtol=1e-5, err_msg=key)
    init = w.full_params(Trainer(w.train_cfg(pconfig, 8), image_shape=w.IMG, device="cpu").init_state())
    _assert_two_tier(r0[scenario]["params"], want["params"], init, want["grads"], scenario)
    assert r0["update"]["ring_calls"] > 0


def test_fit_at_sp2_matches_one_process(run):
    """``Trainer.fit`` for 2 updates at sp=2 against one process, with JAX
    ``test_dp_sp_train.py``'s two-tier parameter check: every element within
    2.5e-4 and fewer than 2% outside 3e-5. The key projections' biases are
    held to 2.05 x the two updates' lrs instead: softmax is invariant to
    them, so their gradient is summation noise and Adam steps them by a
    full lr of either sign."""
    r0, r1, _ = run
    trainer = Trainer(w.train_cfg(pconfig, 8), image_shape=w.IMG, device="cpu")
    state = trainer.fit(w.dataset(), max_updates=2, log_fn=lambda s: None,
                        writer=type("W", (), {"write": lambda *a: None, "close": lambda *a: None})())
    assert r0["fit"]["num_updates"] == r1["fit"]["num_updates"] == state.num_updates == 2
    total = outside = 0
    for k, v in w.full_params(state).items():
        torch.testing.assert_close(r0["fit"]["params"][k], r1["fit"]["params"][k], rtol=0, atol=0, msg=k)
        d = (r0["fit"]["params"][k] - v).abs()
        bound = 2.05 * (LR0 + 2 * LR0) if k.endswith(("key.bias", "k_proj.bias")) else 2.5e-4
        assert d.max() < bound, (k, float(d.max()))
        total += d.numel()
        outside += int((d > 3e-5).sum())
    assert outside / total < 0.02, (outside, total)


def test_contrastive_update_at_sp2_matches_one_process(run):
    """The contrastive loss on the broadcast global embedding, counted on
    sp rank 0: the loss, sample size, counts and gnorm of one update equal
    one process's, and so do the params (two-tier)."""
    r0, r1, _ = run
    want = _one_update(w.contrastive_cfg(pconfig, 8), k=2, contrastive=True)
    for key in ("loss", "sample_size", "ncorrect", "positive_correct", "gnorm"):
        np.testing.assert_allclose(r0["contrastive"]["logs"][key], want["logs"][key], rtol=1e-5, err_msg=key)
    for k, v in r0["contrastive"]["params"].items():
        torch.testing.assert_close(v, r1["contrastive"]["params"][k], rtol=0, atol=0, msg=k)
    init = w.full_params(Trainer(w.contrastive_cfg(pconfig, 8), image_shape=w.IMG, device="cpu").init_state())
    _assert_two_tier(r0["contrastive"]["params"], want["params"], init, want["grads"], "contrastive")


def test_eval_and_predict_at_sp2_match_one_process(run, one):
    """Evaluation (node and contrastive) sums over the sp ranks to one
    process's metrics; the prediction file written by rank 0 holds one
    process's rows in its order: the same graph, node, label and
    prediction, logits and probabilities within 1e-5."""
    r0, r1, out = run
    trainer, state, _ = one
    ds = w.dataset()
    for split in ("valid", "test"):
        want = trainer.evaluate(state, ds, split)
        for r in (r0, r1):
            for key, v in want.items():
                np.testing.assert_allclose(r["eval"][split][key], v, rtol=1e-5, err_msg=f"{split} {key}")
    ctrainer = Trainer(w.contrastive_cfg(pconfig, 8), image_shape=w.IMG, device="cpu")
    cwant = ctrainer.evaluate(ctrainer.init_state(), w.dataset(True), "valid")
    for key, v in cwant.items():
        np.testing.assert_allclose(r0["eval"]["contrastive_valid"][key], v, rtol=1e-5, err_msg=key)
    path = write_predictions(os.path.join(out, "pred_one.csv"), trainer.predict(state, ds, "test"))
    with open(path) as a, open(os.path.join(out, "pred_sp2.csv")) as b:
        got, want_rows = b.read().splitlines(), a.read().splitlines()
    assert len(got) == len(want_rows) > 1 and got[0] == want_rows[0]
    for g, x in zip(got[1:], want_rows[1:]):
        gf, xf = g.split(","), x.split(",")
        assert gf[:5] == xf[:5], (g, x)  # graph, node, label, labeled, pred
        np.testing.assert_allclose([float(v) for v in gf[5:]], [float(v) for v in xf[5:]], rtol=1e-5, atol=1e-6)


def test_scorer_with_an_sp_mesh_matches_one_process(run):
    """``DiscussionScorer(mesh=make_mesh(sp_size=2))``: both ranks return
    the one-process scorer's probabilities for every node."""
    from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel

    r0, r1, _ = run
    cfg = w.train_cfg(pconfig, 8)
    model = MDTModel(cfg.model, generator=torch.Generator().manual_seed(cfg.seed))
    scorer = DiscussionScorer(model, device="cpu", data_cfg=cfg.data, task_cfg=cfg.task_cfg, image_shape=w.IMG)
    ds = w.dataset()
    want = scorer.score_items([ds.get(int(i)) for i in ds.test_idx[:3]])
    for r in (r0, r1):
        assert len(r["scorer"]["probs"]) == len(want)
        for g, x in zip(r["scorer"]["probs"], want):
            np.testing.assert_allclose(g, x, rtol=1e-5, atol=1e-6)
