"""Every layout of four ranks over gloo on the CPU against one process (tiny
config, float32, dropout 0): dp=4, fsdp=4, tp=2 x dp=2, HSDP on
(dcn=2, dp=2) and (dcn=2, tp=2), dp=2 x sp=2, tp=2 x sp=2 and fsdp over
dp=2 with sp=2 replicating (HSDP's form). One 4-rank
group runs for the module (``tests/torch_parallel_worker.py`` with WORLD
4); each case compares one layout's update on the same global batch of 8.
The group also runs the ring of 4 on a padded S, held against the plain
ring."""

import numpy as np
import pytest
import torch

import torch_parallel_worker as w
from multimodaldiscussiontransformer_tpu_torch.ops import ring_attention as ra
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
MESHES = {"dp4": {"dp": 4, "tp": 1}, "fsdp4": {"dp": 4, "tp": 1}, "tp2_dp2": {"dp": 2, "tp": 2},
          "slices2_dp2": {"dcn": 2, "dp": 2, "tp": 1}, "slices2_tp2": {"dcn": 2, "dp": 1, "tp": 2},
          "dp2_sp2": {"dp": 2, "tp": 1, "sp": 2}, "tp2_sp2": {"dp": 1, "tp": 2, "sp": 2},
          "fsdp2_sp2": {"dp": 2, "tp": 1, "sp": 2}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(every rank's results, the one-process update, the initial params)."""
    ranks = w.spawn(4, str(tmp_path_factory.mktemp("four")))
    cfg = w.four_rank_cfg()
    trainer = Trainer(cfg, image_shape=w.IMG, device="cpu")
    state = trainer.init_state()
    init = w.full_params(state)
    logs = trainer.train_step(state, w.first_group(trainer, w.dataset(), 3))
    return ranks, {"logs": w.scalars(logs), "params": w.full_params(state)}, init


@pytest.mark.parametrize("layout", list(w.FOUR_RANK_LAYOUTS))
def test_four_rank_update_matches_one_process(run, layout):
    """Every rank holds the same whole params; the loss, sample size and
    global gradient norm equal one process's (rtol 1e-5); the params after
    AdamW within rtol 2e-4 where the step is a full Adam step, else within
    2.05 lr (the sign of a noise-sized gradient)."""
    ranks, one, init = run
    assert all(r[layout]["mesh"] == MESHES[layout] for r in ranks)
    for r in ranks[1:]:
        for k, v in r[layout]["params"].items():
            assert torch.equal(v, ranks[0][layout]["params"][k]), k
    for key in ("loss", "sample_size", "ncorrect", "gnorm"):
        np.testing.assert_allclose(ranks[0][layout]["logs"][key], one["logs"][key], rtol=1e-5, err_msg=key)
    lr0 = 1e-3 / 2
    for k, p in one["params"].items():
        got, ref, start = ranks[0][layout]["params"][k].numpy(), p.numpy(), init[k].numpy()
        big = np.abs(ref - start) > 0.5 * lr0
        np.testing.assert_allclose(got[big], ref[big], rtol=2e-4, atol=2e-5, err_msg=k)
        assert (np.abs(got - ref) <= 2.05 * lr0 + 1e-7).all(), k


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_ring_of_four_matches_the_plain_ring(run, rate):
    """The ring over 4 ranks on S = 13 padded to 16 (the last strip's rows
    13 .. 15 padded): every rank's strip of the output and of dq, dk, dv,
    and the ranks' dLUT summed, equal the plain ring within 1e-5."""
    ranks, _, _ = run
    q, k, v, template, ids, lut, cot = w.ring_inputs()
    qp, kp, vp, tpl, idp = ra.pad_compact(q, k, v, template, ids, 4)
    leaves = [x.clone().requires_grad_(True) for x in (qp, kp, vp, lut)]
    ref = ra.ring_tree_attention_reference(*leaves[:3], tpl, idp, leaves[3], 4, seed=77 if rate else 0, rate=rate,
                                           shard=1)
    ref.backward(torch.nn.functional.pad(cot, (0, 0, 0, 3)))
    parts = [r["ring4"][f"rate{rate}"] for r in ranks]
    for name, want in zip(("out", "dq", "dk", "dv"), (ref, *(x.grad for x in leaves[:3]))):
        got = torch.cat([p[name] for p in parts], dim=2)
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(sum(p["dlut"] for p in parts).numpy(), leaves[3].grad.numpy(), rtol=1e-5, atol=1e-5)
