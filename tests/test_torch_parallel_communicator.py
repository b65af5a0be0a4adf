"""The NCCL communicator of a run across ranks starts when the process group
starts (``parallel/distributed.py::initialize`` -> ``start_communicator``:
one all-reduce on the rank's device), not inside a layout's first
collective; FSDP2's first all-gather runs on FSDP2's own streams (ROADMAP
Queue 3, ``fsdp=4`` on four cards). A gloo group starts nothing. The group
is stubbed: NCCL needs cards. These tests pin the eager start in place; they
do not reproduce the four-card fault, whose check is the four-card
``parallel`` phase of ``chip_smoke.py``."""

import pytest
import torch
import torch.distributed as dist

from multimodaldiscussiontransformer_tpu_torch.parallel import distributed


@pytest.fixture
def calls(monkeypatch):
    seen = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda **k: seen.append(("init", k["backend"], k["rank"])))
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: seen.append(("all_reduce", t.device, t.numel())))
    return seen


@pytest.mark.parametrize("rank", [0, 3])
def test_an_nccl_group_starts_its_communicator_with_the_group(calls, rank):
    layout = distributed.RankLayout(rank=rank, world_size=4, init_method="tcp://127.0.0.1:29599")
    dev = distributed.initialize(layout, "cpu", "nccl")
    assert calls == [("init", "nccl", rank), ("all_reduce", dev, 1)]


def test_a_gloo_group_starts_nothing_more(calls):
    layout = distributed.RankLayout(rank=1, world_size=2, init_method="tcp://127.0.0.1:29599")
    distributed.initialize(layout, "cpu", "gloo")
    assert calls == [("init", "gloo", 1)]


def test_one_rank_without_a_rendezvous_starts_no_group(calls):
    assert distributed.initialize(distributed.RankLayout(), "cpu") == torch.device("cpu")
    assert calls == []
