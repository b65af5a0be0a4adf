"""The NCCL communicators of a run across ranks start before training, not
inside a layout's first collective (FSDP2's first all-gather runs on
FSDP2's own streams; ROADMAP Queue 3, ``fsdp=4`` on four cards): the
default group's when the process group starts
(``parallel/distributed.py::initialize`` -> ``start_communicator``: one
all-reduce on the rank's device), and every group a mesh holds when
``parallel/mesh.py::make_mesh`` builds it (``start_communicators``). A gloo
group starts nothing. The groups are stubbed or fake: NCCL needs cards.
These tests pin the eager starts in place; they do not reproduce the
four-card fault, whose check is the four-card ``parallel`` phase of
``chip_smoke.py``."""

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


@pytest.fixture
def mesh_calls(monkeypatch):
    """A fake 8-rank default group (this process is rank 5) whose groups
    count as NCCL; ``dist.all_reduce`` records the group it is given."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    seen = []
    monkeypatch.setattr(distributed, "is_nccl", lambda group: True)
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, group=None, **k: seen.append(group))
    yield seen
    dist.destroy_process_group()


@pytest.mark.parametrize("kw", [
    dict(),  # fsdp=8 or dp=8: the (dp, tp) mesh's own dp group, not the default group
    dict(num_slices=2),  # HSDP over (dcn, dp)
    dict(tp_size=2),
    dict(tp_size=2, sp_size=2),  # the sp run's FSDP mesh, built on first use
    dict(num_slices=2, sp_size=2),
])
def test_a_mesh_starts_every_group_it_holds(mesh_calls, kw):
    """``make_mesh`` on NCCL starts the communicator of every group the
    mesh holds before it returns, each once: its dims, the data and batch
    groups and every dim of the FSDP mesh (an sp run's when it is built),
    so that none starts inside FSDP2's first all-gather (ROADMAP Queue 3:
    fsdp=4 and HSDP on four H100s came out off from dp=4 from update 1's
    forward with only the default group started). Stubbed: it pins the
    starts in place and does not reproduce the four-card fault."""
    from multimodaldiscussiontransformer_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(**kw)
    started = list(mesh_calls)
    held = [mesh.device_mesh.get_group(axis) for axis in mesh.shape] + [mesh.data_group, mesh.batch_group]
    assert all(any(g is s for s in started) for g in held)
    assert all(any(g is h for h in held) for g in started)
    assert len({id(g) for g in started}) == len(started)
    fsdp = mesh.fsdp_mesh() if callable(mesh.fsdp_mesh) else mesh.fsdp_mesh
    fsdp_groups = [fsdp.get_group(i) for i in range(fsdp.ndim)]
    assert all(any(g is s for s in mesh_calls) for g in fsdp_groups)
    if callable(mesh.fsdp_mesh):
        assert mesh_calls[len(started):] == fsdp_groups


def test_a_mesh_on_another_backend_starts_nothing(monkeypatch):
    """On gloo (and the fake backend) ``make_mesh`` runs no collective."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from multimodaldiscussiontransformer_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=4)
    try:
        seen = []
        monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: seen.append(a))
        pmesh.make_mesh(num_slices=2)
        assert seen == []
    finally:
        dist.destroy_process_group()
