"""The launcher across ranks: what stays unported (``--hf-init``; ``--sp-size``
on too few ranks is refused by the mesh), the rank layout from the
FairSeq flags and from ``torchrun``'s environment, the backend a device
picks, and the parallel flags' TrainConfig against the JAX launcher."""

import dataclasses

import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.parallel import distributed
from multimodaldiscussiontransformer_tpu_torch.train import launch


def test_unported_names_only_hf_init_and_sequence_parallelism():
    """Sequence parallelism is ported: ``--hf-init`` is what stays."""
    assert sorted(launch.UNPORTED) == ["--hf-init"]
    assert "item 4" in launch.UNPORTED["--hf-init"][1]


@pytest.mark.parametrize("flags, names", [(["--sp-size", "2"], "1 devices not divisible by tp=1 x sp=2"),
                                          (["--sp-size", "2", "--dp-size", "2"], "needs 4 devices, have 1"),
                                          (["--hf-init"], "item 4")])
def test_unported_flags_exit_2_naming_what_brings_them(flags, names, capsys):
    """``--hf-init`` exits 2 naming the ROADMAP item; ``--sp-size 2`` runs,
    and on one process the mesh refuses it for too few ranks (ValueError,
    as JAX's ``make_mesh``)."""
    argv = ["--synthetic", "--tiny", "--device", "cpu", "--no-save"] + flags
    if "--hf-init" not in flags:
        with pytest.raises(ValueError, match=names):
            launch.main(argv)
        return
    with pytest.raises(SystemExit) as e:
        launch.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and names in err


@pytest.mark.parametrize("rank", [0, 3])
def test_fairseq_flags_and_torchrun_env_give_the_same_layout(rank):
    flags = distributed.rank_layout(4, rank, "tcp://10.0.0.1:29500", env={})
    bare = distributed.rank_layout(4, rank, "10.0.0.1:29500", env={})
    env = distributed.rank_layout(env={"RANK": str(rank), "WORLD_SIZE": "4", "LOCAL_RANK": str(rank),
                                       "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500"})
    assert flags == bare == env == distributed.RankLayout(rank, 4, rank, "tcp://10.0.0.1:29500")


@pytest.mark.parametrize("argv", [["--distributed-world-size", "2"], ["--distributed-world-size", "2",
                                                                      "--distributed-rank", "2", "--distributed-init-method", "h:1"]])
def test_bad_rank_layouts_raise(argv):
    args = launch.build_parser().parse_args(argv)
    with pytest.raises(ValueError):
        distributed.rank_layout(args.distributed_world_size, args.distributed_rank, args.distributed_init_method, env={})


@pytest.mark.parametrize("device, backend, want", [("cpu", None, "gloo"), ("cuda", None, "nccl"),
                                                   ("cuda", "gloo", "gloo"), ("cuda:1", None, "nccl")])
def test_device_picks_the_backend(device, backend, want):
    assert distributed.choose_backend(device, backend) == want


def test_cuda_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(distributed.RankLayout(0, 2, 0, "tcp://127.0.0.1:1"), "cuda")


def test_one_rank_without_a_rendezvous_starts_no_group():
    assert distributed.initialize(distributed.RankLayout(), "cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_parallel_flags_resolve_as_in_jax():
    """``--dp-size/--tp-size/--num-slices/--fsdp`` reach the TrainConfig as
    the JAX launcher puts them there; ``--sp-size`` also turns on
    ``sequence_parallel``, as in JAX."""
    from multimodaldiscussiontransformer_tpu.train import launch as jlaunch

    for argv in (["--synthetic", "--dp-size", "2", "--tp-size", "2", "--fsdp", "--num-slices", "2"],
                 ["--synthetic", "--tiny", "--sp-size", "4"]):
        want = dataclasses.asdict(jlaunch.config_from_args(jlaunch.build_parser().parse_args(argv)))
        got = dataclasses.asdict(launch.config_from_args(launch.build_parser().parse_args(argv)))
        for key in ("dp_size", "tp_size", "sp_size", "num_slices", "fsdp"):
            assert got[key] == want[key], (argv, key)
        assert got["model"]["sequence_parallel"] == want["model"]["sequence_parallel"]


def test_help_says_world_size_counts_ranks(capsys):
    with pytest.raises(SystemExit):
        launch.main(["--help"])
    out = capsys.readouterr().out
    assert "number of RANKS, one process per card" in " ".join(out.split())


@pytest.mark.parametrize("rank, world", [(0, 1), (0, 2), (1, 2), (2, 4)])
def test_per_host_batch_indices_slices_like_jax(rank, world):
    """The port's ``per_host_batch_indices`` is JAX's with the rank passed
    in (JAX reads its process index: one process here, the full slice)."""
    import numpy as np

    from multimodaldiscussiontransformer_tpu.parallel import distributed as jdist

    idx = np.arange(100, 112)
    got = distributed.per_host_batch_indices(idx, 12, rank, world)
    per = 12 // world
    np.testing.assert_array_equal(got, idx[rank * per:(rank + 1) * per])
    if world == 1:
        np.testing.assert_array_equal(got, jdist.per_host_batch_indices(idx, 12))
    with pytest.raises(ValueError):
        distributed.per_host_batch_indices(idx, 10, 0, 4)
    assert distributed.process_info()[:2] == (0, 1)
