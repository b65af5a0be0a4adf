"""The kernel timers read device time from ``torch.profiler``, which drops
some launches at times. ``chip_smoke.device_ms`` runs a session again when
a kernel's count shows launches missing, and the tree kernels' A/B tool
(``utils/tree_kernel_ab.py``) times a kernel over the launches the profiler
saw. A stand-in profiler on the CPU replays sessions with launches dropped.
"""

import os
import sys
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.utils import tree_kernel_ab  # noqa: E402


class FakeProfile:
    """Stands in for ``torch.profiler.profile``: session i reports
    ``sessions[i]``, a list of (kernel name, launches seen, device us)."""

    def __init__(self, sessions):
        self.sessions = list(sessions)
        self.opened = 0

    def __call__(self, activities=None):
        return self

    def __enter__(self):
        self.events = [SimpleNamespace(key=k, count=c, self_device_time_total=us)
                       for k, c, us in self.sessions[self.opened]]
        self.opened += 1
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return self.events


@pytest.fixture
def fake_profiler(monkeypatch):
    def install(sessions):
        fake = FakeProfile(sessions)
        monkeypatch.setattr(torch.profiler, "profile", fake)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
        return fake
    return install


@pytest.mark.parametrize("sessions, want_ms, opened", [
    # whole at once: a memset and a kernel per call
    ([[("memset", 20, 40.0), ("dq_kernel", 20, 800.0)]], 0.042, 1),
    # the first session lost 9 of the kernel's 20 launches (the reading
    # would have been about half), the second saw them all
    ([[("dkv_kernel", 11, 480.0)], [("dkv_kernel", 20, 880.0)]], 0.044, 2),
    # a kernel launched twice a call: 40 seen is whole, 39 is not
    ([[("fwd", 39, 390.0), ("tail", 20, 20.0)], [("fwd", 40, 400.0), ("tail", 20, 20.0)]], 0.021, 2),
])
def test_device_ms_reruns_a_session_that_lost_launches(fake_profiler, sessions, want_ms, opened):
    fake = fake_profiler(sessions)
    calls = []
    got = chip_smoke.device_ms(lambda: calls.append(1), iters=20)
    assert got == pytest.approx(want_ms)
    assert fake.opened == opened and len(calls) == 1 + 20 * opened


def test_device_ms_gives_up_after_its_sessions(fake_profiler):
    """Three sessions that all lost launches give None, and ``timed_ms``
    then times by CUDA events."""
    fake = fake_profiler([[("k", 19, 190.0)]] * 3)
    assert chip_smoke.device_ms(lambda: None, iters=20) is None
    assert fake.opened == 3


def test_device_ms_without_device_time_is_none(fake_profiler):
    fake_profiler([[]])
    assert chip_smoke.device_ms(lambda: None, iters=20) is None


def test_round_ms_times_over_the_launches_seen(fake_profiler):
    """The A/B tool's round: each kernel's device time over the launches of
    it the profiler saw, with the counts beside."""
    fake_profiler([[("void tree_attention_fwd_mma_kernel<64>", 93, 0.0062 * 93 * 1e3),
                    ("void tree_attention_bwd_dq_mma_kernel<64, 2>", 200, 0.012 * 200 * 1e3),
                    ("memset (Device)", 200, 100.0),
                    ("void tree_attention_bwd_dkv_mma_kernel<64, 2>", 200, 0.0107 * 200 * 1e3)]])
    got = tree_kernel_ab.round_ms({"fwd": lambda: None, "dq": lambda: None, "dkv": lambda: None}, 200)
    assert got["events"] == {"fwd": 93, "dq": 200, "dkv": 200}
    assert got["fwd"] == pytest.approx(0.0062) and got["dq"] == pytest.approx(0.012)
    assert got["dkv"] == pytest.approx(0.0107)


def test_tree_kernel_ab_refuses_without_a_card(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tree_kernel_ab.main([str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
