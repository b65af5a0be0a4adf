"""The port's non-finite sweeps (``utils/debugging.py``) as the JAX
package's tests require them (``tests/test_debug_and_loader.py``), on the
same inputs and on their torch counterparts: ``find_nonfinite`` names the
same leaves; ``checkify_step`` passes a finite step through and raises on
the first non-finite output or gradient, naming it (``jit`` accepted and
ignored); ``nan_guard`` gives the same verdicts."""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.utils import debugging as jdebug
from multimodaldiscussiontransformer_tpu_torch.utils import debugging as pdebug

torch.set_num_threads(2)


def test_find_nonfinite_matches_jax():
    tree = {"a": {"good": np.ones(3), "bad": np.asarray([1.0, np.nan])}, "ints": np.asarray([1, 2]),
            "inf": np.asarray([np.inf]), "list": [np.zeros(2), np.asarray([-np.inf])]}
    assert set(pdebug.find_nonfinite(tree)) == set(jdebug.find_nonfinite(tree)) == {"a/bad", "inf", "list/[1]"}
    as_torch = {"a": {"good": torch.ones(3), "bad": torch.tensor([1.0, float("nan")], dtype=torch.bfloat16)},
                "ints": torch.tensor([1, 2]), "inf": torch.tensor([float("inf")]),
                "list": [torch.zeros(2), torch.tensor([-float("inf")])]}
    assert set(pdebug.find_nonfinite(as_torch)) == {"a/bad", "inf", "list/[1]"}
    model = torch.nn.Linear(2, 2)
    assert pdebug.find_nonfinite(model) == []
    with torch.no_grad():
        model.bias[1] = float("nan")
    assert pdebug.find_nonfinite(model) == ["bias"]
    assert pdebug.find_nonfinite(model.state_dict()) == ["bias"]


@pytest.mark.parametrize("jit", [True, False])
def test_checkify_step_catches_nan(jit):
    guarded = pdebug.checkify_step(torch.log, jit=jit)
    assert float(guarded(torch.tensor(1.0))) == 0.0
    with pytest.raises(FloatingPointError, match="non-finite output"):
        guarded(torch.tensor(-1.0))


def test_checkify_step_names_the_gradient():
    lin = torch.nn.Linear(3, 1)

    def step(x):
        loss = torch.sqrt(lin(x)).sum()  # sqrt of a negative: NaN loss and gradients
        loss.backward()
        return {"gnorm": torch.zeros(())}

    guarded = pdebug.checkify_step(step, params=lin.named_parameters())
    with torch.no_grad():
        lin.weight.fill_(1.0)
        lin.bias.fill_(0.0)
    guarded(torch.ones(2, 3))  # finite
    lin.zero_grad()
    with pytest.raises(FloatingPointError, match="non-finite gradient of weight"):
        guarded(-torch.ones(2, 3))


def test_nan_guard_matches_jax():
    for logs in ({"loss": 1.0, "gnorm": float("nan")}, {"loss": 1.0}, {"a": float("inf"), "b": 2.0, "c": np.nan}):
        assert pdebug.nan_guard(logs) == jdebug.nan_guard(logs)
    ok, bad = pdebug.nan_guard({"loss": torch.tensor(1.0), "gnorm": torch.tensor(float("nan"), dtype=torch.bfloat16)})
    assert not ok and bad == ["gnorm"]
