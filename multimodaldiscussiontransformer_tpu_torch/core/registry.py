"""Named registries for architectures, tasks, criterions and datasets: the
port's copy of the JAX package's ``core/registry.py``, with the names the
reference's launch configs use (``multi_graphormer_base``,
``node_prediction``, ``contrastive_learning``, ``node_cross_entropy``,
``contrastive_loss``, ``synthetic``, ``hateful_discussions``). The port
registers what it has; other names raise ``KeyError`` listing what exists.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """A name -> object registry with a decorator interface."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[Any], Any]:
        def decorator(obj: Any) -> Any:
            if name in self._entries:
                raise ValueError(f"{self.kind} registry already has an entry named {name!r}")
            self._entries[name] = obj
            return obj

        return decorator

    def get(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(f"Unknown {self.kind} {name!r}. Available: {sorted(self._entries)}")
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries


ARCHITECTURES = Registry("architecture")
TASKS = Registry("task")
CRITERIONS = Registry("criterion")
DATASETS = Registry("dataset")

register_model_architecture = ARCHITECTURES.register
register_task = TASKS.register
register_criterion = CRITERIONS.register
register_dataset = DATASETS.register


def populate() -> None:
    """Import every module that registers something (idempotent)."""
    import importlib

    for mod in (
        "multimodaldiscussiontransformer_tpu_torch.models.mdt",
        "multimodaldiscussiontransformer_tpu_torch.losses.node_cross_entropy",
        "multimodaldiscussiontransformer_tpu_torch.losses.contrastive_loss",
        "multimodaldiscussiontransformer_tpu_torch.tasks.node_prediction",
        "multimodaldiscussiontransformer_tpu_torch.tasks.contrastive",
        "multimodaldiscussiontransformer_tpu_torch.data.synthetic",
        "multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset",
    ):
        importlib.import_module(mod)
