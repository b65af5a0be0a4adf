"""Node-prediction (hate-speech classification) task, as in the JAX
package's ``tasks/node_prediction.py``."""

from __future__ import annotations

from typing import Any

from multimodaldiscussiontransformer_tpu_torch.core.config import TrainConfig
from multimodaldiscussiontransformer_tpu_torch.core.registry import register_task
from multimodaldiscussiontransformer_tpu_torch.tasks.task import Task


@register_task("node_prediction")
class NodePredictionTask(Task):
    contrastive = False

    def __init__(self, cfg: TrainConfig):
        if cfg.criterion != "node_cross_entropy":
            cfg = cfg.replace(criterion="node_cross_entropy")
        super().__init__(cfg)

    def transfer_from_contrastive(self, params: Any, seed: int = 0) -> Any:
        """The head reset of a contrastive -> node-prediction transfer."""
        raise NotImplementedError("contrastive transfer comes with the contrastive slice of the port")
