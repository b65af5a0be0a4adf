"""Node-prediction (hate-speech classification) task, as in the JAX
package's ``tasks/node_prediction.py``. Restoring another run's params with
``--reset-optimizer`` draws the classifier afresh
(``transfer_from_contrastive``), the intent of the reference's head reset."""

from __future__ import annotations

from typing import Dict

import torch

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

    def transfer_from_contrastive(self, params: Dict[str, torch.Tensor], seed: int = 0) -> Dict[str, torch.Tensor]:
        """The head reset of a contrastive -> node-prediction transfer (the
        intent of node_prediction.py:44-54): a new state_dict with the
        ``node_classifier`` drawn afresh from a CPU generator seeded with
        ``seed``."""
        from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import reset_classifier_head

        return reset_classifier_head(params, torch.Generator().manual_seed(seed))
