"""Contrastive pre-training task over the global discussion embeddings, as in
the JAX package's ``tasks/contrastive.py`` (the reference's
``ContrastiveLearningTask``): the collator emits per-graph ``y`` and
``hard_y``, and the criterion is ``contrastive_loss``. Its checkpoint seeds
the node task through ``--restore-file --reset-optimizer``."""

from __future__ import annotations

from multimodaldiscussiontransformer_tpu_torch.core.config import TrainConfig
from multimodaldiscussiontransformer_tpu_torch.core.registry import register_task
from multimodaldiscussiontransformer_tpu_torch.tasks.task import Task


@register_task("contrastive_learning")
class ContrastiveLearningTask(Task):
    contrastive = True

    def __init__(self, cfg: TrainConfig):
        if cfg.criterion != "contrastive_loss":
            cfg = cfg.replace(criterion="contrastive_loss")
        if cfg.task != "contrastive_learning":
            cfg = cfg.replace(task="contrastive_learning")
        super().__init__(cfg)
