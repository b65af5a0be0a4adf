"""Task base: the registered dataset factory, the criterion and the trainer,
as in the JAX package's ``tasks/task.py`` (the criterion as the JAX
``Trainer._build_criterion`` builds it)."""

from __future__ import annotations

import importlib.util
import os
import sys

from multimodaldiscussiontransformer_tpu_torch.core.config import TrainConfig
from multimodaldiscussiontransformer_tpu_torch.core.registry import CRITERIONS, DATASETS, populate
from multimodaldiscussiontransformer_tpu_torch.data.dataset import DiscussionDataset


def import_user_datasets(user_data_dir: str) -> None:
    """Import every module in ``user_data_dir`` so that its
    ``register_dataset`` decorators fire."""
    if not user_data_dir or not os.path.isdir(user_data_dir):
        return
    for fname in sorted(os.listdir(user_data_dir)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"mdt_user_datasets.{os.path.splitext(fname)[0]}", os.path.join(user_data_dir, fname)
        )
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)


def build_criterion(cfg: TrainConfig):
    """The criterion ``cfg.criterion`` names, with the config's weights:
    the class weights for ``node_cross_entropy``, the soft-negative weight
    and scale for ``contrastive_loss``."""
    populate()
    cls = CRITERIONS.get(cfg.criterion)
    if cfg.criterion == "node_cross_entropy":
        return cls(positive_weight=cfg.positive_weight, negative_weight=cfg.negative_weight)
    if cfg.criterion == "contrastive_loss":
        return cls(
            soft_negative_weight=cfg.soft_negative_weight,
            adaptive_soft_negative_weight=cfg.adaptive_soft_negative_weight,
            multiplication_scale=cfg.multiplication_scale,
        )
    return cls()


class Task:
    """Binds a TrainConfig to a registered dataset and a Trainer."""

    contrastive = False

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        if cfg.task_cfg.user_data_dir:
            import_user_datasets(cfg.task_cfg.user_data_dir)

    def load_dataset(self, **factory_kwargs) -> DiscussionDataset:
        """The ``DiscussionDataset`` that the factory registered under
        ``task_cfg.dataset_name`` builds."""
        populate()
        return DATASETS.get(self.cfg.task_cfg.dataset_name)(**factory_kwargs)

    def build_trainer(self, **kw):
        from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

        return Trainer(self.cfg, **kw)
