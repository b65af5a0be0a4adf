"""Task base: the registered dataset factory and the trainer, as in the JAX
package's ``tasks/task.py``."""

from __future__ import annotations

import importlib.util
import os
import sys

from multimodaldiscussiontransformer_tpu_torch.core.config import TrainConfig
from multimodaldiscussiontransformer_tpu_torch.core.registry import DATASETS, populate
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
