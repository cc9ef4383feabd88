"""Food101 (rebuild of ``datasets/food101.py``).

A copy of the JAX package's ``data/datasets/food101.py``:
the same lists and split files."""

import os

from federated_multi_modal_tpu_torch.data.dataset_base import (
    DatasetBase,
    fewshot_with_cache,
    read_and_split_data,
    read_split,
    save_split,
    subsample_classes,
)
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class Food101(DatasetBase):
    dataset_dir = "food-101"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_Food101.json")
        self.split_fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            train, val, test = read_and_split_data(self.image_dir)
            save_split(train, val, test, self.split_path, self.image_dir)

        train, val = fewshot_with_cache(cfg, self.split_fewshot_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)
