"""OxfordPets (behavioral rebuild of ``datasets/oxford_pets.py``).

A copy of the JAX package's ``data/datasets/oxford_pets.py``:
the same lists and split files."""

import os

from federated_multi_modal_tpu_torch.data.dataset_base import (
    DatasetBase,
    fewshot_with_cache,
    read_split,
    save_split,
    split_trainval,
    subsample_classes,
)
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class OxfordPets(DatasetBase):
    dataset_dir = "oxford_pets"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.anno_dir = os.path.join(self.dataset_dir, "annotations")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_OxfordPets.json")
        self.split_fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            trainval = self.read_data("trainval.txt")
            test = self.read_data("test.txt")
            train, val = split_trainval(trainval)
            save_split(train, val, test, self.split_path, self.image_dir)

        train, val = fewshot_with_cache(cfg, self.split_fewshot_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)

    def read_data(self, split_file):
        filepath = os.path.join(self.anno_dir, split_file)
        items = []
        with open(filepath, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                imname, label, _species, _ = line.split(" ")
                breed = "_".join(imname.split("_")[:-1]).lower()
                impath = os.path.join(self.image_dir, imname + ".jpg")
                items.append(
                    Datum(impath=impath, label=int(label) - 1, classname=breed)
                )
        return items
