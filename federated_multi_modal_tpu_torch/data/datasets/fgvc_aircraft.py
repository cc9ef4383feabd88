"""FGVCAircraft (rebuild of ``datasets/fgvc_aircraft.py``: variants.txt +
images_variant_{split}.txt lists).

A copy of the JAX package's ``data/datasets/fgvc_aircraft.py``:
the same lists and split files."""

import os

from federated_multi_modal_tpu_torch.data.dataset_base import (
    DatasetBase,
    fewshot_with_cache,
    subsample_classes,
)
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class FGVCAircraft(DatasetBase):
    dataset_dir = "fgvc_aircraft"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.split_fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")

        classnames = []
        with open(os.path.join(self.dataset_dir, "variants.txt"), "r") as f:
            classnames = [line.strip() for line in f if line.strip()]
        cname2lab = {c: i for i, c in enumerate(classnames)}

        train = self.read_data(cname2lab, "images_variant_train.txt")
        val = self.read_data(cname2lab, "images_variant_val.txt")
        test = self.read_data(cname2lab, "images_variant_test.txt")

        train, val = fewshot_with_cache(cfg, self.split_fewshot_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)

    def read_data(self, cname2lab, split_file):
        filepath = os.path.join(self.dataset_dir, split_file)
        items = []
        with open(filepath, "r") as f:
            for line in f:
                parts = line.strip().split(" ")
                if not parts or not parts[0]:
                    continue
                imname = parts[0] + ".jpg"
                classname = " ".join(parts[1:])
                items.append(
                    Datum(
                        impath=os.path.join(self.image_dir, imname),
                        label=cname2lab[classname],
                        classname=classname,
                    )
                )
        return items
