"""OxfordFlowers (rebuild of ``datasets/oxford_flowers.py``: label .mat +
``cat_to_name.json``, per-class 50/20/30 split).

A copy of the JAX package's ``data/datasets/oxford_flowers.py``:
the same lists and split files."""

import os
import random
from collections import defaultdict

from federated_multi_modal_tpu_torch.data.dataset_base import (
    DatasetBase,
    fewshot_with_cache,
    read_split,
    save_split,
    subsample_classes,
)
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY
from federated_multi_modal_tpu_torch.utils.io import read_json


@DATASET_REGISTRY.register()
class OxfordFlowers(DatasetBase):
    dataset_dir = "oxford_flowers"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "jpg")
        self.label_file = os.path.join(self.dataset_dir, "imagelabels.mat")
        self.lab2cname_file = os.path.join(self.dataset_dir, "cat_to_name.json")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_OxfordFlowers.json")
        self.split_fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            train, val, test = self.read_data()
            save_split(train, val, test, self.split_path, self.image_dir)

        train, val = fewshot_with_cache(cfg, self.split_fewshot_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)

    def read_data(self):
        from scipy.io import loadmat

        tracker = defaultdict(list)
        labels = loadmat(self.label_file)["labels"][0]
        for i, label in enumerate(labels):
            imname = f"image_{str(i + 1).zfill(5)}.jpg"
            tracker[int(label)].append(os.path.join(self.image_dir, imname))

        print("Splitting data into 50% train, 20% val, and 30% test")
        lab2cname = read_json(self.lab2cname_file)
        train, val, test = [], [], []
        for label, impaths in tracker.items():
            random.shuffle(impaths)
            n_total = len(impaths)
            n_train = round(n_total * 0.5)
            n_val = round(n_total * 0.2)
            assert n_train > 0 and n_val > 0 and n_total - n_train - n_val > 0
            cname = lab2cname[str(label)]

            def _collate(ims):
                return [
                    Datum(impath=im, label=label - 1, classname=cname) for im in ims
                ]

            train.extend(_collate(impaths[:n_train]))
            val.extend(_collate(impaths[n_train : n_train + n_val]))
            test.extend(_collate(impaths[n_train + n_val :]))
        return train, val, test
