"""UCF101 mid-frames (rebuild of ``datasets/ucf101.py``: classInd.txt +
trainlist01/testlist01, CamelCase action names underscored).

A copy of the JAX package's ``data/datasets/ucf101.py``:
the same lists and split files."""

import os
import re

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
class UCF101(DatasetBase):
    dataset_dir = "ucf101"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "UCF-101-midframes")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_UCF101.json")
        self.split_fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            cname2lab = {}
            filepath = os.path.join(self.dataset_dir, "ucfTrainTestlist/classInd.txt")
            with open(filepath, "r") as f:
                for line in f:
                    if not line.strip():
                        continue
                    label, classname = line.strip().split(" ")
                    cname2lab[classname] = int(label) - 1
            trainval = self.read_data(cname2lab, "ucfTrainTestlist/trainlist01.txt")
            test = self.read_data(cname2lab, "ucfTrainTestlist/testlist01.txt")
            train, val = split_trainval(trainval)
            save_split(train, val, test, self.split_path, self.image_dir)

        train, val = fewshot_with_cache(cfg, self.split_fewshot_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)

    def read_data(self, cname2lab, text_file):
        text_file = os.path.join(self.dataset_dir, text_file)
        items = []
        with open(text_file, "r") as f:
            for line in f:
                line = line.strip().split(" ")[0]
                if not line:
                    continue
                action, filename = line.split("/")
                label = cname2lab[action]
                renamed = "_".join(re.findall("[A-Z][^A-Z]*", action))
                filename = filename.replace(".avi", ".jpg")
                items.append(
                    Datum(
                        impath=os.path.join(self.image_dir, renamed, filename),
                        label=label,
                        classname=renamed,
                    )
                )
        return items
