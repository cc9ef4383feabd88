"""SUN397 (rebuild of ``datasets/sun397.py``: ClassName.txt +
Training_01/Testing_01 lists, hierarchical names reversed).

A copy of the JAX package's ``data/datasets/sun397.py``:
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
class SUN397(DatasetBase):
    dataset_dir = "sun397"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "SUN397")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_SUN397.json")
        self.split_fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            classnames = []
            with open(os.path.join(self.dataset_dir, "ClassName.txt"), "r") as f:
                classnames = [line.strip()[1:] for line in f if line.strip()]
            cname2lab = {c: i for i, c in enumerate(classnames)}
            trainval = self.read_data(cname2lab, "Training_01.txt")
            test = self.read_data(cname2lab, "Testing_01.txt")
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
                imname = line.strip()[1:]  # remove leading /
                if not imname:
                    continue
                classname = os.path.dirname(imname)
                label = cname2lab[classname]
                names = classname.split("/")[1:]  # drop first-letter dir
                names = names[::-1]  # indoor/outdoor first
                items.append(
                    Datum(
                        impath=os.path.join(self.image_dir, imname),
                        label=label,
                        classname=" ".join(names),
                    )
                )
        return items
