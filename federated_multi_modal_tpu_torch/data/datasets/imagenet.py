"""ImageNet (rebuild of ``datasets/imagenet.py``: preprocessed.pkl full-split
cache, classnames.txt folder->name map, val used as test).

A copy of the JAX package's ``data/datasets/imagenet.py``:
the same lists and split files."""

import os
import pickle
from collections import OrderedDict

from federated_multi_modal_tpu_torch.data.dataset_base import (
    DatasetBase,
    fewshot_with_cache,
    load_cache,
    subsample_classes,
)
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY
from federated_multi_modal_tpu_torch.utils.io import listdir_nohidden


@DATASET_REGISTRY.register()
class ImageNet(DatasetBase):
    dataset_dir = "imagenet"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.preprocessed = os.path.join(self.dataset_dir, "preprocessed.pkl")
        self.split_fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")

        train = test = None
        if os.path.exists(self.preprocessed):
            try:
                preprocessed = load_cache(self.preprocessed)
                train = preprocessed["train"]
                test = preprocessed["test"]
            except (ModuleNotFoundError, AttributeError,
                    pickle.UnpicklingError, KeyError) as e:
                # reference-written cache (pickled dassl Datums): regenerate
                print(f"Cache {self.preprocessed} incompatible ({e}); "
                      "regenerating")
        if train is None:
            text_file = os.path.join(self.dataset_dir, "classnames.txt")
            classnames = self.read_classnames(text_file)
            train = self.read_data(classnames, "train")
            # standard practice: evaluate on the val split
            test = self.read_data(classnames, "val")
            with open(self.preprocessed, "wb") as f:
                pickle.dump(
                    {"train": train, "test": test},
                    f,
                    protocol=pickle.HIGHEST_PROTOCOL,
                )

        # ImageNet caches only the train split few-shot (imagenet.py:40-57)
        train, _ = fewshot_with_cache(cfg, self.split_fewshot_dir, train, None)
        train, test = subsample_classes(
            train, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=test, test=test)

    @staticmethod
    def read_classnames(text_file):
        """``<folder> <class name...>`` per line -> OrderedDict."""
        classnames = OrderedDict()
        with open(text_file, "r") as f:
            for line in f:
                parts = line.strip().split(" ")
                if not parts or not parts[0]:
                    continue
                classnames[parts[0]] = " ".join(parts[1:])
        return classnames

    def read_data(self, classnames, split_dir):
        split_dir = os.path.join(self.image_dir, split_dir)
        folders = sorted(f.name for f in os.scandir(split_dir) if f.is_dir())
        items = []
        for label, folder in enumerate(folders):
            imnames = listdir_nohidden(os.path.join(split_dir, folder))
            classname = classnames[folder]
            for imname in imnames:
                items.append(
                    Datum(
                        impath=os.path.join(split_dir, folder, imname),
                        label=label,
                        classname=classname,
                    )
                )
        return items
