"""StanfordCars (rebuild of ``datasets/stanford_cars.py``: devkit .mat
annotations; classname reordered year-first).

A copy of the JAX package's ``data/datasets/stanford_cars.py``:
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
class StanfordCars(DatasetBase):
    dataset_dir = "stanford_cars"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_StanfordCars.json")
        self.split_fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.dataset_dir)
        else:
            trainval_file = os.path.join(self.dataset_dir, "devkit", "cars_train_annos.mat")
            test_file = os.path.join(self.dataset_dir, "cars_test_annos_withlabels.mat")
            meta_file = os.path.join(self.dataset_dir, "devkit", "cars_meta.mat")
            trainval = self.read_data("cars_train", trainval_file, meta_file)
            test = self.read_data("cars_test", test_file, meta_file)
            train, val = split_trainval(trainval)
            save_split(train, val, test, self.split_path, self.dataset_dir)

        train, val = fewshot_with_cache(cfg, self.split_fewshot_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)

    def read_data(self, image_dir, anno_file, meta_file):
        from scipy.io import loadmat

        annos = loadmat(anno_file)["annotations"][0]
        meta = loadmat(meta_file)["class_names"][0]
        items = []
        for i in range(len(annos)):
            imname = annos[i]["fname"][0]
            label = int(annos[i]["class"][0, 0]) - 1
            names = meta[label][0].split(" ")
            year = names.pop(-1)
            names.insert(0, year)
            items.append(
                Datum(
                    impath=os.path.join(self.dataset_dir, image_dir, imname),
                    label=label,
                    classname=" ".join(names),
                )
            )
        return items
