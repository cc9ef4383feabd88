"""ImageNet-Sketch (test-only; rebuild of ``datasets/imagenet_sketch.py``).

A copy of the JAX package's ``data/datasets/imagenet_sketch.py``:
the same lists and split files."""

import os

from federated_multi_modal_tpu_torch.data.dataset_base import DatasetBase
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.data.datasets.imagenet import ImageNet
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY
from federated_multi_modal_tpu_torch.utils.io import listdir_nohidden


@DATASET_REGISTRY.register()
class ImageNetSketch(DatasetBase):
    dataset_dir = "imagenet-sketch"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        text_file = os.path.join(self.dataset_dir, "classnames.txt")
        classnames = ImageNet.read_classnames(text_file)
        data = self.read_data(classnames)
        super().__init__(train_x=data, test=data)

    def read_data(self, classnames, ignored=()):
        folders = listdir_nohidden(self.image_dir, sort=True)
        folders = [f for f in folders if f not in ignored]
        items = []
        for label, folder in enumerate(folders):
            classname = classnames[folder]
            for imname in listdir_nohidden(os.path.join(self.image_dir, folder)):
                items.append(
                    Datum(
                        impath=os.path.join(self.image_dir, folder, imname),
                        label=label,
                        classname=classname,
                    )
                )
        return items
