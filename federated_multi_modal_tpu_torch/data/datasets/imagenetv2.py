"""ImageNetV2 (test-only domain shift; rebuild of ``datasets/imagenetv2.py``:
numeric class folders 0..999 indexed through classnames.txt order).

A copy of the JAX package's ``data/datasets/imagenetv2.py``:
the same lists and split files."""

import os

from federated_multi_modal_tpu_torch.data.dataset_base import DatasetBase
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.data.datasets.imagenet import ImageNet
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY
from federated_multi_modal_tpu_torch.utils.io import listdir_nohidden


@DATASET_REGISTRY.register()
class ImageNetV2(DatasetBase):
    dataset_dir = "imagenetv2"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(
            self.dataset_dir, "imagenetv2-matched-frequency-format-val"
        )
        text_file = os.path.join(self.dataset_dir, "classnames.txt")
        classnames = ImageNet.read_classnames(text_file)
        data = self.read_data(classnames)
        super().__init__(train_x=data, test=data)

    def read_data(self, classnames):
        folders = list(classnames.keys())
        items = []
        for label in range(1000):
            class_dir = os.path.join(self.image_dir, str(label))
            classname = classnames[folders[label]]
            for imname in listdir_nohidden(class_dir):
                items.append(
                    Datum(
                        impath=os.path.join(class_dir, imname),
                        label=label,
                        classname=classname,
                    )
                )
        return items
