"""ImageNet-A (test-only; rebuild of ``datasets/imagenet_a.py``, ignores
README.txt in the image tree).

A copy of the JAX package's ``data/datasets/imagenet_a.py``:
the same lists and split files."""

import os

from federated_multi_modal_tpu_torch.data.dataset_base import DatasetBase
from federated_multi_modal_tpu_torch.data.datasets.imagenet import ImageNet
from federated_multi_modal_tpu_torch.data.datasets.imagenet_sketch import ImageNetSketch
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY

TO_BE_IGNORED = ["README.txt"]


@DATASET_REGISTRY.register()
class ImageNetA(DatasetBase):
    dataset_dir = "imagenet-adversarial"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "imagenet-a")
        text_file = os.path.join(self.dataset_dir, "classnames.txt")
        classnames = ImageNet.read_classnames(text_file)
        data = ImageNetSketch.read_data(self, classnames, ignored=TO_BE_IGNORED)
        super().__init__(train_x=data, test=data)
