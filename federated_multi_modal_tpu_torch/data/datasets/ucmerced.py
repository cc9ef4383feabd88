"""UC Merced land-use dataset with captions and PatternNet-vocabulary
folder merging (a copy of
``federated_multi_modal_tpu/data/datasets/ucmerced.py``).

Rebuild of ``datasets/ucmerced.py``: the in-loader ``rename_map`` merges
UCMerced folder names into PatternNet's class vocabulary before labels are
assigned (``:40-109``); splits/captions/shots handled like PatternNet.
"""

import os

from federated_multi_modal_tpu_torch.data.dataset_base import (
    DatasetBase,
    fewshot_with_cache,
    subsample_classes,
)
from federated_multi_modal_tpu_torch.data.datasets.patternnet import (
    read_split_captioned,
    save_split_captioned,
    scan_and_split_captioned,
)
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY

# UC Merced -> PatternNet vocabulary (reference ucmerced.py:42-51; the same
# map is re-applied by the federated aggregator, maple_fed.py:84-96)
UCMERCED_RENAME_MAP = {
    "tenniscourt": "tennis_court",
    "golfcourse": "golf_course",
    "parkinglot": "parking_lot",
    "storagetanks": "storage_tank",
    "mobilehomepark": "mobile_home_park",
    "baseballdiamond": "baseball_field",
    "denseresidential": "dense_residential",
    "sparseresidential": "sparse_residential",
}


@DATASET_REGISTRY.register()
class Ucmerced(DatasetBase):
    dataset_dir = "Ucmerced"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "Images")
        self.caption_dir = os.path.join(self.dataset_dir, "Captions")
        self.split_path = os.path.join(self.dataset_dir, "Ucmerced.json")
        self.shots_dir = os.path.join(self.dataset_dir, "shots")

        if os.path.exists(self.split_path):
            train, val, test = read_split_captioned(
                self.split_path, self.image_dir, self.caption_dir
            )
        else:
            train, val, test = scan_and_split_captioned(
                self.image_dir, self.caption_dir, rename_map=UCMERCED_RENAME_MAP
            )
            save_split_captioned(train, val, test, self.split_path, self.image_dir)

        train, val = fewshot_with_cache(cfg, self.shots_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)
