"""EuroSAT with BLIP-caption integration (a copy of
``federated_multi_modal_tpu/data/datasets/eurosat.py``; rebuild of
``datasets/eurosat.py``:
NEW_CNAMES remap at ``:13-24``; ``_add_captions`` loads from a parallel
``captions/`` tree and raises when missing, ``:75-97``)."""

import os

from federated_multi_modal_tpu_torch.data.dataset_base import (
    DatasetBase,
    fewshot_with_cache,
    read_and_split_data,
    read_split,
    save_split,
    subsample_classes,
)
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY

NEW_CNAMES = {
    "AnnualCrop": "Annual Crop Land",
    "Forest": "Forest",
    "HerbaceousVegetation": "Herbaceous Vegetation Land",
    "Highway": "Highway or Road",
    "Industrial": "Industrial Buildings",
    "Pasture": "Pasture Land",
    "PermanentCrop": "Permanent Crop Land",
    "Residential": "Residential Buildings",
    "River": "River",
    "SeaLake": "Sea or Lake",
}


@DATASET_REGISTRY.register()
class EuroSAT(DatasetBase):
    dataset_dir = "eurosat"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "2750")
        self.caption_dir = os.path.join(self.dataset_dir, "captions")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_EuroSAT.json")
        self.split_fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            train, val, test = read_and_split_data(
                self.image_dir, new_cnames=NEW_CNAMES
            )
            save_split(train, val, test, self.split_path, self.image_dir)

        train = self._add_captions(train)
        val = self._add_captions(val)
        test = self._add_captions(test)

        train, val = fewshot_with_cache(cfg, self.split_fewshot_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)

    def _add_captions(self, data):
        return [
            Datum(
                impath=d.impath,
                label=d.label,
                classname=d.classname,
                caption=self._load_caption(d.impath),
            )
            for d in data
        ]

    def _load_caption(self, image_path):
        rel = os.path.relpath(image_path, self.image_dir)
        caption_path = os.path.splitext(os.path.join(self.caption_dir, rel))[0] + ".txt"
        if os.path.exists(caption_path):
            with open(caption_path, "r") as f:
                return f.read().strip()
        raise FileNotFoundError(f"Caption file missing: {caption_path}")
