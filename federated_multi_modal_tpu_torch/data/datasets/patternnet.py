"""PatternNet remote-sensing dataset with parallel caption tree (a copy of
``federated_multi_modal_tpu/data/datasets/patternnet.py``; the same lists
and the same split JSON, so each package reads the other's).

Rebuild of ``datasets/patternnet.py``: caption-aware split reader
(``:9-31``), deterministic in-order 50/20/30 split over the flat datum list
(``:33-80`` — note the reference does NOT shuffle), caption-preserving
save/subsample, ``shots/`` few-shot cache dir.
"""

import os

from federated_multi_modal_tpu_torch.data.dataset_base import (
    DatasetBase,
    fewshot_with_cache,
    subsample_classes,
)
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY
from federated_multi_modal_tpu_torch.utils.io import (
    listdir_nohidden,
    read_json,
    write_json,
)


def load_caption(impath: str, image_dir: str, caption_dir: str):
    """Caption lives at the image's relative path under ``caption_dir`` with
    a .txt extension; missing caption -> empty string."""
    rel = os.path.relpath(impath, image_dir)
    cpath = os.path.splitext(os.path.join(caption_dir, rel))[0] + ".txt"
    if os.path.exists(cpath):
        with open(cpath, "r") as f:
            return f.read().strip()
    return ""


def read_split_captioned(filepath, image_dir, caption_dir):
    def _convert(items):
        out = []
        for row in items:
            impath = os.path.join(image_dir, row[0])
            caption = (
                row[3] if len(row) > 3 and row[3]
                else load_caption(impath, image_dir, caption_dir)
            )
            out.append(
                Datum(
                    impath=impath,
                    label=int(row[1]),
                    classname=row[2],
                    caption=caption,
                )
            )
        return out

    print(f"Reading split from {filepath}")
    split = read_json(filepath)
    return _convert(split["train"]), _convert(split["val"]), _convert(split["test"])


def save_split_captioned(train, val, test, filepath, image_dir):
    def _extract(items):
        out = []
        for item in items:
            impath = item.impath.replace(image_dir, "").lstrip("/")
            out.append([impath, item.label, item.classname, item.caption])
        return out

    write_json(
        {"train": _extract(train), "val": _extract(val), "test": _extract(test)},
        filepath,
    )
    print(f"Saved split to {filepath}")


def scan_and_split_captioned(
    image_dir, caption_dir, p_trn=0.5, p_val=0.2, rename_map=None
):
    """Scan category folders (optionally merging folders through
    ``rename_map``) and split the flat list in-order — deterministic, no
    shuffle, matching the reference's splitter."""
    categories_disk = sorted(listdir_nohidden(image_dir))
    rename_map = rename_map or {}
    cleaned = sorted({rename_map.get(c, c) for c in categories_disk})
    cat2label = {name: i for i, name in enumerate(cleaned)}

    all_data = []
    for folder in categories_disk:
        name = rename_map.get(folder, folder)
        label = cat2label[name]
        folder_dir = os.path.join(image_dir, folder)
        for image_file in sorted(listdir_nohidden(folder_dir)):
            impath = os.path.join(folder_dir, image_file)
            all_data.append(
                Datum(
                    impath=impath,
                    label=label,
                    classname=name,
                    caption=load_caption(impath, image_dir, caption_dir),
                )
            )

    n = len(all_data)
    n_trn = int(p_trn * n)
    n_val = int(p_val * n)
    return (
        all_data[:n_trn],
        all_data[n_trn : n_trn + n_val],
        all_data[n_trn + n_val :],
    )


@DATASET_REGISTRY.register()
class PatternNet(DatasetBase):
    dataset_dir = "PatternNet"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.caption_dir = os.path.join(self.dataset_dir, "Captions")
        self.split_path = os.path.join(self.dataset_dir, "patternnet.json")
        self.shots_dir = os.path.join(self.dataset_dir, "shots")

        if os.path.exists(self.split_path):
            train, val, test = read_split_captioned(
                self.split_path, self.image_dir, self.caption_dir
            )
        else:
            train, val, test = scan_and_split_captioned(
                self.image_dir, self.caption_dir
            )
            save_split_captioned(train, val, test, self.split_path, self.image_dir)

        train, val = fewshot_with_cache(cfg, self.shots_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)
