"""Synthetic captioned dataset for tests and offline benchmarks (a copy of
``federated_multi_modal_tpu/data/datasets/synthetic.py``; the same tree).

Generates a small class-per-folder image tree (with a parallel caption
tree) under ``DATASET.ROOT`` on first use, then behaves like any other
catalog dataset.  No reference equivalent — this replaces the reference's
reliance on downloaded datasets for smoke-testing (its only test strategy
was benchmark scripts over real data, SURVEY.md §4).
"""

import os

import numpy as np

from federated_multi_modal_tpu_torch.data.dataset_base import (
    DatasetBase,
    fewshot_with_cache,
    subsample_classes,
)
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY
from federated_multi_modal_tpu_torch.utils.io import mkdir_if_missing

CLASSNAMES = ["red_square", "green_circle", "blue_stripe", "yellow_noise"]


def generate_synthetic_tree(
    root: str, n_per_class: int = 12, image_size: int = 64, seed: int = 0
):
    image_dir = os.path.join(root, "synthetic", "images")
    caption_dir = os.path.join(root, "synthetic", "captions")
    if os.path.exists(image_dir):
        return image_dir, caption_dir
    # only writing the tree needs PIL: a machine without it reads a tree
    # written elsewhere
    from PIL import Image

    rng = np.random.default_rng(seed)
    for ci, cname in enumerate(CLASSNAMES):
        cdir = os.path.join(image_dir, cname)
        capdir = os.path.join(caption_dir, cname)
        mkdir_if_missing(cdir)
        mkdir_if_missing(capdir)
        for i in range(n_per_class):
            img = rng.integers(0, 40, (image_size, image_size, 3), np.uint8)
            if ci == 0:
                img[16:48, 16:48, 0] = 220
            elif ci == 1:
                yy, xx = np.mgrid[:image_size, :image_size]
                mask = (yy - 32) ** 2 + (xx - 32) ** 2 < 18 ** 2
                img[..., 1][mask] = 220
            elif ci == 2:
                img[:, ::4, 2] = 220
            else:
                img[..., 0] = rng.integers(100, 255, (image_size, image_size))
            Image.fromarray(img).save(os.path.join(cdir, f"img_{i:03d}.jpg"))
            with open(os.path.join(capdir, f"img_{i:03d}.txt"), "w") as f:
                f.write(f"a photo of a {cname.replace('_', ' ')}")
    return image_dir, caption_dir


@DATASET_REGISTRY.register()
class Synthetic(DatasetBase):
    dataset_dir = "synthetic"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        image_dir, caption_dir = generate_synthetic_tree(root)
        self.image_dir = image_dir
        self.caption_dir = caption_dir
        self.shots_dir = os.path.join(root, "synthetic", "shots")

        train, val, test = [], [], []
        for label, cname in enumerate(CLASSNAMES):
            cdir = os.path.join(image_dir, cname)
            files = sorted(os.listdir(cdir))
            for i, fn in enumerate(files):
                impath = os.path.join(cdir, fn)
                cappath = os.path.join(
                    caption_dir, cname, os.path.splitext(fn)[0] + ".txt"
                )
                with open(cappath) as f:
                    caption = f.read().strip()
                d = Datum(
                    impath=impath, label=label, classname=cname, caption=caption
                )
                (train if i % 3 < 1 else val if i % 3 < 2 else test).append(d)

        train, val = fewshot_with_cache(cfg, self.shots_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)
