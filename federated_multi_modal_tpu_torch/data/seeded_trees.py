"""Seeded stand-ins for the captioned remote-sensing datasets the federated
trainer reads, in each dataset's own folder layout: PatternNet (38 classes,
256 x 256 JPEG), UC Merced (21 classes, 256 x 256 TIFF) and EuroSAT (10
classes, 64 x 64 JPEG), with the public class names and a caption file
beside each image. Images are seeded noise; nothing is downloaded. The real
datasets, where present under ``DATASET.ROOT``, take the same paths.

``write_seeded_tree(root, "PatternNet", per_class=4)`` writes
``root/PatternNet/images/<class>/<class>000.jpg`` and
``root/PatternNet/Captions/<class>/<class>000.txt``.
"""

from __future__ import annotations

import os

import numpy as np

PATTERNNET_CLASSES = (
    "airplane", "baseball_field", "basketball_court", "beach", "bridge", "cemetery",
    "chaparral", "christmas_tree_farm", "closed_road", "coastal_mansion", "crosswalk",
    "dense_residential", "ferry_terminal", "football_field", "forest", "freeway",
    "golf_course", "harbor", "intersection", "mobile_home_park", "nursing_home",
    "oil_gas_field", "oil_well", "overpass", "parking_lot", "parking_space", "railway",
    "river", "runway", "runway_marking", "shipping_yard", "solar_panel",
    "sparse_residential", "storage_tank", "swimming_pool", "tennis_court",
    "transformer_station", "wastewater_treatment_plant",
)
UCMERCED_CLASSES = (
    "agricultural", "airplane", "baseballdiamond", "beach", "buildings", "chaparral",
    "denseresidential", "forest", "freeway", "golfcourse", "harbor", "intersection",
    "mediumresidential", "mobilehomepark", "overpass", "parkinglot", "river", "runway",
    "sparseresidential", "storagetanks", "tenniscourt",
)
EUROSAT_CLASSES = (
    "AnnualCrop", "Forest", "HerbaceousVegetation", "Highway", "Industrial", "Pasture",
    "PermanentCrop", "Residential", "River", "SeaLake",
)

# dataset -> (image dir, caption dir, classes, published image side, file
# name of image i of a class without its extension, extension)
LAYOUTS = {
    "PatternNet": ("PatternNet/images", "PatternNet/Captions", PATTERNNET_CLASSES, 256,
                   "{cls}{i:03d}", ".jpg"),
    "Ucmerced": ("Ucmerced/Images", "Ucmerced/Captions", UCMERCED_CLASSES, 256,
                 "{cls}{i:02d}", ".tif"),
    "EuroSAT": ("eurosat/2750", "eurosat/captions", EUROSAT_CLASSES, 64,
                "{cls}_{n}", ".jpg"),
}


def write_seeded_tree(root: str, name: str, per_class: int, seed: int = 0,
                      size: int = 0) -> str:
    """Write ``per_class`` seeded images of every class of dataset ``name``
    (at the published side, or ``size``) and a caption file beside each;
    returns the image directory. An existing tree is left as it is."""
    image_rel, caption_rel, classes, side, stem, ext = LAYOUTS[name]
    image_dir = os.path.join(root, image_rel)
    if os.path.exists(image_dir):
        return image_dir
    from PIL import Image  # only writing the tree needs PIL

    side = size or side
    rng = np.random.default_rng(seed)
    for cls in classes:
        os.makedirs(os.path.join(image_dir, cls))
        os.makedirs(os.path.join(root, caption_rel, cls))
        for i in range(per_class):
            base = stem.format(cls=cls, i=i, n=i + 1)
            pixels = rng.integers(0, 256, (side, side, 3), np.uint8)
            Image.fromarray(pixels).save(os.path.join(image_dir, cls, base + ext))
            with open(os.path.join(root, caption_rel, cls, base + ".txt"), "w") as f:
                f.write(f"an aerial image of {cls.replace('_', ' ').lower()}, view {i}")
    return image_dir
