"""Dataset base class: split containers, few-shot subsampling with on-disk
cache, and base/new class subsampling.

Reproduces the behavioral contract of Dassl ``DatasetBase`` +
``generate_fewshot_dataset`` plus the canonical helpers every reference
dataset plugin shares (``datasets/oxford_pets.py:16-186``): split JSON
load/save (caption-aware), the ``shot_{n}-seed_{s}.pkl`` few-shot cache, and
``subsample_classes`` with base = first ``ceil(n/2)`` sorted labels.
"""

from __future__ import annotations

import math
import os
import pickle
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.utils.io import mkdir_if_missing, read_json, write_json

# The JAX package is this package's name without its suffix; its caches hold
# its own Datum, which this package reads as its own.
_PORT = __name__.split(".")[0]
_REFERENCE = _PORT.removesuffix("_torch")
_REFERENCE_DATUM = (f"{_REFERENCE}.data.datum", "Datum")
# packages whose classes a cache may name but this package never imports
_REFUSED = (_REFERENCE, "dassl")


class CacheUnpickler(pickle.Unpickler):
    """Reads a dataset cache (a few-shot ``shot_{n}-seed_{s}.pkl``, ImageNet's
    ``preprocessed.pkl``) without importing the package that wrote it. The
    JAX package's ``Datum`` becomes this package's (the same fields); any
    other class of the JAX package or of Dassl raises
    ``pickle.UnpicklingError``, so that the caller regenerates the cache."""

    def find_class(self, module, name):
        if (module, name) == _REFERENCE_DATUM:
            return Datum
        if module.split(".")[0] in _REFUSED:
            raise pickle.UnpicklingError(
                f"cache names {module}.{name}, a class of another package")
        return super().find_class(module, name)


def load_cache(path: str):
    """Unpickle the dataset cache at ``path`` with :class:`CacheUnpickler`."""
    with open(path, "rb") as f:
        return CacheUnpickler(f).load()


class DatasetBase:
    dataset_dir = ""
    domains: Sequence[str] = ()

    def __init__(self, train_x=None, train_u=None, val=None, test=None):
        self._train_x = train_x or []
        self._train_u = train_u or []
        self._val = val or []
        self._test = test or []
        self._num_classes = self.get_num_classes(self._train_x or self._test)
        self._lab2cname, self._classnames = self.get_lab2cname(
            self._train_x or self._test
        )

    # -- accessors matching Dassl's surface ---------------------------------
    @property
    def train_x(self) -> List[Datum]:
        return self._train_x

    @train_x.setter
    def train_x(self, value):
        self._train_x = value

    @property
    def train_u(self):
        return self._train_u

    @property
    def val(self) -> List[Datum]:
        return self._val

    @val.setter
    def val(self, value):
        self._val = value

    @property
    def test(self) -> List[Datum]:
        return self._test

    @test.setter
    def test(self, value):
        self._test = value

    @property
    def lab2cname(self) -> Dict[int, str]:
        return self._lab2cname

    @property
    def classnames(self) -> List[str]:
        return self._classnames

    @property
    def num_classes(self) -> int:
        return self._num_classes

    @staticmethod
    def get_num_classes(data_source) -> int:
        return max((item.label for item in data_source), default=-1) + 1

    @staticmethod
    def get_lab2cname(data_source):
        mapping = {item.label: item.classname for item in data_source}
        labels = sorted(mapping)
        lab2cname = {lb: mapping[lb] for lb in labels}
        classnames = [mapping[lb] for lb in labels]
        return lab2cname, classnames

    # -- few-shot sampling (Dassl generate_fewshot_dataset) -----------------
    def generate_fewshot_dataset(
        self, *data_sources, num_shots: int = -1, repeat: bool = False
    ):
        if num_shots < 1:
            return data_sources[0] if len(data_sources) == 1 else data_sources

        print(f"Creating a {num_shots}-shot dataset")
        output = [
            generate_fewshot(ds, num_shots, repeat=repeat)
            for ds in data_sources
        ]
        return output[0] if len(output) == 1 else output

    @staticmethod
    def split_dataset_by_label(data_source):
        tracker = defaultdict(list)
        for item in data_source:
            tracker[item.label].append(item)
        return tracker


# --------------------------------------------------------------------------
# shared helpers used by the dataset plugins
# --------------------------------------------------------------------------


def read_split(filepath: str, path_prefix: str):
    """Load a ``split_zhou_*.json`` split; tolerates 3-tuple (no caption)
    and 4-tuple (caption) entries — the caption-aware variant is the fork's
    extension (``datasets/patternnet.py:9-31``)."""

    def _convert(items):
        out = []
        for row in items:
            impath, label, classname = row[0], row[1], row[2]
            caption = row[3] if len(row) > 3 else ""
            out.append(
                Datum(
                    impath=os.path.join(path_prefix, impath),
                    label=int(label),
                    classname=classname,
                    caption=caption,
                )
            )
        return out

    print(f"Reading split from {filepath}")
    split = read_json(filepath)
    return _convert(split["train"]), _convert(split["val"]), _convert(split["test"])


def save_split(train, val, test, filepath: str, path_prefix: str):
    def _extract(items):
        out = []
        for item in items:
            impath = item.impath.replace(path_prefix, "")
            if impath.startswith("/"):
                impath = impath[1:]
            row = [impath, item.label, item.classname]
            if item.caption:
                row.append(item.caption)
            out.append(row)
        return out

    split = {"train": _extract(train), "val": _extract(val), "test": _extract(test)}
    write_json(split, filepath)
    print(f"Saved split to {filepath}")


def split_trainval(trainval, p_val: float = 0.2):
    """Stratified train/val split (``datasets/oxford_pets.py:76-97``)."""
    p_trn = 1 - p_val
    print(f"Splitting trainval into {p_trn:.0%} train and {p_val:.0%} val")
    tracker = defaultdict(list)
    for idx, item in enumerate(trainval):
        tracker[item.label].append(idx)

    train, val = [], []
    for label, idxs in tracker.items():
        n_val = round(len(idxs) * p_val)
        assert n_val > 0
        random.shuffle(idxs)
        for n, idx in enumerate(idxs):
            item = trainval[idx]
            (val if n < n_val else train).append(item)
    return train, val


def read_and_split_data(
    image_dir: str,
    p_trn: float = 0.5,
    p_val: float = 0.2,
    ignored: Sequence[str] = (),
    new_cnames: Optional[Dict[str, str]] = None,
    caption_loader=None,
):
    """Scan ``image_dir/<category>/*`` and produce a 50/20/30 split
    (generic splitter owned by DTD in the reference, ``datasets/dtd.py:54``)."""
    from federated_multi_modal_tpu_torch.utils.io import listdir_nohidden

    categories = [
        c for c in listdir_nohidden(image_dir) if c not in ignored
    ]
    categories.sort()

    p_tst = 1 - p_trn - p_val
    print(f"Splitting into {p_trn:.0%} train, {p_val:.0%} val, and {p_tst:.0%} test")

    def _collate(ims, y, c):
        return [
            Datum(
                impath=im,
                label=y,
                classname=c,
                caption=caption_loader(im) if caption_loader else "",
            )
            for im in ims
        ]

    train, val, test = [], [], []
    for label, category in enumerate(categories):
        category_dir = os.path.join(image_dir, category)
        images = listdir_nohidden(category_dir)
        images = [os.path.join(category_dir, im) for im in images]
        random.shuffle(images)
        n_total = len(images)
        n_train = round(n_total * p_trn)
        n_val = round(n_total * p_val)
        assert n_train > 0 and n_val > 0 and n_total - n_train - n_val > 0

        if new_cnames and category in new_cnames:
            category = new_cnames[category]

        train.extend(_collate(images[:n_train], label, category))
        val.extend(_collate(images[n_train : n_train + n_val], label, category))
        test.extend(_collate(images[n_train + n_val :], label, category))

    return train, val, test


def subsample_classes(*args, subsample: str = "all"):
    """Split classes into base (first half) / new (second half) groups with
    relabeling (``datasets/oxford_pets.py:140-186``).  Captions are carried
    through (the reference's caption-aware copy is ``datasets/
    patternnet.py:103-146``)."""
    assert subsample in ("all", "base", "new")
    if subsample == "all":
        return args

    dataset = args[0]
    labels = sorted({item.label for item in dataset})
    n = len(labels)
    m = math.ceil(n / 2)
    print(f"SUBSAMPLE {subsample.upper()} CLASSES!")
    selected = labels[:m] if subsample == "base" else labels[m:]
    relabeler = {y: y_new for y_new, y in enumerate(selected)}

    output = []
    for dataset in args:
        dataset_new = []
        for item in dataset:
            if item.label not in selected:
                continue
            dataset_new.append(
                Datum(
                    impath=item.impath,
                    label=relabeler[item.label],
                    domain=item.domain,
                    classname=item.classname,
                    caption=item.caption,
                )
            )
        output.append(dataset_new)
    return output


def generate_fewshot(data_source, num_shots: int, repeat: bool = False):
    """Pure few-shot sampler over a Datum list (per-class ``num_shots``)."""
    if num_shots < 1:
        return data_source
    tracker = DatasetBase.split_dataset_by_label(data_source)
    dataset = []
    for label, items in tracker.items():
        if len(items) >= num_shots:
            dataset.extend(random.sample(items, num_shots))
        else:
            dataset.extend(random.choices(items, k=num_shots) if repeat else items)
    return dataset


def fewshot_with_cache(cfg, split_fewshot_dir: str, train, val=None):
    """Apply the few-shot protocol with the reference's pickle cache keyed
    ``shot_{n}-seed_{s}`` (``datasets/oxford_pets.py:33-49``).

    Returns ``(train, val)`` (``val`` capped at ``min(shots, 4)``); a
    ``None`` val passes through (ImageNet caches only train,
    ``datasets/imagenet.py:40-57``).
    """
    num_shots = cfg.DATASET.NUM_SHOTS
    if num_shots < 1:
        return train, val
    mkdir_if_missing(split_fewshot_dir)
    seed = cfg.SEED
    preprocessed = os.path.join(split_fewshot_dir, f"shot_{num_shots}-seed_{seed}.pkl")
    if os.path.exists(preprocessed):
        print(f"Loading preprocessed few-shot data from {preprocessed}")
        try:
            data = load_cache(preprocessed)
            return data["train"], data.get("val", val)
        except (ModuleNotFoundError, AttributeError, pickle.UnpicklingError,
                KeyError) as e:
            # cache written by the reference repo (pickled dassl Datum
            # objects) or corrupted — regenerate instead of crashing on a
            # shared data directory
            print(f"Cache {preprocessed} is incompatible ({e}); regenerating")

    print(f"Creating a {num_shots}-shot dataset")
    train = generate_fewshot(train, num_shots)
    payload = {"train": train}
    if val is not None:
        val = generate_fewshot(val, min(num_shots, 4))
        payload["val"] = val
    print(f"Saving preprocessed few-shot data to {preprocessed}")
    with open(preprocessed, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    return train, val
