"""Data managers (port of ``federated_multi_modal_tpu/data/manager.py``).

``DataManager`` — Dassl-equivalent: builds the registered dataset from cfg
and the train/val/test loaders (reference call sites
``trainers/maple_fed.py:62-77``).

``ClientDataManager`` — the federated per-client manager over
pre-partitioned Datum lists (``trainers/client_datamanager.py:10-156``):
validates labels, builds loaders, exposes a ``.dataset`` namespace and a
lazy ``lab2cname`` over every split.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List

from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.data.loader import DataLoader
from federated_multi_modal_tpu_torch.data.transforms import build_transform
from federated_multi_modal_tpu_torch.engine.registry import build_dataset


def build_data_loader(
    cfg,
    sampler_type: str = "SequentialSampler",
    data_source=None,
    batch_size: int = 64,
    n_domain: int = 0,
    n_ins: int = 16,
    tfm=None,
    is_train: bool = True,
    drop_last=None,
):
    """Loader factory with Dassl's signature shape
    (``trainers/client_datamanager.py:65-103``)."""
    if tfm is None:
        tfm = build_transform(cfg, is_train=is_train)
    return DataLoader(
        data_source=data_source,
        batch_size=batch_size,
        transform=tfm,
        is_train=is_train,
        sampler_type=sampler_type,
        n_domain=n_domain,
        n_ins=n_ins,
        drop_last=drop_last,
        seed=max(cfg.SEED, 0),
        prefetch_depth=getattr(cfg.TPU, "PREFETCH_DEPTH", 2),
        # reference semantics: NUM_WORKERS=0 means NO worker parallelism
        # (torch's in-process loading) -> one decode thread, N>0 -> N
        # threads.  Never "all cores" implicitly.
        decode_threads=max(1, int(getattr(cfg.DATALOADER, "NUM_WORKERS", 0))),
        cache_decoded=getattr(cfg.DATALOADER, "CANVAS_CACHE", True),
        cache_budget_bytes=int(
            getattr(cfg.DATALOADER, "CANVAS_CACHE_BUDGET_GB", 4.0) * (1 << 30)
        ),
    )


class DataManager:
    def __init__(self, cfg, dataset=None):
        self.cfg = cfg
        self.dataset = dataset if dataset is not None else build_dataset(cfg)

        tfm_train = build_transform(cfg, is_train=True)
        tfm_test = build_transform(cfg, is_train=False)

        self.train_loader_x = build_data_loader(
            cfg,
            sampler_type=cfg.DATALOADER.TRAIN_X.SAMPLER,
            data_source=self.dataset.train_x,
            batch_size=cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
            n_domain=cfg.DATALOADER.TRAIN_X.N_DOMAIN,
            n_ins=cfg.DATALOADER.TRAIN_X.N_INS,
            tfm=tfm_train,
            is_train=True,
        )
        self.val_loader = None
        if self.dataset.val:
            self.val_loader = build_data_loader(
                cfg,
                sampler_type=cfg.DATALOADER.TEST.SAMPLER,
                data_source=self.dataset.val,
                batch_size=cfg.DATALOADER.TEST.BATCH_SIZE,
                tfm=tfm_test,
                is_train=False,
            )
        self.test_loader = build_data_loader(
            cfg,
            sampler_type=cfg.DATALOADER.TEST.SAMPLER,
            data_source=self.dataset.test,
            batch_size=cfg.DATALOADER.TEST.BATCH_SIZE,
            tfm=tfm_test,
            is_train=False,
        )

        self.num_classes = self.dataset.num_classes
        self.lab2cname = self.dataset.lab2cname

        if cfg.VERBOSE:
            self.show_dataset_summary(cfg)

    @property
    def train_loader(self):
        return self.train_loader_x

    def show_dataset_summary(self, cfg):
        print("***** Dataset statistics *****")
        print(f"  Dataset: {cfg.DATASET.NAME}")
        print(f"  # classes: {self.num_classes:,}")
        print(f"  # train_x: {len(self.dataset.train_x):,}")
        if self.dataset.val:
            print(f"  # val: {len(self.dataset.val):,}")
        print(f"  # test: {len(self.dataset.test):,}")


class ClientDataManager:
    """Per-client manager over already-partitioned Datum lists."""

    def __init__(self, train_x: List[Datum], val: List[Datum], test: List[Datum], cfg):
        self.cfg = cfg
        self._validate_labels(train_x, "train_x")
        self._validate_labels(val, "val")
        self._validate_labels(test, "test")

        tfm_train = build_transform(cfg, is_train=True)
        tfm_test = build_transform(cfg, is_train=False)

        self.train_loader = build_data_loader(
            cfg,
            sampler_type=cfg.DATALOADER.TRAIN_X.SAMPLER,
            data_source=train_x,
            batch_size=cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
            n_domain=cfg.DATALOADER.TRAIN_X.N_DOMAIN,
            n_ins=cfg.DATALOADER.TRAIN_X.N_INS,
            tfm=tfm_train,
            is_train=True,
        )
        self.val_loader = (
            build_data_loader(
                cfg,
                sampler_type=cfg.DATALOADER.TEST.SAMPLER,
                data_source=val,
                batch_size=cfg.DATALOADER.TEST.BATCH_SIZE,
                tfm=tfm_test,
                is_train=False,
            )
            if val
            else None
        )
        self.test_loader = build_data_loader(
            cfg,
            sampler_type=cfg.DATALOADER.TEST.SAMPLER,
            data_source=test,
            batch_size=cfg.DATALOADER.TEST.BATCH_SIZE,
            tfm=tfm_test,
            is_train=False,
        )

        # a `.dataset` namespace like the reference's
        # (trainers/client_datamanager.py:120-143)
        self.dataset = SimpleNamespace(train_x=train_x, val=val, test=test)
        self._lab2cname = None

    @staticmethod
    def _validate_labels(data, name):
        """The label gate (``trainers/client_datamanager.py:105-118``)."""
        for item in data:
            if not isinstance(item.label, int) or item.label < 0:
                raise ValueError(
                    f"Invalid label {item.label!r} in {name} "
                    f"(impath={item.impath})"
                )

    @property
    def train_loader_x(self):
        return self.train_loader

    @property
    def lab2cname(self):
        if self._lab2cname is None:
            mapping = {}
            for split in (self.dataset.train_x, self.dataset.val, self.dataset.test):
                if split:
                    for item in split:
                        mapping.setdefault(item.label, item.classname)
            self._lab2cname = dict(sorted(mapping.items()))
        return self._lab2cname

    @property
    def num_classes(self):
        return max(self.lab2cname) + 1 if self.lab2cname else 0
