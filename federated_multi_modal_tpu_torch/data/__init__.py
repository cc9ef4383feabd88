"""Datasets, transforms and loaders of the port (counterpart of
``federated_multi_modal_tpu/data``: the Synthetic, PatternNet, Ucmerced
and EuroSAT datasets, ``DataManager``, the federated ``ClientDataManager``
and ``partition_dataset_iid``, and the host loader)."""

from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.data.dataset_base import (
    DatasetBase,
    fewshot_with_cache,
    generate_fewshot,
    read_and_split_data,
    read_split,
    save_split,
    split_trainval,
    subsample_classes,
)
from federated_multi_modal_tpu_torch.data.loader import DataLoader
from federated_multi_modal_tpu_torch.data.manager import (
    ClientDataManager,
    DataManager,
    build_data_loader,
)
from federated_multi_modal_tpu_torch.data.partition import partition_dataset_iid
from federated_multi_modal_tpu_torch.data.transforms import build_transform

__all__ = [
    "Datum",
    "DatasetBase",
    "fewshot_with_cache",
    "generate_fewshot",
    "read_and_split_data",
    "read_split",
    "save_split",
    "split_trainval",
    "subsample_classes",
    "DataLoader",
    "ClientDataManager",
    "DataManager",
    "build_data_loader",
    "build_transform",
    "partition_dataset_iid",
]

# register the dataset catalog
import federated_multi_modal_tpu_torch.data.datasets  # noqa: E402,F401
