from federated_multi_modal_tpu_torch.utils.io import (
    listdir_nohidden,
    mkdir_if_missing,
    read_json,
    write_json,
)
from federated_multi_modal_tpu_torch.utils.logging import setup_logger
from federated_multi_modal_tpu_torch.utils.seed import set_random_seed
from federated_multi_modal_tpu_torch.utils.env import collect_env_info

__all__ = [
    "listdir_nohidden",
    "mkdir_if_missing",
    "read_json",
    "write_json",
    "setup_logger",
    "set_random_seed",
    "collect_env_info",
]
