"""The distributed layer (counterpart of ``federated_multi_modal_tpu/parallel``):
the client mesh, the parallel federated step and FedAvg over stacked client
trees, and the multi-process helpers on ``torch.distributed``."""

from federated_multi_modal_tpu_torch.parallel.mesh import make_client_mesh
from federated_multi_modal_tpu_torch.parallel.multihost import (
    initialize_multihost,
    is_main_process,
    process_count,
    sync_hosts,
)
from federated_multi_modal_tpu_torch.parallel.fedavg import (
    build_parallel_fed_step,
    fedavg_over_clients,
    stack_client_trees,
    unstack_client_trees,
)

__all__ = [
    "make_client_mesh",
    "initialize_multihost",
    "is_main_process",
    "process_count",
    "sync_hosts",
    "build_parallel_fed_step",
    "fedavg_over_clients",
    "stack_client_trees",
    "unstack_client_trees",
]
