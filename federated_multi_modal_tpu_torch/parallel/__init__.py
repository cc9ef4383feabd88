"""Federated averaging over client trees (counterpart of
``federated_multi_modal_tpu/parallel``). The client mesh, the parallel
federated step and the multi-host helpers wait for ROADMAP module item 7."""

from federated_multi_modal_tpu_torch.parallel.fedavg import (
    fedavg_over_clients,
    stack_client_trees,
    unstack_client_trees,
)

__all__ = [
    "fedavg_over_clients",
    "stack_client_trees",
    "unstack_client_trees",
]
