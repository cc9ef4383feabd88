"""The port's dataset catalog: the Synthetic dataset. The real datasets of
the JAX package's catalog wait for the federated slice (ROADMAP module
item 4)."""

from federated_multi_modal_tpu_torch.data.datasets import synthetic  # noqa: F401
