"""The port's trainers; importing the package registers them
(``MaPLe``, ``CoOp``, ``ZeroshotCLIP``, ``ZeroshotCLIP2``)."""

from federated_multi_modal_tpu_torch.trainers import coop, maple, zsclip  # noqa: F401
