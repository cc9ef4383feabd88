"""The port's trainers; importing the package registers them
(``MaPLe``, ``MaPLeFederated``, ``CoOp``, ``ZeroshotCLIP``, ``ZeroshotCLIP2``)."""

from federated_multi_modal_tpu_torch.trainers import coop, maple, maple_fed, zsclip  # noqa: F401
