"""The port's trainers; importing the package registers them
(``MaPLe``, ``MaPLeFederated``, ``CoOp``, ``CoCoOp``, ``VPT``, ``IVLP``,
``ZeroshotCLIP``, ``ZeroshotCLIP2``)."""

from federated_multi_modal_tpu_torch.trainers import (  # noqa: F401
    cocoop,
    coop,
    ivlp,
    maple,
    maple_fed,
    vpt,
    zsclip,
)
