"""The port's dataset catalog: the captioned remote-sensing datasets the
federated trainer reads (PatternNet, Ucmerced, EuroSAT) and the Synthetic
dataset. The other 14 modules of the JAX package's catalog wait for the
trainers whose base-to-novel runs read them (ROADMAP module item 5)."""

from federated_multi_modal_tpu_torch.data.datasets import (  # noqa: F401
    eurosat,
    patternnet,
    synthetic,
    ucmerced,
)
