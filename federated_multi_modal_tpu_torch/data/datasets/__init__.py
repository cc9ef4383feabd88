"""The port's dataset catalog, the JAX package's: the 11 base-to-novel
recognition datasets, the 4 ImageNet domain-shift variants, the captioned
remote-sensing datasets the federated trainer reads (PatternNet, Ucmerced,
EuroSAT) and the Synthetic dataset."""

from federated_multi_modal_tpu_torch.data.datasets import (  # noqa: F401
    caltech101,
    dtd,
    eurosat,
    fgvc_aircraft,
    food101,
    imagenet,
    imagenet_a,
    imagenet_r,
    imagenet_sketch,
    imagenetv2,
    oxford_flowers,
    oxford_pets,
    patternnet,
    stanford_cars,
    sun397,
    synthetic,
    ucf101,
    ucmerced,
)
