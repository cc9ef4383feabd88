"""Deterministic seeding across python, numpy and torch (port of
``federated_multi_modal_tpu/utils/seed.py``, which seeds python and numpy;
the JAX package's PRNG keys are explicit)."""

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
