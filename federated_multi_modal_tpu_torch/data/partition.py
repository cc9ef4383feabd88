"""Client data partitioning (port of
``federated_multi_modal_tpu/data/partition.py``): an IID shuffle of
``train_x`` with ``random.Random(seed)``, cut into equal chunks (the last
client takes the remainder); val and test are shared by every client."""

from __future__ import annotations

import random
from typing import List


def partition_dataset_iid(dataset, num_clients: int, seed: int = 0) -> List[dict]:
    train = list(dataset.train_x)
    rng = random.Random(seed)
    rng.shuffle(train)

    size = len(train) // num_clients
    partitions = []
    for i in range(num_clients):
        start = i * size
        end = (i + 1) * size if i < num_clients - 1 else len(train)
        partitions.append(
            {
                "train_x": train[start:end],
                "val": dataset.val,
                "test": dataset.test,
            }
        )
    return partitions
