"""FedAvg over stacked client trees (port of the tree half of
``federated_multi_modal_tpu/parallel/fedavg.py``).

Client trees (nested dicts and lists of tensors, ``None`` where a leaf is
absent) are stacked along a new leading client axis; FedAvg is the mean over
that axis in fp32 after the reference's non-finite scrub
(``safe_average_weights``, ``trainers/maple_fed.py:309-315``), cast back to
each leaf's dtype and broadcast back to ``(C, ...)``. The sequential round
loop of ``trainers/maple_fed.py`` averages through these three functions.
"""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.engine.tree import tree_map_multi, tree_map_with_path


def stack_client_trees(trees):
    """Stack N same-structure client trees along a new leading axis."""
    trees = list(trees)
    return tree_map_multi(lambda *leaves: torch.stack(leaves), trees[0], *trees[1:])


def unstack_client_trees(stacked, n: int):
    """Inverse of :func:`stack_client_trees`: ``n`` trees of views into
    ``stacked``."""
    return [tree_map_with_path(lambda _, x, i=i: x[i], stacked) for i in range(n)]


def fedavg_over_clients(stacked_trainable):
    """FedAvg over the leading client axis: in fp32, NaN -> 0 and +-inf ->
    +-1e4, the sum over clients in client order times the
    fp32 reciprocal of their count (XLA's form of ``jnp.mean``'s division,
    so the bits equal the JAX package's), cast back to the leaf's dtype; the
    averaged tree is broadcast back to ``(C, ...)``."""

    def avg(_, x):
        x32 = torch.nan_to_num(x.float(), nan=0.0, posinf=1e4, neginf=-1e4)
        mean = (x32.sum(0, keepdim=True) * (1.0 / x.shape[0])).to(x.dtype)
        return mean.expand_as(x)

    return tree_map_with_path(avg, stacked_trainable)
