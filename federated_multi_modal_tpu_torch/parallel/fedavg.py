"""Parallel federated training over a ``("client", "data")`` mesh (port of
``federated_multi_modal_tpu/parallel/fedavg.py``).

Client trees (nested dicts and lists of tensors, ``None`` where a leaf is
absent) are stacked along a new leading client axis; FedAvg is the mean over
that axis in fp32 after the reference's non-finite scrub
(``safe_average_weights``, ``trainers/maple_fed.py:309-315``), cast back to
each leaf's dtype and broadcast back to ``(C, ...)``.

:func:`build_parallel_fed_step` is the JAX package's one program for every
client's local SGD step, in one process: each client runs on its client
group's row of the mesh (``parallel/mesh.py``), the frozen tower replicated
once per device, the per-client parameters and optimizer state moved to the
group and back. Every replica, its copies between cards included, is issued
on streams of its own before the device of the stacked state waits for any
(``mesh.ReplicaPhase``), so the groups run at once. ``"shard_map"`` splits
a client's batch over its group's ``data`` devices and averages their
gradients and losses on the group's first device (the JAX package's ``pmean``);
``"vmap"`` runs the whole client batch on the group's first device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from federated_multi_modal_tpu_torch.engine.tree import (
    leaves,
    tree_map_multi,
    tree_map_with_path,
)
from federated_multi_modal_tpu_torch.parallel.mesh import (
    mean_over_devices,
    replicate,
    run_replicas,
)
from federated_multi_modal_tpu_torch.utils.profiling import span


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
    averaged tree is broadcast back to ``(C, ...)``. Span ``fedavg``."""

    def avg(_, x):
        x32 = torch.nan_to_num(x.float(), nan=0.0, posinf=1e4, neginf=-1e4)
        mean = (x32.sum(0, keepdim=True) * (1.0 / x.shape[0])).to(x.dtype)
        return mean.expand_as(x)

    with span("fedavg"):
        return tree_map_with_path(avg, stacked_trainable)


def _client_groups(mesh) -> np.ndarray:
    """The mesh's devices as ``(client groups, devices a group)``."""
    devices = mesh.devices
    if "client" in mesh.axis_names and "data" in mesh.axis_names:
        order = [mesh.axis_names.index("client"), mesh.axis_names.index("data")]
        order += [i for i in range(devices.ndim) if i not in order]
        devices = np.transpose(devices, order)
        return devices.reshape(devices.shape[0], -1)
    return devices.reshape(1, -1)


def build_parallel_fed_step(loss_fn: Callable, tx, mesh, fedavg_every_step: bool = False,
                            impl: str = "auto"):
    """One step for every client: each takes a local SGD step on its own
    batch; with ``fedavg_every_step`` the clients are averaged after it (for
    rounds of several steps, call the step repeatedly and
    :func:`fedavg_over_clients` at the round's end instead).

    ``impl``: ``"vmap"`` runs each client's whole batch on its group's first
    device; ``"shard_map"`` splits it over the group's ``data`` devices and
    averages the shards' gradients and losses; ``"auto"`` takes
    ``"shard_map"`` on a mesh of more than one device where the shapes
    divide it, else ``"vmap"``, as the JAX package does. A single client
    on one device is one plain local step.

    A client whose gradients are not all finite keeps its parameters and
    its optimizer state (the single-site skip of the reference,
    ``trainers/maple.py:617-627``).

    Returns ``step(stacked_trainable, frozen, stacked_opt_state, batch,
    run=run_replicas) -> (stacked_trainable, stacked_opt_state, losses
    (C,))``; the stacked trees and the losses are on the device of the
    stacked trainable leaves, and every batch leaf is ``(C, B, ...)``, or
    ``batch`` is a list of the ``C`` clients' batches (leaves ``(B, ...)``),
    each on any device: a leaf already on its replica's card is not copied.
    ``run`` runs the replicas (``mesh.run_replicas``, or a capture's
    ``mesh.StepGraph.replicas``)."""
    from federated_multi_modal_tpu_torch.engine.trainer import loss_grads_and_aux

    if impl not in ("auto", "vmap", "shard_map"):
        raise ValueError(f"unknown fed-step impl {impl!r}")
    groups = _client_groups(mesh)
    nc = int(mesh.shape.get("client", 1))
    nd = int(mesh.shape.get("data", 1))
    n_mesh_dev = int(mesh.devices.size)

    def apply(trainable, opt_state, grads):
        finite = torch.stack([torch.isfinite(g).all() for g in leaves(grads)]).all()
        updates, new_state = tx.update(grads, opt_state, trainable)
        trainable = tree_map_multi(lambda p, u: torch.where(finite, p + u, p),
                                   trainable, updates)
        opt_state = tree_map_multi(lambda new, old: torch.where(finite, new, old),
                                   new_state, opt_state)
        return trainable, opt_state

    def shard_map_fits(C, batch) -> bool:
        if "client" not in mesh.axis_names or "data" not in mesh.axis_names:
            return False
        if C % nc:
            return False
        if isinstance(batch, (list, tuple)):
            return len(batch) == C and all(x.ndim >= 1 and x.shape[0] % nd == 0
                                           for b in batch for x in leaves(b))
        return all(x.ndim >= 2 and x.shape[0] == C and x.shape[1] % nd == 0
                   for x in leaves(batch))

    def client(tree, c):
        return tree_map_with_path(lambda _, x: x[c], tree)

    def client_batch(batch, c):
        return batch[c] if isinstance(batch, (list, tuple)) else client(batch, c)

    def step(stacked_trainable, frozen, stacked_opt_state, batch, run=run_replicas):
        C = leaves(stacked_trainable)[0].shape[0]
        home = leaves(stacked_trainable)[0].device
        split_data = impl == "shard_map" or (
            impl == "auto" and n_mesh_dev > 1 and shard_map_fits(C, batch))
        if split_data and not shard_map_fits(C, batch):
            raise ValueError(
                'the shard_map fed step needs a mesh with "client" and "data" axes, '
                f"{C} clients divisible by its {nc} client groups and every batch leaf "
                f"(C, B, ...) with B divisible by its {nd} data devices")
        per_group = C // nc if C % nc == 0 else C
        # one replica per (client, data device): client c's batch split over
        # its group's devices (shard_map) or whole on the group's first
        devices, inputs, owner = [], [], []
        for c in range(C):
            row = groups[c // per_group]
            row = list(row) if split_data else [row[0]]
            n = len(row)
            tr_c, b_c = client(stacked_trainable, c), client_batch(batch, c)
            for j, d in enumerate(row):
                shard = b_c if n == 1 else tree_map_with_path(
                    lambda _, x, j=j: x.chunk(n)[j], b_c)
                devices.append(d)
                inputs.append((tr_c, shard))
                owner.append(c)

        def work(d, x):
            return loss_grads_and_aux(loss_fn, x[0], replicate(frozen, d), x[1])[:2]

        replicas = run(work, devices, inputs, home)
        outs = []
        for c in range(C):
            mine = [r for r, k in zip(replicas, owner) if k == c]
            loss, grads = mine[0] if len(mine) == 1 else (
                mean_over_devices([r[0] for r in mine], home),
                mean_over_devices([r[1] for r in mine], home))
            trainable, opt_state = apply(client(stacked_trainable, c),
                                         client(stacked_opt_state, c), grads)
            outs.append((trainable, opt_state, loss))
        trainable = stack_client_trees([o[0] for o in outs])
        opt_state = stack_client_trees([o[1] for o in outs])
        losses = torch.stack([o[2] for o in outs])
        if fedavg_every_step:
            trainable = fedavg_over_clients(trainable)
        return trainable, opt_state, losses

    return step
