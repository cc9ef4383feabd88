"""The client mesh for federated and data parallelism (port of
``federated_multi_modal_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a 2-D ``jax.sharding.Mesh`` with
axes ``("client", "data")``: clients across device groups, data parallelism
within a group. :class:`ClientMesh` is its counterpart in one process: a
numpy array of ``torch.device``s with the same axis names and shape. It is
not ``torch.distributed.DeviceMesh``, which needs a process group that the
single-process round loop does not have; ``parallel/fedavg.py`` runs each
client group on its row of the array.
"""

from __future__ import annotations

import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from federated_multi_modal_tpu_torch.engine.tree import tree_map_multi, tree_map_with_path


class ClientMesh:
    """Devices laid out along named axes: ``devices`` (a numpy object
    array), ``axis_names`` and ``shape`` (``{axis name: size}``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"ClientMesh({self.shape}, {self.devices.ravel().tolist()})"


def visible_devices(device=None) -> list:
    """The devices a run on ``device``'s kind can spread over: every visible
    CUDA card, or one CPU (``None`` means ``"cuda"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_client_mesh(num_clients: int, devices: Optional[Sequence] = None,
                     axis_names=("client", "data")) -> ClientMesh:
    """Mesh of shape ``(num_clients, n_devices // num_clients)``; on a device
    count that ``num_clients`` does not divide, one client group holds every
    device (the program stays correct, the clients share devices)."""
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    n = len(devices)
    if n % num_clients != 0:
        num_clients = 1
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return ClientMesh(arr.reshape(num_clients, n // num_clients), axis_names)


def make_mesh_from_cfg(cfg, num_clients: int, devices: Optional[Sequence] = None) -> ClientMesh:
    """The federated round loop's mesh: ``TPU.MESH_SHAPE`` with
    ``TPU.MESH_AXES`` where the shape is given (e.g. ``(2, 4)`` with
    ``("client", "data")`` pins clients to device groups), else the
    automatic ``(num_clients, rest)`` layout of :func:`make_client_mesh`."""
    shape = tuple(getattr(cfg.TPU, "MESH_SHAPE", ()) or ())
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    if not shape:
        return make_client_mesh(num_clients, devices)
    axes = tuple(getattr(cfg.TPU, "MESH_AXES", ("client", "data")))
    if len(shape) != len(axes):
        raise ValueError(f"TPU.MESH_SHAPE {shape} and TPU.MESH_AXES {axes} differ in rank")
    if "client" not in axes or "data" not in axes:
        raise ValueError(f'TPU.MESH_AXES {axes} must contain "client" and "data"')
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"TPU.MESH_SHAPE {shape} needs {int(np.prod(shape))} devices, "
            f"have {len(devices)}")
    if shape[axes.index("client")] != num_clients:
        raise ValueError(
            f"TPU.MESH_SHAPE client axis {shape[axes.index('client')]} != "
            f"FED.NUM_CLIENTS {num_clients}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return ClientMesh(arr.reshape(shape), axes)


# (source tensor id, device) -> (weak reference to the source, its version,
# the copy on the device)
_REPLICAS: dict = {}


def replicate(tree, device):
    """``tree`` with every leaf on ``device``: leaves already there are
    returned as they are, and a copy is made once per source tensor and
    device (kept while the source lives and is not written to), so that
    clients sharing one frozen tower share its replicas too."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def put(_, t):
        if t.device == device:
            return t
        key = (id(t), device)
        hit = _REPLICAS.get(key)
        if hit is not None and hit[0]() is t and hit[1] == t._version:
            return hit[2]
        for k in [k for k, v in _REPLICAS.items() if v[0]() is None]:
            del _REPLICAS[k]
        copy = t.detach().to(device)
        _REPLICAS[key] = (weakref.ref(t), t._version, copy)
        return copy

    return tree_map_with_path(put, tree)


def mean_over_devices(values, device):
    """The mean of same-structure trees (or tensors) held on several devices,
    on ``device``: summed in order, then divided by their count."""
    values = list(values)

    def mean(*xs):
        total = xs[0].to(device)
        for x in xs[1:]:
            total = total + x.to(device)
        return total / len(xs)

    return tree_map_multi(mean, values[0], *values[1:])
