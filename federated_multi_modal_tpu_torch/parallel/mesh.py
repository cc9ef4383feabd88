"""The client mesh for federated and data parallelism (port of
``federated_multi_modal_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a 2-D ``jax.sharding.Mesh`` with
axes ``("client", "data")``: clients across device groups, data parallelism
within a group. :class:`ClientMesh` is its counterpart in one process: a
numpy array of ``torch.device``s with the same axis names and shape. It is
not ``torch.distributed.DeviceMesh``, which needs a process group that the
single-process round loop does not have; ``parallel/fedavg.py`` runs each
client group on its row of the array.

Work spread over several devices in one process (the data-parallel shares
of a batch, the clients of a federated step) goes through
:func:`run_replicas`: each replica runs on a CUDA stream of its own, so
that replicas on separate cards, or on one card named more than once in the
device list, run at once, and the home device waits for each replica's
stream with an event before it reads the replica's outputs.
:class:`StepGraph` captures such a step as CUDA graphs (the bench's
``--dispatch scan``): the home device's work in stretches, one graph per
replica, and the copies between separate cards outside the graphs, between
replays.
"""

from __future__ import annotations

import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from federated_multi_modal_tpu_torch.engine.tree import (
    to_device,
    tree_map_multi,
    tree_map_with_path,
)
from federated_multi_modal_tpu_torch.parallel import multihost
from federated_multi_modal_tpu_torch.utils.profiling import span


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


def local_devices(device, process_id: int = None, num_processes: int = None) -> list:
    """The devices one process drives, the first of them the one
    ``multihost.initialize_multihost`` makes current. ``process_id`` and
    ``num_processes`` default to the running process group's.

    One process: every visible device of ``device``'s kind. Several, as the
    launcher says: under ``torchrun``'s ``LOCAL_WORLD_SIZE`` the process's
    even share of them, the ``LOCAL_RANK``-th (else the process id modulo
    ``LOCAL_WORLD_SIZE``; all of them at ``LOCAL_WORLD_SIZE=1``, the device
    ``LOCAL_RANK`` modulo their count where there are fewer devices than
    processes); without it, one process a device, the ``LOCAL_RANK``-th
    (else the process id modulo their count)."""
    devices = visible_devices(device)
    if num_processes is None or process_id is None:
        num_processes = multihost.process_count()
        process_id = torch.distributed.get_rank() if num_processes > 1 else 0
    if num_processes <= 1:
        return devices
    n_local = multihost.env_int("LOCAL_WORLD_SIZE")
    rank = multihost.env_int("LOCAL_RANK")
    if n_local is None:
        return [devices[(process_id if rank is None else rank) % len(devices)]]
    if rank is None:
        rank = process_id % n_local
    share = len(devices) // n_local
    if share == 0:
        return [devices[rank % len(devices)]]
    return devices[rank * share:(rank + 1) * share]


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
    on ``device``: summed in order, then divided by their count, always into
    new tensors. A value on another card is copied after the work its
    card's current stream holds (PyTorch's cross-device copy waits for it);
    the outputs of :func:`run_replicas` are on ``device`` already, ordered
    after their replicas' streams."""
    values = list(values)

    def mean(*xs):
        total = xs[0].to(device)
        for x in xs[1:]:
            total = total + x.to(device)
        return total / len(xs)

    return tree_map_multi(mean, values[0], *values[1:])


# -- replicas on streams of their own, and their capture --------------------------

# (replica index, device) -> the replica's stream, kept so that a replica
# runs on the same stream in every call (its cuBLAS workspace, made in an
# eager step, serves the capture)
_STREAMS: dict = {}


def replica_stream(j, device) -> "torch.cuda.Stream":
    """The stream replica ``j`` runs on, on ``device``."""
    key = (j, torch.device(device))
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(torch.device(device))
    return _STREAMS[key]


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices name the same device (``cuda`` is the current
    card)."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index

    return a.type == b.type and index(a) == index(b)


def _join(stream, home) -> None:
    """``home``'s current stream waits for the work issued to ``stream`` so
    far (an event recorded there)."""
    torch.cuda.current_stream(home).wait_stream(stream)


def run_replicas(work, devices, inputs, home):
    """``[work(devices[j], inputs[j] on devices[j]) on home for each j]``.

    On the CPU the replicas run one after another. On CUDA replica ``j``
    runs on its own stream (:func:`replica_stream`), which first waits for
    ``home``'s and its device's current streams, so that it reads its
    inputs after they were written; its outputs are copied to ``home``
    there, and ``home``'s current stream waits for every replica's stream
    before the call returns, so that what runs next on ``home`` (the mean)
    reads finished outputs, and memory a replica read is not handed to new
    work on ``home`` while the replica may still read it. A device named
    twice (two replicas of one card) gets two streams. One replica on
    ``home`` runs in place, on the current stream. A step captured by
    :meth:`StepGraph.capture` calls :meth:`StepGraph.replicas` in its
    place."""
    devices = [torch.device(d) for d in devices]
    home = torch.device(home)
    if len(devices) == 1 and same_device(devices[0], home):
        # one replica on the home device: nothing to run beside it
        return [work(home, to_device(inputs[0], home))]
    if home.type != "cuda":
        return [to_device(work(d, to_device(x, d)), home) for d, x in zip(devices, inputs)]
    outs, streams = [], []
    for j, (d, x) in enumerate(zip(devices, inputs)):
        s = replica_stream(j, d)
        s.wait_stream(torch.cuda.current_stream(home))
        s.wait_stream(torch.cuda.current_stream(d))
        with torch.cuda.stream(s):
            outs.append(to_device(work(d, to_device(x, d)), home))
        streams.append(s)
    for s in streams:
        _join(s, home)
    return outs


def _moved(tree, device, copies: list):
    """``tree`` with every leaf not on ``device`` copied there now, each
    ``(source, copy)`` pair added to ``copies`` for the replays to repeat."""
    def move(_, t):
        if t.device == device:
            return t
        copy = t.to(device)
        copies.append((t, copy))
        return copy

    return tree_map_with_path(move, tree)


class StepGraph:
    """A step on ``home`` that may run replicas, captured as CUDA graphs
    (:meth:`capture`) and replayed (:meth:`replay`); the step calls
    :meth:`replicas` where it would call :func:`run_replicas`.

    The home device's work between two :func:`run_replicas` calls is one
    graph, captured on a side stream of ``home``; each replica of a call is
    a graph of its own, captured on the replica's stream with its device's
    memory pool (the graphs of one device share one pool and are replayed
    in the order they were captured). A leaf that has to cross to another
    card cannot be captured with the graphs of either card: it gets a
    buffer on the far card at capture, and the replay copies it there
    before the replica's graph and its outputs back after it, on the
    replica's stream, outside the graphs. On one card (a device named
    twice included) nothing crosses. A replay runs the home graphs on
    ``home``'s current stream and each replica's graph on its stream, after
    an event of the home stream, and the next home graph after an event of
    every replica's stream. ``generators`` are registered with the home
    graphs, so that each replay draws new numbers (a replica draws none). A step that cannot
    be captured raises whatever the capture raised."""

    def __init__(self, home, generators=()):
        home = torch.device(home)
        if home.index is None:
            home = torch.device("cuda", torch.cuda.current_device())
        self.home = home
        self.generators = tuple(generators)
        self.program = []  # ("home", graph) or ("replicas", [(device, stream, in, graph, out)])
        self._pools = {}
        self._open = None

    def _begin(self, device, stream, register: bool):
        graph = torch.cuda.CUDAGraph()
        if register:
            for gen in self.generators:
                graph.register_generator_state(gen)
        if device not in self._pools:
            with torch.cuda.device(device):
                self._pools[device] = torch.cuda.graph_pool_handle()
        stream.wait_stream(torch.cuda.current_stream(device))
        ctx = torch.cuda.stream(stream)
        ctx.__enter__()
        try:
            graph.capture_begin(pool=self._pools[device])
        except BaseException:
            ctx.__exit__(None, None, None)
            raise
        self._open = (graph, ctx)
        return graph

    def _end(self, failed: bool = False) -> None:
        graph, ctx = self._open
        self._open = None
        try:
            graph.capture_end()
        except BaseException:
            if not failed:
                raise
        finally:
            ctx.__exit__(None, None, None)

    def _begin_home(self) -> None:
        stream = replica_stream("capture", self.home)
        self.program.append(("home", self._begin(self.home, stream, True)))

    def capture(self, fn):
        """``fn()`` captured; returns its output (tensors the replays
        rewrite)."""
        if self.program:
            raise RuntimeError("this StepGraph holds a captured step already")
        self._begin_home()
        try:
            out = fn()
        except BaseException:
            if self._open is not None:
                self._end(failed=True)
            raise
        self._end()
        return out

    def replicas(self, work, devices, inputs, home):
        """:func:`run_replicas` inside :meth:`capture`: the replicas
        captured, a graph each."""
        devices = [torch.device(d) for d in devices]
        home = torch.device(home)
        if len(devices) == 1 and same_device(devices[0], home):
            return [work(home, to_device(inputs[0], home))]
        if self._open is None:
            raise RuntimeError("StepGraph.replicas called outside StepGraph.capture")
        if not same_device(home, self.home):
            raise ValueError(f"replicas homed on {home} in a step captured on {self.home}")
        self._end()
        entries, outs = [], []
        try:
            for j, (d, x) in enumerate(zip(devices, inputs)):
                copies_in, copies_out = [], []
                x = _moved(x, d, copies_in)
                stream = replica_stream(j, d)
                graph = self._begin(d, stream, False)
                try:
                    out = work(d, x)
                except BaseException:
                    self._end(failed=True)
                    raise
                self._end()
                outs.append(_moved(out, self.home, copies_out))
                entries.append((d, stream, copies_in, graph, copies_out))
        finally:
            self.program.append(("replicas", entries))
        self._begin_home()
        return outs

    def replay(self) -> None:
        """The captured step once (the host range ``replay``, no marker)."""
        with span("replay", marker=False):
            home_stream = torch.cuda.current_stream(self.home)
            for kind, item in self.program:
                if kind == "home":
                    item.replay()
                    continue
                for d, stream, copies_in, graph, copies_out in item:
                    stream.wait_stream(home_stream)
                    stream.wait_stream(torch.cuda.current_stream(d))
                    with torch.cuda.stream(stream):
                        for src, dst in copies_in:
                            dst.copy_(src)
                        graph.replay()
                        for src, dst in copies_out:
                            dst.copy_(src)
                for _, stream, *_ in item:
                    _join(stream, self.home)
