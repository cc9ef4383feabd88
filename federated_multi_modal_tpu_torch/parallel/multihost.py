"""Multi-process runtime on ``torch.distributed`` (port of
``federated_multi_modal_tpu/parallel/multihost.py``).

The JAX package wires ``jax.distributed`` from a coordinator address; the
port does the same with PyTorch's process group: one process per card, NCCL
for CUDA tensors and Gloo for CPU ones. Host-side effects (``log.txt``,
checkpoint writes) are guarded to process 0 through :func:`is_main_process`,
and :func:`sync_hosts` is the barrier before a process reads what process 0
wrote.

Where the settings come from, in order: the arguments; the JAX package's
variables ``JAX_COORDINATOR_ADDRESS`` (``host:port``, or an init method such
as ``file:///path``), ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``; then
``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``.
``LOCAL_RANK`` (else the process id modulo the visible cards) picks the card.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _env_int(name: str):
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(coordinator_address: str = None, num_processes: int = None,
                         process_id: int = None, backend: str = None) -> bool:
    """Initialise the default process group when a multi-process run is
    configured; returns whether more than one process is active after the
    call.

    Safe to call unconditionally: with nothing configured it is a no-op
    that returns ``False``. ``backend`` is ``torch.distributed``'s own
    (``None``: NCCL where CUDA is available, Gloo otherwise). A run that was
    configured but cannot start raises ``RuntimeError``: carrying on would
    make every process act as process 0 on the same output directory."""
    if _active():
        return dist.get_world_size() > 1

    address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID")
    if not address and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        if num_processes is None:
            num_processes = _env_int("WORLD_SIZE")
        if process_id is None:
            process_id = _env_int("RANK")
    if not address:
        return False
    if num_processes is None or process_id is None:
        raise RuntimeError(
            f"a multi-process run was configured (coordinator {address}) without its "
            "process count and process id: set JAX_NUM_PROCESSES and JAX_PROCESS_ID "
            "(or torchrun's WORLD_SIZE and RANK)")
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build of PyTorch")
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        local_rank = _env_int("LOCAL_RANK")
        if local_rank is None:
            local_rank = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
    try:
        dist.init_process_group(backend=backend, init_method=_init_method(address),
                                world_size=num_processes, rank=process_id)
    except Exception as e:
        raise RuntimeError(
            "torch.distributed.init_process_group failed and the distributed runtime "
            "is NOT active; a multi-process run was explicitly configured, so "
            "continuing would produce independent single-process runs all acting as "
            f"process 0 ({type(e).__name__}: {e})") from e
    return dist.get_world_size() > 1


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_main_process() -> bool:
    """True on the process that writes checkpoints and logs (process 0)."""
    return not _active() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def sync_hosts(tag: str = "barrier") -> None:
    """A barrier across processes (e.g. before reading a checkpoint process
    0 wrote); a no-op on one process. ``tag`` names it, as in the JAX
    package; ``torch.distributed`` barriers are not named."""
    del tag
    if process_count() <= 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
