"""Profiling (port of ``federated_multi_modal_tpu/utils/profiling.py``).

``cfg.TRAIN.PROFILE_DIR`` turns it on: the trainer runs each epoch under
:func:`trace`, which records the host and, where CUDA is available, the
card's kernels with ``torch.profiler`` and writes a Chrome trace
(``<host>_<pid>.<time>.pt.trace.json``, which TensorBoard's profiler plugin
and ``chrome://tracing`` read) into the directory. The JAX module's
``StepTimer`` and ``annotate`` have no caller in the port and are not
ported.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def trace(profile_dir: str = ""):
    """A ``torch.profiler`` trace of the body into ``profile_dir``; a
    no-op when it is empty."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield
