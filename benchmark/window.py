"""The measured window: a closed loop of steps for a fixed time.

Each step is one call of ``replay`` (a CUDA graph replay, which the host
only enqueues). The host keeps at most two steps in flight, so that the
device never waits for it and the window ends at most two steps after its
time is up; the window closes with a synchronise. With ``trace`` the window
runs under ``torch.profiler`` (host and device activity), inside a range
named ``benchmark.window``.
"""

from __future__ import annotations

import collections
import time

import torch

WINDOW_RANGE = "benchmark.window"


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(replay, seconds: float, device, trace: bool = False, after_step=None):
    """``(steps, window seconds, profiler or None)``. ``after_step(i)`` runs
    after step ``i`` is enqueued (the eval's copies of sampled answers)."""
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    sync(device)
    in_flight = collections.deque()
    steps = 0
    with torch.profiler.record_function(WINDOW_RANGE):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            replay()
            if after_step is not None:
                after_step(steps)
            steps += 1
            if device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                in_flight.append(ev)
                if len(in_flight) > 2:
                    in_flight.popleft().synchronize()
        sync(device)
        window = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    return steps, window, prof
