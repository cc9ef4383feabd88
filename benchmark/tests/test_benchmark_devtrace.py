"""The device trace (benchmark/devtrace.py) keeps devices: on synthetic
profiler events over two devices the idle share is the mean of each
device's own, ``mfu`` reads half of what one device's peak gives, and the
breakdown names each device; on the same events on one device every
reading is what a trace that merges all device operations gives."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.devtrace import Trace
from benchmark.tests.tiny import REPO
from benchmark.window import WINDOW_RANGE

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
GEMM = "void (anonymous namespace)::gemm_epilogue_kernel<0, 1, CUtensorMap_st>()"
ATTENTION = "void (anonymous namespace)::attention_core_f64_kernel<64, 26>()"
FLOPS, WORK = 3.1e12, {"attention": [{"flops": 2.0e11, "bytes": 1.0e9}],
                       "gemm": [{"flops": 9.0e11, "bytes": 3.0e9}]}


class Event:
    def __init__(self, name, kind, index, start, dur, activity=""):
        self._e = (name, kind, index, start, dur, activity)

    def name(self):
        return self._e[0]

    def device_type(self):
        return self._e[1]

    def device_index(self):
        return self._e[2]

    def start_ns(self):
        return self._e[3]

    def duration_ns(self):
        return self._e[4]

    def activity_type(self):
        return self._e[5]


def events(second_device: int) -> list:
    """A 1 s window: host ranges, a user annotation, device 0's operations
    (busy 0.4 s, one cut by the window's start) and the other device's
    (busy 0.2 s), which lie on ``second_device``."""
    t0 = 10_000_000_000
    out = [Event(WINDOW_RANGE, CPU, -1, t0, 1_000_000_000),
           Event("cudaGraphLaunch", CPU, -1, t0, 250_000_000),
           Event("replay", CPU, -1, t0 + 500_000_000, 400_000_000),
           Event("a user range", CUDA, 0, t0, 900_000_000, "gpu_user_annotation")]
    for dev, name, a, d in ((0, GEMM, -50_000_000, 200_000_000),
                            (0, ATTENTION, 300_000_000, 200_000_000),
                            (0, GEMM, 400_000_000, 150_000_000),
                            (second_device, GEMM, 600_000_000, 100_000_000),
                            (second_device, ATTENTION, 850_000_000, 100_000_000)):
        out.append(Event(name, CUDA, dev, t0 + a, d))
    return out


def trace(evts, chips: int) -> Trace:
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evts)))
    return Trace(prof, "train", 7, FLOPS, WORK, chips)


def read(name: str, t):
    return harness.read_metric(REPO, name, t)


def merged_readings(evts) -> dict:
    """What a trace that takes every device operation as one device's reads:
    the union of all their intervals as busy, each kernel's time summed,
    one card's peak."""
    w0 = next(e.start_ns() for e in evts if e.name() == WINDOW_RANGE)
    kernels = []
    for e in evts:
        if e.device_type() == CUDA and not e.activity_type():
            a, b = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w0 + 10 ** 9)
            kernels.append((e.name(), (a - w0) * 1e-9, (b - a) * 1e-9))
    union = []
    for _, a, d in sorted(kernels, key=lambda k: k[1]):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], a + d)
        else:
            union.append([a, a + d])
    busy = sum(b - a for a, b in union)
    return {"busy_s": busy, "window_s": 1e9 * 1e-9, "kernels": kernels}


def test_two_devices_read_each_devices_own_share():
    two = trace(events(1), chips=2)
    one = trace(events(0), chips=1)
    assert two.busy_s == pytest.approx((0.4 + 0.2) / 2)
    idle = [100.0 * (1 - busy / 1.0) for busy in (0.4, 0.2)]
    assert read("idle_share.train", two) == pytest.approx(sum(idle) / 2)
    assert read("mfu.train", two) == pytest.approx(read("mfu.train", one) / 2)
    assert read("mfu.train", one) == pytest.approx(100.0 * FLOPS * 7 / 1.0 / 989e12)
    # the work of every device against the kernel time of every device
    for name in ("attention_roofline.train", "gemm_roofline.train"):
        assert read(name, two) == read(name, one)
    bd = two.breakdown()
    assert [n for n, _ in bd["device_ops"]] == [f"cuda:0 {GEMM}", f"cuda:0 {ATTENTION}",
                                                f"cuda:1 {GEMM}", f"cuda:1 {ATTENTION}"]
    assert sum(s for _, s in bd["idle_gaps"]) == pytest.approx(0.6 + 0.8)
    assert all(n.startswith(("cuda:0 ", "cuda:1 ")) for n, _ in bd["idle_gaps"])


def test_one_device_reads_as_one_merged_trace_to_the_bit():
    evts = events(0)
    t = trace(evts, chips=1)
    want = merged_readings(evts)
    assert t.busy_s == want["busy_s"] and t.window_s == want["window_s"]
    assert t.kernels == want["kernels"]
    assert read("idle_share.train", t) == 100.0 * (1.0 - want["busy_s"] / want["window_s"])
    assert read("mfu.train", t) == 100.0 * FLOPS * 7 / want["window_s"] / 989e12
    bd = t.breakdown()
    assert [n for n, _ in bd["device_ops"]] == [GEMM, ATTENTION]
    assert dict(bd["device_ops"])[GEMM] == sum(d for n, _, d in want["kernels"] if n == GEMM)
    # idle: [0.15, 0.3) under the graph launch, [0.55, 0.6) and [0.7, 0.85)
    # under replay, [0.95, 1.0) outside any host range
    gaps = dict(bd["idle_gaps"])
    assert set(gaps) == {"replay", "(host outside any profiled call)", "cudaGraphLaunch"}
    assert gaps["replay"] == pytest.approx(0.05 + 0.15)
