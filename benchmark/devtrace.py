"""What the profiler saw in the window, as the per-layer metrics read it.

Device operations (kernels, copies, fills), each on its device, and host
ranges come from the profiler's raw event list; all share one clock. The
window is the host range ``benchmark.window``; device operations are cut to
it. ``busy_s`` is the mean over the cell's devices of the length of the
union of each device's operations' intervals.
"""

from __future__ import annotations

import collections
import re
from pathlib import Path

import torch

from benchmark.window import WINDOW_RANGE

PATTERNS = Path(__file__).resolve().parent / "metrics" / "patterns"


def _ns(e, what: str) -> int:
    if hasattr(e, what + "_ns"):
        return int(getattr(e, what + "_ns")())
    return int(getattr(e, what + "_us")() * 1000)


def _activity(e) -> str:
    return e.activity_type() if hasattr(e, "activity_type") else ""


def patterns(group: str) -> list:
    """The kernel-name patterns of ``group``: every line of every file in
    ``metrics/patterns/<group>/`` (``#`` starts a comment)."""
    out = []
    for f in sorted((PATTERNS / group).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(re.compile(line))
    return out


def _union(ops) -> list:
    """The union of ``(name, start, seconds)`` intervals, ``[start, end]``
    in order."""
    out = []
    for _, a, d in sorted(ops, key=lambda k: k[1]):
        b = a + d
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """``per_device``: ``{device index: [(name, start s, seconds)]}`` of the
    device operations in the window; ``kernels``: every device's, device by
    device; ``host``: ``(name, start s, end s)`` of each host range;
    ``window_s``, ``busy_s``; and what the cell hands its metrics:
    ``kind`` (the mix's), ``steps``, ``chips`` (the cell's devices),
    ``flops_per_step`` and ``work`` (``{"attention": ops, "gemm": ops}``),
    one step's over every device (``benchmark/counts``). On one device
    every reading is that device's."""

    def __init__(self, prof, kind: str, steps: int, flops_per_step: float, work: dict,
                 chips: int = 1):
        self.kind, self.steps, self.flops_per_step, self.work = kind, steps, flops_per_step, work
        self.chips = chips
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        raw_dev, host, window = [], [], None
        for e in events:
            start, dur = _ns(e, "start"), _ns(e, "duration")
            if e.device_type() == cuda:
                if "annotation" not in _activity(e) and e.name() != WINDOW_RANGE:
                    raw_dev.append((e.device_index(), e.name(), start, dur))
            elif e.name() == WINDOW_RANGE:
                window = (start, start + dur)
            else:
                host.append((e.name(), start, start + dur))
        if window is None:
            raise RuntimeError("the profiler's trace holds no window range")
        w0, w1 = window
        self.window_s = (w1 - w0) * 1e-9
        self.per_device = {}
        for dev, name, start, dur in raw_dev:
            a, b = max(start, w0), min(start + dur, w1)
            if b > a:
                self.per_device.setdefault(dev, []).append((name, (a - w0) * 1e-9,
                                                            (b - a) * 1e-9))
        self.kernels = [k for dev in sorted(self.per_device) for k in self.per_device[dev]]
        self.host = [(n, (a - w0) * 1e-9, (b - w0) * 1e-9) for n, a, b in host
                     if b > w0 and a < w1]
        self.busy_intervals = {dev: _union(ops) for dev, ops in self.per_device.items()}
        self.busy_s = sum(sum(b - a for a, b in self.busy_intervals[dev])
                          for dev in self.busy_intervals) / chips

    def kernel_seconds(self, group: str):
        """Device seconds of the operations whose names match ``group``'s
        patterns, or ``None`` where none does."""
        pats = patterns(group)
        hits = [d for n, _, d in self.kernels if any(p.search(n) for p in pats)]
        return sum(hits) if hits else None

    def gaps(self, device: int) -> list:
        """``(start, end)`` of each idle stretch of the window on ``device``."""
        out, t = [], 0.0
        for a, b in self.busy_intervals.get(device, []):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.window_s:
            out.append((t, self.window_s))
        return out

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten host
        activities under which a device sat idle longest (the innermost
        host range at the middle of each of the 1000 longest gaps; the
        shorter gaps summed under one name). On several devices each name
        starts with its device (``cuda:1 ...``)."""
        def on(dev):
            return f"cuda:{dev} " if self.chips > 1 else ""

        ops = collections.Counter()
        for dev in sorted(self.per_device):
            for n, _, d in self.per_device[dev]:
                ops[on(dev) + n[:160]] += d
        idle = collections.Counter()
        gaps = sorted(((dev, a, b) for dev in range(self.chips) for a, b in self.gaps(dev)),
                      key=lambda g: g[1] - g[2])
        for dev, a, b in gaps[:1000]:
            mid = (a + b) / 2
            under = [h for h in self.host if h[1] <= mid <= h[2]]
            name = (min(under, key=lambda h: h[2] - h[1])[0] if under
                    else "(host outside any profiled call)")
            idle[on(dev) + name[:160]] += b - a
        if len(gaps) > 1000:
            idle["(the shorter gaps, each under the 1000th longest)"] = sum(
                b - a for _, a, b in gaps[1000:])
        return {"device_ops": [[n, s] for n, s in ops.most_common(10)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}
