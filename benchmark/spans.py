"""The program's layer spans, read from the device trace.

While its step is captured, the program launches a one-thread empty kernel
at each boundary of a span (``federated_multi_modal_tpu_torch/utils/
profiling.py``, ``csrc/span_mark.cu``): ``span_marker<id, true>`` opens span
``id``, ``span_marker<id, false>`` closes it. Every replay runs them, so they
lie in the traced window among the kernels they enclose, in the same record
and on the same clock. This reader pairs each opening marker with its close
on a stack, in start order. A span's self time is the device timeline from
the end of its opening marker to the start of its closing one, busy and idle
alike, less the same intervals of its child spans; so a step's spans add up
to its ``step`` span (the markers of a span's children count in the span's
own time). Only spans inside a complete ``step`` span count, and totals are
divided by the number of complete steps.

A trace without markers (a program without spans) or whose markers do not
nest reads ``None``, and nothing raises. It reads one stream: a step's
markers and kernels are taken to run one after another, as a step captured
on one card does.
"""

from __future__ import annotations

import bisect
import re

# utils/profiling.py's SPANS (tested equal): a span's index is its id, which
# never changes
NAMES = (
    "step", "crop", "forward_backward", "prompt_learner", "text_tower", "vision_tower", "loss",
    "backward", "update", "logits", "replay", "prompt_learner.backward", "text_tower.backward",
    "vision_tower.backward", "loss.backward",
)
STEP = NAMES.index("step")

# the demangled name ("void span_marker<3, true>()") or the mangled one
MARKER = re.compile(r"span_marker<(\d+), (true|false)>|span_markerILi(\d+)ELb([01])E")


def markers(kernels) -> list:
    """``(id, opens, start, end)`` of each marker among ``(name, start,
    seconds)`` device operations, in start order."""
    out = []
    for name, a, d in kernels:
        m = MARKER.search(name)
        if m:
            sid = int(m.group(1) or m.group(3))
            out.append((sid, m.group(2) == "true" or m.group(4) == "1", a, a + d))
    out.sort(key=lambda r: r[2])
    return out


class _Busy:
    """Busy device time inside any interval, from the union of the
    operations' intervals."""

    def __init__(self, kernels):
        union = []
        for _, a, d in sorted(kernels, key=lambda k: k[1]):
            if union and a <= union[-1][1]:
                union[-1][1] = max(union[-1][1], a + d)
            else:
                union.append([a, a + d])
        self.starts = [a for a, _ in union]
        self.ends = [b for _, b in union]
        self.before = [0.0]
        for a, b in union:
            self.before.append(self.before[-1] + b - a)

    def _upto(self, x: float) -> float:
        i = bisect.bisect_right(self.starts, x) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(x, self.ends[i]) - self.starts[i]

    def within(self, a: float, b: float) -> float:
        return self._upto(b) - self._upto(a)


def _read(t):
    marks = markers(t.kernels)
    if not marks:
        return None
    busy = _Busy(t.kernels)
    totals, steps = {}, 0
    stack = []  # [id, inner start, child intervals, finished spans below]
    for sid, opens, a, b in marks:
        if opens:
            stack.append([sid, b, [], []])
            continue
        if not stack:  # its opening marker lay before the window
            continue
        top = stack.pop()
        if top[0] != sid:
            return None
        done = top[3] + [(sid, top[1], a, top[2])]
        if stack:
            stack[-1][2].append((top[1], a))
            stack[-1][3].extend(done)
        elif sid == STEP:
            steps += 1
            for s, start, end, children in done:
                span = end - start - sum(d - c for c, d in children)
                on = busy.within(start, end) - sum(busy.within(c, d) for c, d in children)
                row = totals.setdefault(NAMES[s] if s < len(NAMES) else str(s),
                                        {"self_s": 0.0, "busy_s": 0.0, "idle_s": 0.0,
                                         "count": 0})
                row["self_s"] += span
                row["busy_s"] += on
                row["idle_s"] += span - on
                row["count"] += 1
    if not steps:
        return None
    return {"steps": steps, "spans": totals}


def read(t):
    """``{"steps": complete steps, "spans": {name: {"self_s", "busy_s",
    "idle_s", "count"}}}``, summed over the window's complete steps; or
    ``None`` (no markers, markers that do not nest, no complete step)."""
    cached = getattr(t, "_span_times", _read)
    if cached is not _read:
        return cached
    res = _read(t)
    try:
        t._span_times = res
    except AttributeError:
        pass
    return res


def per_step_ms(t, kind: str, names) -> float | None:
    """The self time of the spans ``names`` in ms per complete step of a
    ``kind`` (train or eval) window, or ``None`` where none of them ran."""
    if t.kind != kind:
        return None
    res = read(t)
    if res is None:
        return None
    rows = [res["spans"][n] for n in names if n in res["spans"]]
    if not rows:
        return None
    return 1e3 * sum(r["self_s"] for r in rows) / res["steps"]
