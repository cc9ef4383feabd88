"""The attention work's share of its roofline in the eval window (%): the least
time the card needs for the window's attention work (benchmark/counts/flops.py,
each operation bound by its FLOPs or its bytes) over the device time of the
operations whose names match metrics/patterns/attention/."""

from benchmark.counts.flops import bound_seconds


def read(t):
    if t.kind != "eval":
        return None
    seconds = t.kernel_seconds("attention")
    if not seconds:
        return None
    return 100.0 * bound_seconds(t.work["attention"]) * t.steps / seconds
