"""The gemm work's share of its roofline in the train window (%): the least
time the card needs for the window's gemm work (benchmark/counts/flops.py,
each operation bound by its FLOPs or its bytes) over the device time of the
operations whose names match metrics/patterns/gemm/."""

from benchmark.counts.flops import bound_seconds


def read(t):
    if t.kind != "train":
        return None
    seconds = t.kernel_seconds("gemm")
    if not seconds:
        return None
    return 100.0 * bound_seconds(t.work["gemm"]) * t.steps / seconds
