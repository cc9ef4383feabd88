"""The whole train step's share of the cell's cards' dense bf16 peak (%): the
frozen analytic FLOP count (benchmark/counts/flops.py) of the window's steps
over the window's length and the peak of the cell's chips."""

from benchmark.counts.flops import PEAK_BF16_FLOPS


def read(t):
    if not t.kernels or t.kind != "train" or t.window_s <= 0:
        return None
    return 100.0 * t.flops_per_step * t.steps / t.window_s / (t.chips * PEAK_BF16_FLOPS)
