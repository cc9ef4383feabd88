"""Device time of the update (global norm, clip, SGD, the finite gate), per train
step (ms): the self time of the program's span ``update`` (benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("update",)


def read(t):
    return per_step_ms(t, "train", SPANS)
